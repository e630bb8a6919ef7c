#!/usr/bin/env python3
"""What a ``StepTimeline`` costs a ResNet-50 ``fused`` training step on a card.

    python3 scripts/torch_timeline_cost.py [--pairs 10] [--steps 30] [--rows 128]

Full-width ResNet-50 ``fused`` (``scripts/torch_dp_train.py``'s model and
recipe: 224x224, bf16 over f32 params, SGD 0.1 with momentum 0.9) trains
through ``fit`` on batches that already live on the card (no feed thread,
no host copy), in runs of ``--steps`` steps, alternately with no timeline
and with a ``StepTimeline``. The order flips every pair (none, timeline,
timeline, none, ...), so a drift of the card's clock weighs on both modes
alike. A run's ms a step is its wall time between two synchronisations over
its steps; the loss is fetched once, at the run's last step, so the host
runs ahead of the card as in a run logged every ``--steps`` steps.

Prints one JSON line: each run's ms a step by mode, the medians, their
difference, each mode's spread (max - min over its runs), the per-pair
differences (timeline - none), the host microseconds of one
``record_step`` call (median of 20 batches of 1000 on a warm timeline) and
the card's name. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def timeline_cost(state, step, batches: list, rng, *, pairs: int, steps: int,
                  sync=lambda: None) -> dict:
    """``pairs`` pairs of ``steps``-step ``fit`` runs of ``step`` over
    ``batches`` (cycled), one run of each pair with a ``StepTimeline``; the
    order flips every pair. ``sync`` waits for the device."""
    from distributed_tensorflow_tpu_torch.obs.fleet import StepTimeline
    from distributed_tensorflow_tpu_torch.train import fit

    runs = {"none": [], "timeline": []}
    for i in range(pairs):
        for mode in ("none", "timeline") if i % 2 == 0 else ("timeline", "none"):
            timeline = StepTimeline() if mode == "timeline" else None
            sync()
            t0 = time.perf_counter()
            fit(state, step, itertools.cycle(batches), num_steps=state.step + steps, rng=rng,
                log_every=steps, timeline=timeline)
            sync()
            runs[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    median = {mode: statistics.median(ms) for mode, ms in runs.items()}
    return {"pairs": pairs, "steps": steps, "ms_a_step": runs, "median_ms": median,
            "timeline_minus_none_ms": median["timeline"] - median["none"],
            "spread_ms": {mode: max(ms) - min(ms) for mode, ms in runs.items()},
            "pair_diff_ms": [t - n for t, n in zip(runs["timeline"], runs["none"])]}


def record_step_us(batches: int = 20, calls: int = 1000) -> float:
    """Host microseconds of one ``StepTimeline.record_step`` call: the
    median over ``batches`` batches of ``calls`` calls, after a warm-up
    that fills the detector's window."""
    from distributed_tensorflow_tpu_torch.obs.fleet import StepTimeline

    timeline = StepTimeline()
    n = 0
    for _ in range(calls):
        n += 1
        timeline.record_step(n, 0.1, host_wait_s=1e-4, dispatch_s=0.05)
    per_batch = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            n += 1
            timeline.record_step(n, 0.1, host_wait_s=1e-4, dispatch_s=0.05)
        per_batch.append((time.perf_counter() - t0) * 1e6 / calls)
    return statistics.median(per_batch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--rows", type=int, default=128)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_timeline_cost: needs a CUDA card", file=sys.stderr)
        return 1
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.train import fit, make_rng, make_train_step
    from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss

    spec = importlib.util.spec_from_file_location(
        "torch_dp_train", ROOT / "scripts" / "torch_dp_train.py")
    dp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, state, tx = dp.build("cuda")
    step = make_train_step(make_classification_loss(model), tx)
    data = synthetic_image_classification(2 * args.rows, (dp.HW, dp.HW, 3), 1000, seed=dp.SEED)
    batches = list(itertools.islice(device_batches(data, args.rows, device="cuda", seed=1), 2))
    rng = make_rng(dp.SEED, "cuda")
    fit(state, step, itertools.cycle(batches), num_steps=3, rng=rng, log_every=3)  # warm-up
    out = timeline_cost(state, step, batches, rng, pairs=args.pairs, steps=args.steps,
                        sync=torch.cuda.synchronize)
    print(json.dumps({"rows": args.rows, "image": dp.HW, **out,
                      "record_step_us": record_step_us(),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
