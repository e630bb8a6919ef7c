#!/usr/bin/env python3
"""Where a BERT-base pretraining step spends its time on one CUDA card.

Builds the PyTorch port's training main path at full BERT-base width
(``BertConfig()`` defaults: L=512 positions, bf16 compute over f32 params,
dropout 0.1 from an explicit generator; seeded random weights), 24 rows of
``SyntheticMLM`` at L=512, the ``bert_base`` recipe at a constant lr
(AdamW 1e-4, weight decay 0.01, clip 1.0), and measures over ``--iters``
steps after ``--warmup``:

- ``wall_ms``: host clock per step ending in a synchronise (median);
- ``device_ms``: summed CUDA kernel time per step from ``torch.profiler``,
  and ``busy_share`` = device_ms / wall_ms;
- the device time of the three flash kernels (and the kernel functions
  the profiler names behind each), and the kernels that take the most
  device time.

Prints one JSON line; needs a card::

    python3 scripts/torch_train_profile.py [--iters 5] [--rows 24] [--seq 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx  # noqa: E402
from distributed_tensorflow_tpu_torch.data.text import (  # noqa: E402
    SyntheticMLM,
    SyntheticMLMConfig,
    mlm_device_batches,
)
from distributed_tensorflow_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForPreTraining,
    make_bert_pretraining_loss,
)
from distributed_tensorflow_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_rng,
    make_train_step,
)


def _kernel_times(prof) -> dict[str, float]:
    """Device microseconds per kernel name over the profiled window. User
    annotations (``Optimizer.step#AdamW.step``) also appear on the device
    timeline, spanning kernels counted on their own, and are left out."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--rows", type=int, default=24)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = BertConfig(dtype=torch.bfloat16)
    model = BertForPreTraining(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(args.seed))
    recipe = dataclasses.replace(PRESETS["bert_base"], lr_schedule="constant",
                                 learning_rate=1e-4)
    tx, _ = _make_tx(recipe)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(make_bert_pretraining_loss(model), tx, clip_norm=recipe.clip_norm)
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                           seed=args.seed))
    batches = [next(mlm_device_batches(data, args.rows, device="cuda", seed=1, start_step=i))
               for i in range(args.warmup + 2 * args.iters)]
    rng = make_rng(args.seed, "cuda")
    it = iter(batches)
    for _ in range(args.warmup):
        state, metrics = step(state, next(it), rng)
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        state, metrics = step(state, next(it), rng)
        metrics["loss"].item()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            state, metrics = step(state, next(it), rng)
            metrics["loss"].item()
    kernels = _kernel_times(prof)
    per_step = lambda us: us / 1e3 / args.iters  # noqa: E731
    device_ms = per_step(sum(kernels.values()))
    wall_ms = statistics.median(walls)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    flash = {name: per_step(sum(v for k, v in kernels.items() if f"::{name}_" in k))
             for name in names}
    # The kernel functions behind each sum, as the profiler names them.
    functions = {name: sorted({m.group(1) for k in kernels if f"::{name}_" in k
                               for m in [re.search(r"::(\w+)[<(]", k)] if m})
                 for name in names}
    print(json.dumps({
        "rows": args.rows, "seq": args.seq, "wall_ms": wall_ms, "wall_ms_min": min(walls),
        "device_ms": device_ms, "busy_share": device_ms / wall_ms if wall_ms else None,
        "flash_ms": flash, "flash_share": sum(flash.values()) / device_ms if device_ms else None,
        "flash_kernel_functions": functions,
        "kernels_per_step": sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)) / args.iters,
        "top_kernels_ms": {k[:90]: per_step(v) for k, v in top},
        "loss": metrics["loss"].item(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
