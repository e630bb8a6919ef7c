#!/usr/bin/env python3
"""Where a BERT-base serving forward spends its time on one CUDA card.

Builds the PyTorch port's ``BertInferenceEngine`` at full BERT-base width
(``BertConfig()`` defaults, bf16 compute, seeded random weights) and, per
(bucket, tier) cell, measures:

- ``wall_ms``: host clock per ``run_batch`` (assemble, dispatch, forward,
  fetch; ``fetch`` synchronises), median over ``--iters``;
- ``device_ms``: summed CUDA kernel time per ``run_batch`` from
  ``torch.profiler`` and ``busy_share`` = device_ms / wall_ms;
- the kernels that take the most device time, and the flash-attention
  kernel's share.

Prints one JSON line per cell; needs a card::

    python3 scripts/torch_serve_profile.py [--iters 10] [--cells 512x8 128x8]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.models.bert import (  # noqa: E402
    BertConfig,
    BertForPreTraining,
)
from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine  # noqa: E402


def _kernel_times(prof) -> dict[str, float]:
    """Device microseconds per kernel name over the profiled window."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", nargs="+", default=["128x8", "256x8", "512x8", "512x1"],
                    help="bucket x tier cells to measure")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    cfg = BertConfig(dtype=torch.bfloat16)
    model = BertForPreTraining(
        cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(args.seed)
    )
    engine = BertInferenceEngine(
        model, dict(model.state_dict()), "cuda", buckets=(128, 256, 512),
        max_batch=8, batch_tiers=(1, 8),
    )
    rng = np.random.default_rng(args.seed)
    for cell in args.cells:
        bucket, tier = (int(x) for x in cell.split("x"))
        batch = [{"input_ids": rng.integers(5, cfg.vocab_size, size=bucket)}
                 for _ in range(tier)]
        for _ in range(3):
            engine.run_batch(batch)
        walls = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            engine.run_batch(batch)
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                engine.run_batch(batch)
        kernels = _kernel_times(prof)
        device_ms = sum(kernels.values()) / 1e3 / args.iters
        wall_ms = statistics.median(walls)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        flash_ms = sum(v for k, v in kernels.items() if "flash_fwd" in k) / 1e3 / args.iters
        print(json.dumps({
            "bucket": bucket, "tier": tier, "wall_ms": wall_ms,
            "wall_ms_min": min(walls), "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "flash_ms": flash_ms,
            "kernels_per_forward": sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
            ) / args.iters,
            "top_kernels_ms": {k[:80]: v / 1e3 / args.iters for k, v in top},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
