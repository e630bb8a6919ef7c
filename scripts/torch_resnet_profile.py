#!/usr/bin/env python3
"""Where an image model's training step spends its time on one CUDA card.

The PyTorch port's counterpart of ``scripts/mfu_sweep.py`` for one card,
for ResNet-50 at 224x224 (``--model resnet50``, SGD 0.1 with momentum 0.9)
or Inception-v3 at 299x299 with the aux head (``--model inception``, the
``imagenet_inception_async`` recipe: plain SGD 0.05, K = 4 stale
gradients, dropout 0.5), in bf16 over f32 params (seeded random weights)
through ``make_train_step``, a fixed batch of ``N(0, 1)`` images per batch
size, and for each ``--batches`` size, after ``--warmup`` steps:

- ``wall_ms``: host clock per step ending in a synchronise (median of
  ``--iters``), images/s and MFU against 989 TFLOP/s at 3 x the forward's
  FLOPs per image, counted from the model's layers
  (``models/flops.py``, 2 FLOPs a multiply-add);
- ``device_ms``: summed CUDA kernel time per step from ``torch.profiler``,
  and ``busy_share`` = device_ms / wall_ms;
- the device time of the port's 1x1 kernels (``pw_dgrad``, ``bn_reduce``,
  ``bn_apply_dx``, ``bn_apply_dw``; the kernel functions the profiler names
  behind each) and the kernels that take the most time;
- ``host_op_ms``: the host time spent inside PyTorch operators per step
  (their self CPU time; the Python around them is the rest of the wall),
  and the operators that take the most of it.

One backend per process, and every wall clock is taken before the
profiler first runs in it. Prints one JSON line per batch size; needs a
card::

    python3 scripts/torch_resnet_profile.py --pw-backend fused [--batches 128]
    python3 scripts/torch_resnet_profile.py --model inception [--fused]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx  # noqa: E402
from distributed_tensorflow_tpu_torch.models import InceptionV3, ResNet50  # noqa: E402
from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image  # noqa: E402
from distributed_tensorflow_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_rng,
    make_train_step,
)
from distributed_tensorflow_tpu_torch.train.objectives import (  # noqa: E402
    init_model,
    make_classification_loss,
)

PEAK_BF16_FLOPS = 989e12
PORT_KERNELS = ("pw_dgrad", "bn_reduce", "bn_apply_dx", "bn_apply_dw")


def _host_times(prof) -> dict[str, float]:
    """Self CPU microseconds per operator name over the profiled window."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_cpu_time_total", 0.0) or 0.0
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CPU:
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out


def _kernel_times(prof) -> dict[str, float]:
    """Device microseconds per kernel name over the profiled window, user
    annotations (which span kernels counted on their own) left out."""
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            out[evt.key] = out.get(evt.key, 0.0) + us
    return out


def _setup(args):
    """``(model, backend label, image size, recipe, staleness)``."""
    import dataclasses

    gen = torch.Generator("cuda").manual_seed(args.seed)
    if args.model == "inception":
        model = InceptionV3(dtype=torch.bfloat16, fused=args.fused, device="cuda", generator=gen)
        recipe = dataclasses.replace(PRESETS["imagenet_inception_async"], lr_schedule="constant")
        return model, "fused" if args.fused else "plain", 299, recipe, recipe.staleness
    model = ResNet50(dtype=torch.bfloat16, pw_backend=args.pw_backend, device="cuda",
                     generator=gen)
    recipe = dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                                 learning_rate=0.1, momentum=0.9, optimizer="sgd")
    return model, args.pw_backend, 224, recipe, 0


def profile(args) -> list[dict]:
    """Wall times for every batch size first, then a profiler window per
    size: one backend per process, and no wall clock taken after a profiler
    window (a finished window can leave callbacks that slow the host)."""
    model, backend, hw, recipe, staleness = _setup(args)
    flops_per_image = train_flops_per_image(model, (hw, hw, 3))
    params, model_state = init_model(model)
    tx, _ = _make_tx(recipe)
    state = create_train_state(params, tx, model_state, staleness=staleness)
    step = make_train_step(make_classification_loss(model), tx,
                           mode="stale" if staleness else "sync", staleness=staleness)
    gen = torch.Generator("cuda").manual_seed(args.seed)
    rng = make_rng(args.seed, "cuda")
    batches, walls, peaks = {}, {}, {}
    for rows in args.batches:
        batches[rows] = {
            "image": torch.randn(rows, hw, hw, 3, device="cuda", generator=gen),
            "label": torch.randint(0, 1000, (rows,), device="cuda", generator=gen,
                                   dtype=torch.int32)}
        torch.cuda.reset_peak_memory_stats()
        for _ in range(args.warmup):
            state, metrics = step(state, batches[rows], rng)
        torch.cuda.synchronize()
        walls[rows] = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[rows], rng)
            metrics["loss"].item()
            walls[rows].append((time.perf_counter() - t0) * 1e3)
        peaks[rows] = torch.cuda.max_memory_allocated() / 1e9
    out = []
    for rows in args.batches:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                state, metrics = step(state, batches[rows], rng)
                metrics["loss"].item()
        kernels = _kernel_times(prof)
        host = _host_times(prof)
        per_step = lambda us: us / 1e3 / args.iters  # noqa: E731
        device_ms = per_step(sum(kernels.values()))
        wall_ms = statistics.median(walls[rows])
        # A port kernel's functions are named after it (bn_apply_dx_strip_sm90,
        # pw_dgrad_kernel_sm90, ...).
        port = {name: per_step(sum(v for k, v in kernels.items() if f"{name}_" in k))
                for name in PORT_KERNELS}
        # The kernel functions behind each sum, as the profiler names them.
        functions = {name: sorted({m.group(1) for k in kernels if f"{name}_" in k
                                   for m in [re.search(r"::(\w+)[<(]", k)] if m})
                     for name in PORT_KERNELS}
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:args.top]
        out.append({
            "model": args.model, "backend": backend, "rows": rows, "image": hw,
            "wall_ms": wall_ms,
            "wall_ms_min": min(walls[rows]), "images_per_s": rows / (wall_ms / 1e3),
            "train_gflop_per_image": flops_per_image / 1e9,
            "mfu": flops_per_image * rows / (wall_ms / 1e3) / PEAK_BF16_FLOPS,
            "device_ms": device_ms, "busy_share": device_ms / wall_ms if wall_ms else None,
            "port_kernels_ms": port, "port_kernel_functions": functions,
            "port_kernels_share": sum(port.values()) / device_ms if device_ms else None,
            "kernels_per_step": sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)) / args.iters,
            "top_kernels_ms": {k[:90]: per_step(v) for k, v in top},
            "host_op_ms": per_step(sum(host.values())),
            "top_host_ops_ms": {k[:60]: per_step(v) for k, v in
                                sorted(host.items(), key=lambda kv: -kv[1])[:args.top]},
            "peak_mem_gb": peaks[rows],
            "loss": metrics["loss"].item(),
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50", choices=["resnet50", "inception"])
    ap.add_argument("--pw-backend", default="conv", choices=["conv", "pallas", "fused"],
                    help="ResNet-50: 1x1 path of the bottleneck blocks")
    ap.add_argument("--fused", action="store_true",
                    help="Inception-v3: the fused conv+BN backward on the 1x1 units")
    ap.add_argument("--batches", type=int, nargs="+", default=[128])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_resnet_profile: needs a CUDA card", file=sys.stderr)
        return 1
    for row in profile(args):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
