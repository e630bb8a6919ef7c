#!/usr/bin/env python3
"""The 1x1-conv backward kernels alone, at ResNet-50's shapes, on one card.

The PyTorch port of ``scripts/pw_bench.py``: the same ``SHAPES`` groups of
(B, HW, K, N) at b = 128 and the same flags. For each shape it times the
dgrad kernel (``pw_dgrad``; the N = 64 shape too, which the model routes
as ``pw_dgrad_n64``: the same kernel) and the wgrad kernel (``pw_wgrad``,
the only caller of the JAX package's ``_wgrad_pallas`` counterpart) with
CUDA events over back-to-back launches after warm-up, and prints one JSON
line per shape and kernel: ms, GB/s against the card's 3.35 TB/s, the
bound (bytes moved once over 3.35 TB/s, or the products over 989 TFLOP/s
bf16, whichever is larger) and the yardstick of one PyTorch call that
computes the same function, which the port never calls:

- dgrad: ``torch.matmul(g, w.t())``;
- wgrad: ``torch.mm(x2.t(), g, out_dtype=torch.float32)`` where this
  torch's ``mm`` takes ``out_dtype``, else ``torch.matmul(x2.t(), g)``
  with a result in the inputs' dtype (labelled so).

Inputs are bf16 N(0, 1) from a seeded ``torch.Generator``. At the smaller
shapes (stage 3 and 4: 6-38 MB of inputs) they sit in the card's 50 MB L2
across the back-to-back launches, so those times are hot-L2 times.

``--check`` first holds each shape's dgrad and wgrad to f32 references of
the same bf16 inputs: dgrad (bf16 out) within one bf16 rounding step of
the reference (2^-7 |ref| + 1e-3), wgrad (f32 out, exact products, f32
sums over M in another order) within 1e-5 of the reference's largest
|entry|. The last line is ``{"launches": {...}}``, the kernels' launch
counters over the whole run, beside the launches the script made.

    python3 scripts/torch_pw_bench.py [--shapes stage1|stage2|stage34|all] [--check]

Runs on the card by default; ``--device cpu`` runs the plain versions only
(no kernel, no timing), at ``--batch`` images in place of 128.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.device import resolve_device  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import pointwise_conv as pc  # noqa: E402

# (B, HW, K, N): the 1x1 layers of the b=128 ResNet-50 step, heaviest first.
SHAPES = {
    "stage1": [
        (128, 56, 256, 64),
        (128, 56, 64, 256),
        (128, 56, 64, 64),
    ],
    "stage2": [
        (128, 28, 512, 128),
        (128, 28, 128, 512),
    ],
    "stage34": [
        (128, 14, 1024, 256),
        (128, 14, 256, 1024),
        (128, 7, 2048, 512),
        (128, 7, 512, 2048),
    ],
}
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
WARMUP, ITERS = 3, 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def inputs(b: int, hw: int, k: int, n: int, device, seed: int):
    """``(x2 [M, K], g [M, N], w [K, N])`` bf16 N(0, 1) on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    m = b * hw * hw
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for shape in ((m, k), (m, n), (k, n)))


def check_numerics(x2, g, w, on_card: bool) -> dict:
    """dgrad and wgrad (the kernels on the card, the plain versions on the
    CPU) against f32 products of the same bf16 inputs; raises on a miss."""
    dx_ref = torch.matmul(g.float(), w.float().t())
    dw_ref = x2.float().t() @ g.float()
    dx = pc.dgrad_cuda(g, w) if on_card else pc.dgrad_reference(g, w)
    dw = pc.wgrad_cuda(x2, g) if on_card else pc.wgrad(x2, g)
    err_dx = (dx.float() - dx_ref).abs()
    err_dw = (dw - dw_ref).abs().max().item()
    ok_dx = bool(torch.all(err_dx <= 2.0**-7 * dx_ref.abs() + 1e-3).item())
    ok_dw = err_dw <= 1e-5 * dw_ref.abs().max().item()
    if not (ok_dx and ok_dw and dw.dtype == torch.float32):
        raise SystemExit(f"pw_bench: numerics out of tolerance at {tuple(x2.shape)} x "
                         f"{tuple(g.shape)}: dx {err_dx.max().item()}, dW {err_dw}")
    return {"max_abs_err_dx": err_dx.max().item(), "max_abs_err_dw": err_dw,
            "range_dx": dx_ref.abs().max().item(), "range_dw": dw_ref.abs().max().item()}


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wgrad_library(x2, g):
    """The one-call yardstick for wgrad and its label."""
    try:
        torch.mm(x2.t(), g, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no out_dtype in this torch, or not for these
        return ((lambda: torch.matmul(x2.t(), g)),
                f"torch.matmul(x2.t(), g) -> {str(x2.dtype).removeprefix('torch.')}")
    return (lambda: torch.mm(x2.t(), g, out_dtype=torch.float32)), \
        "torch.mm(x2.t(), g, out_dtype=torch.float32)"


def bench_shape(b, hw, k, n, x2, g, w) -> list[dict]:
    m = b * hw * hw
    rows = []
    lib_wgrad, lib_label = wgrad_library(x2, g)
    for name, kernel, library, label, nbytes in (
            ("pw_dgrad", lambda: pc.dgrad_cuda(g, w), lambda: torch.matmul(g, w.t()),
             "torch.matmul(g, w.t())", 2 * (m * n + k * n + m * k)),
            ("pw_wgrad", lambda: pc.wgrad_cuda(x2, g), lib_wgrad, lib_label,
             2 * (m * k + m * n) + 4 * k * n)):
        ms = cuda_ms(kernel)
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
        rows.append({"kernel": name, "M": m, "K": k, "N": n, "ms": ms,
                     "gb_per_s": nbytes / (ms / 1e3) / 1e9,
                     "share_of_3350_gb_per_s": nbytes / (ms / 1e3) / PEAK_BYTES,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": cuda_ms(library), "library": label,
                     "launches": WARMUP + ITERS})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="stage1", choices=list(SHAPES) + ["all"])
    ap.add_argument("--check", action="store_true",
                    help="hold dgrad and wgrad to f32 references first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels, timed) or cpu (the plain versions)")
    ap.add_argument("--batch", type=int, default=128,
                    help="images per shape in place of the trace's 128")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
        pc.build()
    groups = list(SHAPES) if args.shapes == "all" else [args.shapes]
    shapes = [(args.batch, hw, k, n) for name in groups for _, hw, k, n in SHAPES[name]]
    pc.reset_launch_counts()
    made = {"pw_dgrad": 0, "pw_wgrad": 0}
    if args.check:
        for i, (b, hw, k, n) in enumerate(shapes):
            x2, g, w = inputs(b, hw, k, n, device, seed=i)
            emit({"check": "numerics", "B": b, "HW": hw, "K": k, "N": n,
                  **check_numerics(x2, g, w, on_card)})
            made["pw_dgrad"] += on_card
            made["pw_wgrad"] += on_card
    if on_card:
        for i, (b, hw, k, n) in enumerate(shapes):
            x2, g, w = inputs(b, hw, k, n, device, seed=i)
            for row in bench_shape(b, hw, k, n, x2, g, w):
                made[row["kernel"]] += row["launches"]
                emit(row)
            del x2, g, w
    emit({"launches": {name: pc.LAUNCHES[name] for name in made}, "made": made})
    return 0


if __name__ == "__main__":
    sys.exit(main())
