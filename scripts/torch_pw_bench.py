#!/usr/bin/env python3
"""The 1x1-conv backward kernels alone, at ResNet-50's shapes, on one card.

The PyTorch port of ``scripts/pw_bench.py``: the same ``SHAPES`` groups of
(B, HW, K, N) at b = 128 and the same flags. For each shape it times the
dgrad kernel (``pw_dgrad``; the N = 64 shape too, which the model routes
as ``pw_dgrad_n64``: the same kernel) and the wgrad kernel (``pw_wgrad``,
the only caller of the JAX package's ``_wgrad_pallas`` counterpart) with
CUDA events over back-to-back launches after warm-up, and prints one JSON
line per shape and kernel: ms per call, GB/s against the card's 3.35
TB/s, the bound (bytes moved once over 3.35 TB/s, or the products over
989 TFLOP/s bf16, whichever is larger) and the yardstick of one PyTorch
call that computes the same function, timed the same way, which the port
never calls:

- dgrad: ``torch.matmul(g, w.t())``;
- wgrad: ``torch.mm(x2.t(), g, out_dtype=torch.float32)`` where this
  torch's ``mm`` takes ``out_dtype``, else ``torch.matmul(x2.t(), g)``
  with a result in the inputs' dtype (labelled so).

Inputs are bf16 N(0, 1) from a seeded ``torch.Generator``. At the smaller
shapes (stage 3 and 4: 6-38 MB of inputs) they sit in the card's 50 MB L2
across the back-to-back launches, so those times are hot-L2 times.

``--graph`` adds each kernel's and yardstick's device time
(``graph_ms``, ``library_graph_ms``): CUDA events around the replay of a
CUDA graph that holds 20 calls, so the host's time per call (Python, the
operand checks, the launch) is not in it. The time per call stays ``ms``.
Under ``--graph`` the launch counters count the wrappers' calls, the 20
captured ones included; the graph's two replays run those launches again
(``graph_runs`` a row), which no counter sees.

``--shapes resnet50`` takes the 12 (M, K, N) of the 1x1 units of a b=128
ResNet-50 step that route to the dgrad kernel, and the N = 64 unit, and
adds a ``per_step`` line: each shape's dgrad times weighted by its units a
step (``RESNET50``: 29 units, 2 at N = 64), the table ``chip_smoke.py``
sums by. To time another checkout's kernels by the same method (for
example a ``git archive`` of an earlier commit), copy this script into
that checkout's ``scripts/`` and run it there: it imports the port from
the checkout it sits in.

``--check`` first holds each shape's dgrad and wgrad to f32 references of
the same bf16 inputs: dgrad (bf16 out) within one bf16 rounding step of
the reference (2^-7 |ref| + 1e-3), wgrad (f32 out, exact products, f32
sums over M in another order) within 1e-5 of the reference's largest
|entry|. The last line is ``{"launches": {...}}``, the kernels' launch
counters over the whole run, beside the launches the script made.

    python3 scripts/torch_pw_bench.py [--shapes stage1|stage2|stage34|all|resnet50] [--check]
        [--graph]

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
# (B, HW, K, N) -> units a step: the 1x1 units of the b=128 ResNet-50 step
# that take the dgrad kernel's pw_dgrad route (29 units, 12 shapes), then
# those of its pw_dgrad_n64 route (2 units).
RESNET50 = {
    (128, 56, 256, 128): 1, (128, 28, 128, 512): 4, (128, 28, 256, 512): 1,
    (128, 28, 512, 128): 3, (128, 28, 512, 256): 1, (128, 14, 256, 1024): 6,
    (128, 14, 512, 1024): 1, (128, 14, 1024, 256): 5, (128, 14, 1024, 512): 1,
    (128, 7, 512, 2048): 3, (128, 7, 1024, 2048): 1, (128, 7, 2048, 512): 2,
}
RESNET50_N64 = {(128, 56, 256, 64): 2}
# (B, HW, K, N) -> units a step: the 1x1 units of the Inception-v3 step at
# 299x299, 128 images, fused=True, that take the fused conv+BN backward (27
# units, 12 shapes: the four C blocks and D on the 17x17 grid, the two E
# blocks on 8x8, the aux head's 1x1 conv on 5x5). chip_smoke.py and
# torch_bwd_bench.py time the fused kernels by this table.
INCEPTION_FUSED = {
    (128, 17, 768, 128): 2, (128, 17, 768, 160): 4, (128, 17, 768, 192): 12,
    **{(128, 8, k, n): 1 for k in (1280, 2048) for n in (192, 320, 384, 448)},
    (128, 5, 768, 128): 1,
}
# (M, K, N) that the fused kernels' tiling and copy rings put at risk,
# checked but not timed (chip_smoke.py and the card tests of
# tests/test_torch_fused_conv_bn.py): M below one chunk and M not a multiple
# of 64 (dz zeroed past M), N = 160 and 200 (a dz chunk partly past N,
# whose constants are never read), K = 8 (one x2 box, mostly past K,
# 128-row tiles), fewer dW tiles than SMs (6272, 512, 2048: 32 tiles, 4 M
# ranges), a single M range (3136, 2048, 2048: 128 tiles) and ranges cut by
# the 4096-row cap (6272, 2048, 2048); then the dx kernels' boundaries, at
# an M that is no whole number of 128- or 64-row strips: N = 512 (the
# strip kernel's widest dz), 520 (the panel kernel, a last chunk 8 columns
# wide) at K = 256 (one 256-column tile), 512 (one 512-column tile) and 520
# (two, the second 8 columns wide), and K = 520 in the strip kernel (a last
# K tile 8 columns wide).
BN_RISK_SHAPES = [(17, 256, 128), (25091, 256, 128), (4099, 256, 160), (4099, 256, 200),
                  (1000, 8, 128), (17, 8, 8), (6272, 512, 2048), (3136, 2048, 2048),
                  (6272, 2048, 2048), (4099, 256, 512), (1000, 520, 512), (1000, 256, 520),
                  (1000, 512, 520), (1000, 520, 520)]
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
WARMUP, ITERS = 3, 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def mkn(b: int, hw: int, k: int, n: int) -> tuple[int, int, int]:
    """The (M, K, N) of a (B, HW, K, N) shape: M = B * HW * HW."""
    return b * hw * hw, k, n


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
    """ms per call of ``fn()``: CUDA events around ``iters`` back-to-back
    calls after ``warmup``, the host's time per call included where it is
    longer than the device's."""
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


def graph_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Device ms of one ``fn()``: ``warmup`` calls on a side stream, then
    ``iters`` calls captured in one CUDA graph, replayed once to settle
    and once between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def bench_shape(b, hw, k, n, x2, g, w, graph: bool) -> list[dict]:
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
        row = {"kernel": name, "M": m, "K": k, "N": n, "ms": ms,
               "gb_per_s": nbytes / (ms / 1e3) / 1e9,
               "share_of_3350_gb_per_s": nbytes / (ms / 1e3) / PEAK_BYTES,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(library), "library": label,
               "launches": WARMUP + ITERS}
        if graph:
            row.update({"graph_ms": graph_ms(kernel), "library_graph_ms": graph_ms(library),
                        "launches": 2 * (WARMUP + ITERS), "graph_runs": 2 * ITERS})
        rows.append(row)
    return rows


def per_step(rows: list[dict]) -> dict:
    """The dgrad rows of ``--shapes resnet50`` summed as one training step:
    each shape's times weighted by its units a step."""
    dgrad = {(r["M"], r["K"], r["N"]): r for r in rows if r["kernel"] == "pw_dgrad"}
    out = {}
    for route, table in (("pw_dgrad", RESNET50), ("pw_dgrad_n64", RESNET50_N64)):
        sel = [(dgrad[mkn(*shape)], u) for shape, u in table.items()]
        out[route] = {key: sum(u * r[key] for r, u in sel)
                      for key in ("ms", "library_ms", "graph_ms", "library_graph_ms",
                                  "bound_ms") if key in sel[0][0]}
        out[route]["units"] = sum(u for _, u in sel)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="stage1", choices=list(SHAPES) + ["all", "resnet50"])
    ap.add_argument("--check", action="store_true",
                    help="hold dgrad and wgrad to f32 references first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels, timed) or cpu (the plain versions)")
    ap.add_argument("--batch", type=int, default=128,
                    help="images per shape in place of the trace's 128")
    ap.add_argument("--graph", action="store_true",
                    help="add each kernel's device time from a replayed CUDA graph")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
        pc.build()
    if args.shapes == "resnet50":
        table = [*RESNET50, *RESNET50_N64]
    else:
        table = [s for name in (list(SHAPES) if args.shapes == "all" else [args.shapes])
                 for s in SHAPES[name]]
    shapes = [(args.batch, hw, k, n) for _, hw, k, n in table]
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
        rows = []
        for i, (b, hw, k, n) in enumerate(shapes):
            x2, g, w = inputs(b, hw, k, n, device, seed=i)
            for row in bench_shape(b, hw, k, n, x2, g, w, args.graph):
                made[row["kernel"]] += row["launches"]
                rows.append(row)
                emit(row)
            del x2, g, w
        if args.shapes == "resnet50" and args.batch == 128:
            emit({"per_step": per_step(rows)})
    emit({"launches": {name: pc.LAUNCHES[name] for name in made}, "made": made})
    return 0


if __name__ == "__main__":
    sys.exit(main())
