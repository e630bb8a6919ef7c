#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. build  — compile the port's CUDA kernels from ``csrc/`` (one nvcc per
   library, started together, sm_90a) into ``build/kernels/``; print the
   build seconds, ptxas' resource use and spills (the 1x1 GEMMs' ``_sm90``
   kernels must not spill), and the dynamic shared memory and resident
   blocks per SM of the bf16 flash kernels at D=64 and of the 1x1 GEMMs
   (the card's occupancy calculator).
2. kernel — hold the flash-attention forward kernel to its plain PyTorch
   version on the card: bf16 at B in {1, 8} x L in {256, 512, 300} with
   H=12, D=64, plus D=32, D=128, an fp32 case and the BERT training cell
   (B=24, L=512, no padding); masks with padded and fully masked rows
   (exact zeros, lse = -1e30). Every bf16 case is also run and timed under
   both q tiles (64 and 128 rows a block), and 24 ring shapes are checked
   under both: L in {17, 64, 65, 129, 300, 512} at B=1, H=2 (a grid
   smaller than the SM count) and at B=2 (a fully masked row) for D in
   {32, 64, 128}. Tolerances: bf16 o within 1e-2 (P rounds to bf16 per
   64-key tile in the kernel, once in the plain version), fp32 o within
   1e-5, lse within 1e-4. Prints kernel/plain/library (SDPA, a yardstick
   the port never calls) times and the card's bound, one JSON line per
   shape.
3. kernel_bwd — hold the backward kernels (dQ, dK/dV) to the plain backward
   on the card, with and without an lse cotangent: bf16 at B in {1, 8, 24}
   x L in {256, 512, 300}, H=12, D=64, with padded rows and one fully
   masked row (which must give exact zero gradients), the unpadded BERT
   training cell (B=24, L=512), D=32, D=128, an fp32 case, and the 24 ring
   shapes. Tolerances: bf16 within 3e-2 (the gradients are of order 1; P
   and dS round to bf16 per tile in both, from f32 products summed in
   another order), fp32 within 1e-4. Prints per shape the backward's time
   (delta pass + both kernels) and each kernel's, the plain version's, the
   backward of SDPA with the same mask as a yardstick, and the bound; per
   kernel at B=24, L=512 padded and unpadded.
4. kernel_conv1x1 — the 1x1-conv dgrad kernel (both routes) against its
   plain version at ResNet-50's 12 (M, K, N) shapes at b=128, the N=64
   shape, a ragged M and an fp32 case, timed, and at ``PW_RISK_SHAPES``
   in bf16 and fp32, checked only: bf16 within one bf16 rounding step of
   the plain value (2^-7 |ref| + 1e-3), fp32 within 1e-4. Prints per shape
   the kernel's time per back-to-back call (``kernel_ms``, the method of
   every other phase) and its device time (``kernel_graph_ms``: the calls
   replayed from a CUDA graph, no host time; ``graph_ms`` of
   ``scripts/torch_pw_bench.py``, whose shape tables these phases use),
   the plain version's, the library's (``torch.matmul(g, w.t())``, by both
   methods) and the bound.
5. kernel_wgrad — the 1x1-conv wgrad kernel against its plain version at
   the same 12 shapes, the N=64 shape, ``scripts/torch_pw_bench.py``'s 9
   shapes, a ragged M and an fp32 case, timed, and at the risk shapes and
   (4099, 64, 256), checked only: f32 dW within 1e-5 of its largest |entry|
   (exact products summed over M in another order). Prints the same times
   (library: an f32-out ``torch.mm``) and the number of M ranges.
6. kernel_bn_bwd — the fused conv+BN backward kernels (reduce, apply dx,
   apply dW) against their plain versions at ResNet-50's 12 shapes (ReLU on
   and off, a ragged M and fp32) and at Inception-v3's 12 (ReLU on, bf16,
   and fp32 at N=160; N = 160, 192, 320 and 448 end partway through the
   kernels' column tiles): s1, s2 within 1e-5 of the terms' magnitudes
   summed, dx as the dgrad, dW within 1e-5 of its largest entry (f32 sums
   over M in another order). No single PyTorch call computes these, so no
   library time.
7. pw_bench — ``python3 scripts/torch_pw_bench.py --shapes all --check``,
   the entry point that runs the wgrad kernel: its exit code, its numerics
   lines and its launch counters against the launches it made.
8. serve  — full-width BERT-base (the ``BertConfig()`` defaults: 12 layers,
   hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions) in bf16
   with seeded random weights: save and restore through ``ckpt``, build
   ``BertInferenceEngine`` (buckets 128/256/512, tiers 1/2/4/8) behind
   ``Client``, serve 24 requests across all three buckets, and check that
   the kernel ran 12 times per forward in buckets 256 and 512, that the
   answers agree with the same params run through plain attention on the
   card, and one HTTP ``/v1/mlm`` round trip. Then per-bucket latency.
9. train  — full-width BERT-base pretraining (MLM + NSP) in bf16 over f32
   params at L=512, 24 rows, ``SyntheticMLM`` data, AdamW(1e-4, weight
   decay 0.01 off biases/LayerNorms) + global-norm clip 1.0, dropout 0.1
   from an explicit CUDA generator, through ``make_train_step`` + ``fit``.
   Checks: a finite loss every step; each of flash_fwd, flash_bwd_dq and
   flash_bwd_dkv launched 12 times per step; with dropout off, one step's
   gradients through the kernels agree leaf by leaf with plain attention's:
   relative L2 error within 2e-2 over the whole gradient and for the median
   leaf, and within 0.25 for every leaf (bf16 activations round differently
   on the two paths; the pooler and NSP leaves ride on one bf16 [CLS]
   vector per row and move most), each against a floor of 1e-3 of the
   whole gradient's norm for the key biases, whose exact gradient is zero;
   on one fixed batch at a constant lr the loss falls over 10 steps. Then
   the median ms per step, tokens/s and MFU against 989 TFLOP/s.
10. train_resnet50 — full-width ResNet-50 at 224x224, 128 images, bf16 over
   f32 params, SGD 0.1 with momentum 0.9, synthetic class-template data
   through ``device_batches`` + ``prefetch`` + ``make_train_step`` +
   ``fit``, under each 1x1 backend. Checks: a finite loss every step; the
   launches per step exactly 0 (``conv``), 29 ``pw_dgrad`` + 2
   ``pw_dgrad_n64`` and no ``pw_wgrad`` (``pallas``: dW stays a plain
   product, as in the JAX VJP), 29 of each fused kernel (``fused``); on
   the same params (the ``conv`` run's after its steps), batch and
   batch_stats, ``pallas``' and ``fused``'s gradients against ``conv``'s
   within 5e-2 relative L2 over the whole gradient and the median leaf and
   0.5 for every leaf (against a floor of 1e-3 of the whole norm), and their
   new batch_stats within 1e-2 (bf16 activations, dz and dW round at other
   places on each path, through 53 BatchNorms); under ``fused`` the loss
   on a fixed batch falls over 10 steps. Then ms per step, images/s, MFU
   (3 x the forward's FLOPs per image, counted from the model's layers by
   ``models/flops.py`` at 2 FLOPs a multiply-add, against 989 TFLOP/s) and
   peak memory.
11. train_inception — full-width Inception-v3 at 299x299 with the aux head,
   128 images (``bench.py``'s per-card batch for ResNet-50), bf16 over f32
   params, the ``imagenet_inception_async`` recipe (plain SGD 0.05 at a
   constant rate, K = 4 stale gradients), synthetic class-template data
   through ``device_batches`` + ``prefetch`` + ``make_train_step`` +
   ``fit``, with ``fused=False`` and ``fused=True``. Checks: a finite loss
   every step; exactly 27 launches a step of each fused kernel under
   ``fused=True`` and none under ``fused=False``; on the same params, batch
   and batch_stats with dropout off and no stale ring, the fused gradients
   against the plain ones (ResNet-50's tolerances); on one fixed batch from
   a fresh K = 4 ring (its first 4 steps apply zeros) the loss after 14
   steps below the first step's. Then ms per step, images/s, MFU and peak
   memory.
12. train_cli — ``python -m distributed_tensorflow_tpu_torch.cli.train
   --config bert_base`` (the preset at its own width: L=128, dense
   attention) for 3 steps with a checkpoint, then ``restore_serving_state``
   on it and one ``run_batch``.
13. train_cli_image — ``cli.train --config imagenet_resnet50 --image-size 64
   --global-batch 16 --steps 3`` with a checkpoint, then a ``Checkpointer``
   restore that brings back the step and every BatchNorm running average.
14. train_cli_inception — the same for ``--config imagenet_inception_async
   --image-size 75`` (no aux head below 299x299): the restore also brings
   back the K = 4 stale ring, on the card.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; without CUDA it exits 1.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

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


def train_flops_per_token(cfg, seq: int) -> float:
    """Training FLOPs per token of BERT (3x the forward's matmuls), the
    formula of ``scripts/bench_bert.py`` ``train_flops_per_token``."""
    d, ff, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_layer = 8 * d * d + 4 * d * ff + 4 * seq * d
    return 3.0 * (cfg.num_layers * per_layer + 2 * d * d + 2 * d * vocab)


def flash_bound(b, l, h, d, valid_keys, esize, fp32):
    """Least time for this call on an H100 SXM: QK^T and PV over the valid
    keys (4*H*D*L per valid key), and q/k/v/o, the mask and lse moved once."""
    flops = 4.0 * h * d * l * float(sum(valid_keys))
    nbytes = 4.0 * b * l * h * d * esize + b * l + 4.0 * b * h * l
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def ptxas_entries(log: str) -> dict:
    """ptxas' ``-v`` lines per kernel: ``{entry: {"registers", "spill_stores",
    "spill_loads"}}`` (entry = the mangled name)."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = {}
        elif entry and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out[entry]["spill_stores"] = int(words[words.index("spill") - 2])
            out[entry]["spill_loads"] = int(words[words.index("loads") - 3])
        elif entry and "Used" in ln and "registers" in ln:
            words = ln.split()
            out[entry]["registers"] = int(words[words.index("registers,") - 1])
    return out


def phase_build(fm, pc, fcb):
    from distributed_tensorflow_tpu_torch.ops import build as kbuild

    t0 = time.monotonic()
    kbuild.load_libraries(kbuild.LIBRARIES)  # one nvcc per library, together
    for op in (fm, pc, fcb):
        op.build()  # bind the built libraries
    seconds = round(time.monotonic() - t0, 3)
    for name in kbuild.LIBRARIES:
        info = kbuild.BUILD_INFO[name]
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        emit({"phase": "build", "library": Path(info["path"]).name,
              "nvcc_seconds": round(info["seconds"], 3), "seconds": seconds,
              "ptxas": regs})
    # The 1x1 GEMMs' registers and spills, which their design counts on.
    gemm = {entry: rec for entry, rec in
            ptxas_entries(kbuild.BUILD_INFO["pointwise_conv"]["log"]).items()
            if "_sm90" in entry}
    check(len(gemm) == 3 and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                                 for r in gemm.values()),
          f"pointwise_conv sm90 kernels: ptxas {gemm}")
    emit({"phase": "build", "pointwise_conv_sm90_ptxas": gemm})
    occupancy = {name: {"smem_bytes": smem, "blocks_per_sm": blocks}
                 for name, (smem, blocks) in {**fm.occupancy(), **pc.occupancy()}.items()}
    emit({"phase": "build", "occupancy_bf16": occupancy})
    return occupancy


def _masked_inputs(torch, gen, b, l, h, d, dtype, n, pad):
    """``n`` random [B, L, H, D] tensors and a key mask: with ``pad`` each
    batch row keeps a random prefix of at least L/2 keys and the last row
    (when B > 1) none at all; without, every key."""
    xs = [torch.randn(b, l, h, d, device="cuda", dtype=dtype, generator=gen) for _ in range(n)]
    valid = torch.randint(l // 2, l + 1, (b,), generator=gen, device="cuda")
    if not pad:
        valid[:] = l
    elif b > 1:
        valid[-1] = 0  # a fully masked batch row
    mask = torch.arange(l, device="cuda")[None, :] < valid[:, None]
    return xs, valid, mask


# Shapes the forward's tiling and copy ring put at risk, checked but not
# timed: ragged L (17, 65, 129, 300), one K/V tile (64), a grid smaller than
# the SM count (B=1, H=2), every head dim, a fully masked row (B=2), each
# under both q tiles.
RING_SHAPES = ([(1, l, 2, 64) for l in (17, 64, 65, 129, 300, 512)]
               + [(2, l, 2, d) for d in (32, 64, 128) for l in (17, 64, 65, 129, 300, 512)])


def _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, dtype, fully_masked):
    ro, rlse = fm.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    fp32 = dtype == torch.float32
    check(torch.isfinite(o.float()).all().item(), f"non-finite o at {(b, l, h, d)}")
    check(err <= (1e-5 if fp32 else 1e-2), f"o error {err} at {(b, l, h, d, dtype)}")
    check(lse_err <= 1e-4, f"lse error {lse_err} at {(b, l, h, d, dtype)}")
    if fully_masked:
        check(torch.all(o[-1] == 0).item() and torch.all(lse[-1] == -1e30).item(),
              f"fully masked row must give o = 0 and lse = -1e30 at {(b, l, h, d)}")
    return err, lse_err


def phase_kernel(fm, torch):
    cases = [(b, l, 12, 64, torch.bfloat16) for b in (1, 8) for l in (256, 512, 300)]
    cases += [(2, 384, 24, 32, torch.bfloat16), (2, 512, 6, 128, torch.bfloat16),
              (2, 256, 12, 64, torch.float32), (24, 512, 12, 64, torch.bfloat16)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows, max_err = [], 0.0
    for b, l, h, d, dtype in cases:
        (q, k, v), valid, mask = _masked_inputs(torch, gen, b, l, h, d, dtype, 3, b != 24)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        err, lse_err = _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, dtype,
                                  1 < b < 24)
        fp32 = dtype == torch.float32
        sdpa_mask = mask[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel_ms = cuda_ms(lambda: fm.flash_fwd_cuda(q, k, v, mask), 20)
        plain_ms = cuda_ms(lambda: fm.flash_attention_reference(q, k, v, mask), 5)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask), 20)
        bound_ms, bound_by = flash_bound(
            b, l, h, d, valid.tolist(), q.element_size(), fp32)
        row = {"phase": "kernel", "B": b, "L": l, "H": h, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
               "lse_err": lse_err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        if not fp32:
            # The same call under each q tile the launcher can pick.
            for tile in (64, 128):
                got = fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile)
                _check_fwd(fm, torch, *got, q, k, v, mask, b, l, h, d, dtype, 1 < b < 24)
                row[f"kernel_ms_q{tile}"] = cuda_ms(
                    lambda tile=tile: fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile), 20)
        emit(row)
        rows.append(row)
        max_err = max(max_err, err)
    ring_err = 0.0
    for b, l, h, d in RING_SHAPES:
        (q, k, v), _, mask = _masked_inputs(torch, gen, b, l, h, d, torch.bfloat16, 3, True)
        for tile in (64, 128):
            o, lse = fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile)
            err, _ = _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, torch.bfloat16,
                                b > 1)
            ring_err = max(ring_err, err)
    emit({"phase": "kernel", "ring_shapes": len(RING_SHAPES), "q_tiles": [64, 128],
          "max_abs_err": ring_err})
    emit({"phase": "kernel", "source_note_bound": {
        "cell": "B=24, L=512, H=12, D=64, bf16, no padding",
        "gflop": 4 * 24 * 12 * 512**2 * 64 / 1e9,
        "mbytes": 4 * 24 * 512 * 768 * 2 / 1e6,
        "bound_ms": flash_bound(24, 512, 12, 64, [512] * 24, 2, False)[0]}})
    main_row = next(r for r in rows if (r["B"], r["L"], r["dtype"]) == (8, 512, "bfloat16"))
    return main_row, max(max_err, ring_err)


def bwd_bound(b, l, h, d, valid_keys, esize, fp32, products, tensors, stats):
    """Least time on an H100 SXM for ``products`` [L x D] by [D x L]-sized
    matrix products over the valid keys (2*H*D*L flops per valid key each),
    ``tensors`` [B, L, H, D] tensors and ``stats`` f32 [B, H, L] rows moved
    once, and the mask read once."""
    flops = 2.0 * products * h * d * l * float(sum(valid_keys))
    nbytes = tensors * b * l * h * d * esize + stats * 4.0 * b * h * l + b * l
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _sdpa_backward_ms(torch, q, k, v, mask, do):
    """Backward of ``scaled_dot_product_attention`` with the same key mask:
    a yardstick the port never calls. ``all``: dq, dk, dv; ``q``: dq only;
    ``kv``: dk and dv."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :])
    dot = do.transpose(1, 2)
    return {name: cuda_ms(lambda inputs=inputs: torch.autograd.grad(
                out, inputs, dot, retain_graph=True), 10)
            for name, inputs in (("all", (qt, kt, vt)), ("q", (qt,)), ("kv", (kt, vt)))}


def _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, shape, dtype, fully_masked):
    """Both backward kernels against the plain backward, with and without
    the lse cotangent; the worst error of dq and of dk/dv."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    err = {"dq": 0.0, "dkv": 0.0}
    for cot in (None, dlse):
        got = fm.flash_bwd_cuda(q, k, v, mask, o, lse, do, cot)
        ref = fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do, cot)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            check(torch.isfinite(g.float()).all().item(), f"non-finite {name} at {shape}")
            e = (g.float() - r.float()).abs().max().item()
            check(e <= tol, f"{name} error {e} at {shape, dtype}, dlse={cot is not None}")
            if fully_masked:
                check(torch.all(g[-1] == 0).item(),
                      f"fully masked row must give zero {name} at {shape}")
            key = "dq" if name == "dq" else "dkv"
            err[key] = max(err[key], e)
    return err


def phase_kernel_bwd(fm, torch):
    bf16 = torch.bfloat16
    # (B, L, H, D, dtype, padded): the padded cases draw random valid prefixes
    # and one fully masked row; (24, 512) unpadded is the BERT training cell.
    cases = [(b, l, 12, 64, bf16, True) for b in (1, 8, 24) for l in (256, 512, 300)]
    cases += [(24, 512, 12, 64, bf16, False)]
    cases += [(2, 384, 24, 32, bf16, True), (2, 512, 6, 128, bf16, True),
              (2, 256, 12, 64, torch.float32, True)]
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    main_row, max_err = None, {"dq": 0.0, "dkv": 0.0}
    for b, l, h, d, dtype, pad in cases:
        (q, k, v, do), valid, mask = _masked_inputs(torch, gen, b, l, h, d, dtype, 4, pad)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        dlse = torch.randn(lse.shape, device="cuda", generator=gen)
        fp32 = dtype == torch.float32
        err = _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, (b, l, h, d), dtype,
                         pad and b > 1)
        delta = fm.flash_bwd_delta(o, do)
        args = (q, k, v, mask, do, lse, delta)
        esize = q.element_size()
        keys = valid.tolist()
        bound_ms, bound_by = bwd_bound(b, l, h, d, keys, esize, fp32, 5, 8, 1)
        library = _sdpa_backward_ms(torch, q, k, v, mask, do)
        row = {"phase": "kernel_bwd", "B": b, "L": l, "H": h, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "padded": pad,
               "max_abs_err_dq": err["dq"], "max_abs_err_dkv": err["dkv"],
               "kernel_ms": cuda_ms(lambda: fm.flash_bwd_cuda(q, k, v, mask, o, lse, do), 10),
               "dq_ms": cuda_ms(lambda: fm.flash_bwd_dq_cuda(*args), 10),
               "dkv_ms": cuda_ms(lambda: fm.flash_bwd_dkv_cuda(*args), 10),
               "plain_ms": cuda_ms(
                   lambda: fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do), 3),
               "library_ms": library["all"], "bound_ms": bound_ms, "bound_by": bound_by}
        if (b, l, dtype) == (24, 512, bf16):
            # Per kernel, at the training cell and its padded twin: its own
            # plain version, the SDPA backward of just its outputs, and its
            # own bound over this run's valid keys.
            row["dq"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dq_reference(*args), 3),
                         "library_ms": library["q"],
                         **dict(zip(("bound_ms", "bound_by"),
                                    bwd_bound(b, l, h, d, keys, esize, fp32, 3, 5, 2)))}
            row["dkv"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dkv_reference(*args), 3),
                          "library_ms": library["kv"],
                          **dict(zip(("bound_ms", "bound_by"),
                                     bwd_bound(b, l, h, d, keys, esize, fp32, 4, 6, 2)))}
            if not pad:
                main_row = row
        emit(row)
        for key in max_err:
            max_err[key] = max(max_err[key], err[key])
    ring_err = {"dq": 0.0, "dkv": 0.0}
    for b, l, h, d in RING_SHAPES:
        (q, k, v, do), _, mask = _masked_inputs(torch, gen, b, l, h, d, bf16, 4, True)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        dlse = torch.randn(lse.shape, device="cuda", generator=gen)
        err = _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, (b, l, h, d), bf16, b > 1)
        for key in ring_err:
            ring_err[key] = max(ring_err[key], err[key])
    emit({"phase": "kernel_bwd", "ring_shapes": len(RING_SHAPES),
          "max_abs_err_dq": ring_err["dq"], "max_abs_err_dkv": ring_err["dkv"]})
    emit({"phase": "kernel_bwd", "source_note_bound": {
        "cell": "B=24, L=512, H=12, D=64, bf16, no padding",
        "dkv_gflop": 8 * 24 * 12 * 512**2 * 64 / 1e9,
        "dkv_bound_ms": bwd_bound(24, 512, 12, 64, [512] * 24, 2, False, 4, 6, 2)[0],
        "dq_bound_ms": bwd_bound(24, 512, 12, 64, [512] * 24, 2, False, 3, 5, 2)[0]}})
    return main_row, {key: max(max_err[key], ring_err[key]) for key in max_err}


def bound(nbytes: float, flops: float, peak_flops: float):
    """Least time on an H100 SXM for ``nbytes`` moved once and ``flops`` at
    ``peak_flops``: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def load_pw_bench():
    """``scripts/torch_pw_bench.py`` as a module: the timers and the shape
    tables that the 1x1 phases share with it."""
    spec = importlib.util.spec_from_file_location(
        "torch_pw_bench", ROOT / "scripts" / "torch_pw_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def pw_tables(pwb) -> tuple[dict, dict, list]:
    """The bench's 1x1 shape tables as (M, K, N): ResNet-50 at 224x224, 128
    images, the units a step that take the generic dgrad and the fused
    backward (29 units, 12 shapes), those that take the N = 64 dgrad (2),
    and the bench's own 9 shapes."""
    r50 = {pwb.mkn(*sh): units for sh, units in pwb.RESNET50.items()}
    n64 = {pwb.mkn(*sh): units for sh, units in pwb.RESNET50_N64.items()}
    return r50, n64, [pwb.mkn(*sh) for group in pwb.SHAPES.values() for sh in group]


# Inception-v3 at 299x299, 128 images, fused=True: the (M, K, N) of the 27
# units that take the fused backward and their launches per step (the four
# C blocks and D on the 17x17 grid, the two E blocks on 8x8, the aux head's
# 1x1 conv on 5x5).
INCEPTION_FUSED_UNITS = {
    (36992, 768, 128): 2, (36992, 768, 160): 4, (36992, 768, 192): 12,
    **{(8192, k, n): 1 for k in (1280, 2048) for n in (192, 320, 384, 448)},
    (3200, 768, 128): 1,
}


# Shapes the 1x1 GEMMs' tiling and copy ring put at risk, checked but not
# timed: M below one tile and M not a multiple of 64, K = N = 8, N not a
# multiple of 64 (a chunk partly zero-filled), fewer output tiles than SMs
# (dgrad at (1000, 256, 128); wgrad's dW tiles at (6272, 512, 2048)), and a
# wgrad that takes one M range (6272, 1024, 2048); each in bf16 and fp32.
PW_RISK_SHAPES = [(17, 256, 128), (25091, 256, 128), (17, 8, 8), (4099, 256, 200),
                  (1000, 256, 128), (6272, 512, 2048), (6272, 1024, 2048)]


def _close(got, ref, fp32: bool, torch) -> tuple[float, bool]:
    """Max |got - ref| and whether every element is within tolerance: fp32
    within 1e-4 (the same products summed in another order); bf16 within
    one bf16 rounding step of the plain value (2^-7 |ref|, both round the
    same f32 sum once) plus 1e-3 for sums near a rounding boundary."""
    diff = (got.float() - ref.float()).abs()
    tol = 1e-4 if fp32 else 2.0**-7 * ref.float().abs() + 1e-3
    return diff.max().item(), bool(torch.all(diff <= tol).item())


def phase_kernel_conv1x1(pc, pwb, torch, r50, n64):
    """The 1x1-conv dgrad kernel (both routes) against its plain version at
    the ResNet-50 shapes (``r50``, ``n64``); the risk shapes checked only."""
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf16, "pw_dgrad", True) for m, k, n in r50]
    cases += [(m, k, n, bf16, "pw_dgrad_n64", True) for m, k, n in n64]
    cases += [(25091, 1024, 256, bf16, "pw_dgrad", True),
              (6275, 512, 256, f32, "pw_dgrad", True)]
    cases += [(m, k, n, dt, "pw_dgrad", False) for m, k, n in PW_RISK_SHAPES for dt in (bf16, f32)]
    rows = {}
    for m, k, n, dtype, route, timed in cases:
        g = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        w = (torch.randn(k, n, device="cuda", generator=gen) * n**-0.5).to(dtype)
        fp32 = dtype == torch.float32
        dx = pc.dgrad_cuda(g, w, route)
        ref = pc.dgrad_reference(g, w)
        torch.cuda.synchronize()
        err, ok = _close(dx, ref, fp32, torch)
        check(ok and torch.isfinite(dx.float()).all().item(),
              f"pw dgrad error {err} at {(m, k, n, dtype)}")
        row = {"phase": "kernel_conv1x1", "route": route, "M": m, "K": k, "N": n,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err}
        if timed:
            esize = g.element_size()
            bound_ms, bound_by = bound(esize * (m * n + k * n + m * k), 2.0 * m * k * n,
                                       PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            row.update({
                "kernel_ms": cuda_ms(lambda: pc.dgrad_cuda(g, w, route), 10),
                "kernel_graph_ms": pwb.graph_ms(lambda: pc.dgrad_cuda(g, w, route), 10, 2),
                "plain_ms": cuda_ms(lambda: pc.dgrad_reference(g, w), 3),
                "library_ms": cuda_ms(lambda: torch.matmul(g, w.t()), 10),
                "library_graph_ms": pwb.graph_ms(lambda: torch.matmul(g, w.t()), 10, 2),
                "bound_ms": bound_ms, "bound_by": bound_by})
            rows[(m, k, n, row["dtype"], route)] = row
        emit(row)
        del g, w, dx, ref
    return rows


def _wgrad_library(torch, x2, g):
    """One PyTorch call computing the wgrad (a yardstick the port never
    calls): an f32-out ``torch.mm`` where this torch's takes ``out_dtype``,
    else the bf16-out ``torch.matmul``; and its label."""
    try:
        torch.mm(x2.t(), g, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no out_dtype in this torch, or not for these
        return ((lambda: torch.matmul(x2.t(), g)),
                f"torch.matmul(x2.t(), g) -> {str(x2.dtype).removeprefix('torch.')}")
    return (lambda: torch.mm(x2.t(), g, out_dtype=torch.float32)), "torch.mm(out_dtype=f32)"


def phase_kernel_wgrad(pc, pwb, torch, shapes):
    """The 1x1-conv wgrad kernel against its plain version at ``shapes``
    (M, K, N): f32 dW from exact products (bf16 x bf16 fits f32) summed
    over M in another order, within 1e-5 of the largest |dW|; the risk
    shapes checked only."""
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf16, True) for m, k, n in shapes]
    cases += [(25091, 1024, 256, bf16, True), (6275, 512, 256, f32, True)]
    cases += [(m, k, n, dt, False) for m, k, n in PW_RISK_SHAPES + [(4099, 64, 256)]
              for dt in (bf16, f32)]
    rows = {}
    for m, k, n, dtype, timed in cases:
        x2 = torch.randn(m, k, device="cuda", dtype=dtype, generator=gen)
        g = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        fp32 = dtype == torch.float32
        dw = pc.wgrad_cuda(x2, g)
        ref = pc.wgrad_reference(x2, g)
        torch.cuda.synchronize()
        err = (dw - ref).abs().max().item()
        check(dw.dtype == torch.float32 and torch.isfinite(dw).all().item()
              and err <= 1e-5 * ref.abs().max().item(),
              f"pw wgrad error {err} (max |dW| {ref.abs().max().item()}) at {(m, k, n, dtype)}")
        rows_per_split = pc.wgrad_rows_per_split(
            m, k, n, torch.cuda.get_device_properties(x2.device).multi_processor_count)
        row = {"phase": "kernel_wgrad", "M": m, "K": k, "N": n,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
               "splits": -(-m // rows_per_split)}
        if timed:
            es = x2.element_size()
            bound_ms, bound_by = bound(es * (m * k + m * n) + 4 * k * n, 2.0 * m * k * n,
                                       PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            library, label = _wgrad_library(torch, x2, g)
            row.update({
                "kernel_ms": cuda_ms(lambda: pc.wgrad_cuda(x2, g), 10),
                "kernel_graph_ms": pwb.graph_ms(lambda: pc.wgrad_cuda(x2, g), 10, 2),
                "plain_ms": cuda_ms(lambda: pc.wgrad_reference(x2, g), 3),
                "library_ms": cuda_ms(library, 10), "library": label,
                "library_graph_ms": pwb.graph_ms(library, 10, 2),
                "bound_ms": bound_ms, "bound_by": bound_by})
            rows[(m, k, n, row["dtype"])] = row
        emit(row)
        del x2, g, dw, ref
    return rows


def phase_pw_bench(torch):
    """``scripts/torch_pw_bench.py --shapes all --check``: the entry point
    that runs the wgrad kernel. Fails on a non-zero exit, a numerics line
    out of tolerance, or launch counters that disagree with the launches
    the script made."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_pw_bench.py"), "--shapes", "all",
         "--check"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.monotonic() - t0
    check(proc.returncode == 0,
          f"torch_pw_bench exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    checks = [ln for ln in lines if ln.get("check") == "numerics"]
    timed = [ln for ln in lines if "kernel" in ln]
    check(len(checks) == 9 and all(c["max_abs_err_dw"] <= 1e-5 * c["range_dw"] for c in checks),
          f"pw_bench numerics: {checks}")
    check(len(timed) == 18, f"pw_bench timed {len(timed)} rows, expected 9 shapes x 2 kernels")
    counts = lines[-1]
    check(counts["launches"] == counts["made"] and counts["launches"]["pw_wgrad"] > 0,
          f"pw_bench launches {counts}")
    for row in timed:
        emit({"phase": "pw_bench", **row})
    emit({"phase": "pw_bench", "seconds": seconds, **counts,
          "max_abs_err_dw": max(c["max_abs_err_dw"] for c in checks)})
    return counts["launches"], [r for r in timed if r["kernel"] == "pw_wgrad"]


def phase_kernel_bn_bwd(fcb, torch, cases, cell: str):
    """The fused conv+BN backward kernels (reduce, apply dx, apply dW)
    against their plain versions; ``cases`` are (M, K, N, dtype, relus)."""
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    rows = {}
    for m, k, n, dtype, relus in cases:
        fp32 = dtype == torch.float32
        x = torch.randn(m, k, device="cuda", dtype=dtype, generator=gen)
        w = (torch.randn(k, n, device="cuda", generator=gen) * k**-0.5).to(dtype)
        z = torch.matmul(x, w)
        da = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        zf = z.float()
        mean = zf.mean(0)
        inv = torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5)
        gamma = torch.rand(n, device="cuda", generator=gen) + 0.5
        beta = torch.randn(n, device="cuda", generator=gen) * 0.5
        errs = {"reduce": 0.0, "dx": 0.0, "dw": 0.0}
        for relu in relus:
            c0 = fcb._pack_consts(mean, inv, gamma, beta)
            s1, s2 = fcb.bn_bwd_reduce_cuda(da, z, c0, relu)
            r1, r2 = fcb.bn_bwd_reduce_reference(da, z, c0, relu)
            # f32 sums of up to 401408 terms in two orders: within 1e-5 of
            # the sum of the terms' magnitudes.
            g, xh = fcb._g_xhat(da, z, c0, relu)
            for got, ref, mag in ((s1, r1, g.abs().sum(0)), (s2, r2, (g * xh).abs().sum(0))):
                e = (got - ref).abs()
                check(torch.all(e <= 1e-5 * mag + 1e-6).item(),
                      f"bn reduce error {e.max().item()} at {(m, k, n, dtype, relu)}")
                errs["reduce"] = max(errs["reduce"], e.max().item())
            del g, xh
            consts = fcb._pack_consts(mean, inv, gamma, beta, r1 / m, r2 / m)
            dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
            rdx = fcb.bn_bwd_apply_dx_reference(da, z, w, consts, relu)
            err, ok = _close(dx, rdx, fp32, torch)
            check(ok, f"bn apply dx error {err} at {(m, k, n, dtype, relu)}")
            errs["dx"] = max(errs["dx"], err)
            dw = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
            rdw = fcb.bn_bwd_apply_dw_reference(da, z, x, consts, relu)
            torch.cuda.synchronize()
            # Exact products (bf16 x bf16 fits f32), f32 sums over M in two
            # orders: within 1e-5 of the largest |dW|.
            e = (dw - rdw).abs().max().item()
            check(e <= 1e-5 * rdw.abs().max().item() + 1e-5,
                  f"bn apply dW error {e} at {(m, k, n, dtype, relu)}")
            errs["dw"] = max(errs["dw"], e)
        del dx, rdx, dw, rdw
        es = x.element_size()
        peak = PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS
        c0 = fcb._pack_consts(mean, inv, gamma, beta)
        # Elementwise work (x_hat, mask, products, sums: ~8 f32 operations
        # per element) at the fp32 rate; the products at the tensor rate.
        ew = 8.0 * m * n / PEAK_FP32_FLOPS * peak
        row = {"phase": "kernel_bn_bwd", "cell": cell, "M": m, "K": k, "N": n,
               "dtype": str(dtype).removeprefix("torch."),
               "max_abs_err": errs,
               "reduce_ms": cuda_ms(lambda: fcb.bn_bwd_reduce_cuda(da, z, c0, True), 10),
               "reduce_plain_ms": cuda_ms(lambda: fcb.bn_bwd_reduce_reference(da, z, c0, True), 3),
               "dx_ms": cuda_ms(lambda: fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, True), 10),
               "dx_plain_ms": cuda_ms(
                   lambda: fcb.bn_bwd_apply_dx_reference(da, z, w, consts, True), 3),
               "dw_ms": cuda_ms(lambda: fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, True), 10),
               "dw_plain_ms": cuda_ms(
                   lambda: fcb.bn_bwd_apply_dw_reference(da, z, x, consts, True), 3),
               "library_ms": None}
        for key, nbytes, flops in (
                ("reduce", 2 * m * n * es + 8 * n, ew),
                ("dx", (2 * m * n + k * n + m * k) * es, 2.0 * m * k * n + ew),
                ("dw", (2 * m * n + m * k) * es + 4 * k * n, 2.0 * m * k * n + ew)):
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound(nbytes, flops, peak)
        emit(row)
        rows[(m, k, n, row["dtype"])] = row
        del x, w, z, da, zf
    return rows


def _grads(model, batch, torch):
    from distributed_tensorflow_tpu_torch.models.bert import make_bert_pretraining_loss

    params = dict(model.named_parameters())
    loss, _ = make_bert_pretraining_loss(model)(params, {}, batch, None)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def phase_train(fm, torch):
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
        make_bert_pretraining_loss,
    )
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )

    rows, seq = 24, 512
    cfg = BertConfig(dtype=torch.bfloat16)  # 512 positions, dropout 0.1
    model = BertForPreTraining(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(SEED))
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=cfg.vocab_size, seq_len=seq, seed=SEED))
    stream = mlm_device_batches(data, rows, device="cuda", seed=1)

    # (c) Dropout off, the same params and batch: the kernels' gradients
    # against plain attention's, leaf by leaf (relative L2 error).
    batch0 = next(stream)
    grads = {}
    for impl in ("flash", "dense"):
        twin = BertForPreTraining(dataclasses.replace(cfg, dropout_rate=0.0, attn_impl=impl),
                                  device="cuda")
        twin.load_state_dict(model.state_dict())
        grads[impl] = _grads(twin, batch0, torch)
        del twin
    # Relative L2 error per leaf, against a floor of 1e-3 of the whole
    # gradient's norm: the key biases' exact gradient is zero (softmax is
    # invariant to shifting a row's scores), so both paths give noise there.
    total = torch.linalg.vector_norm(
        torch.stack([g.float().norm() for g in grads["dense"].values()])).item()
    diff = torch.linalg.vector_norm(torch.stack(
        [(g - grads["dense"][n]).float().norm() for n, g in grads["flash"].items()])).item()
    rel = {name: ((g - grads["dense"][name]).float().norm().item()
                  / max(grads["dense"][name].float().norm().item(), 1e-3 * total))
           for name, g in grads["flash"].items()}
    worst = sorted(rel, key=rel.get)[-3:]
    median = statistics.median(rel.values())
    del grads
    torch.cuda.empty_cache()
    emit({"phase": "train_grad_check", "leaves": len(rel), "rel_l2_err_total": diff / total,
          "median_rel_l2_err": median, "worst_leaves": {n: rel[n] for n in worst}})
    check(diff / total <= 2e-2 and median <= 2e-2 and rel[worst[-1]] <= 0.25,
          f"kernel gradients differ from plain attention's: total {diff / total}, "
          f"median leaf {median}, worst {worst[-1]} {rel[worst[-1]]}")

    # Host cost of one batch of the feed (numpy generation + copy to the card).
    probe = mlm_device_batches(data, rows, device="cuda", seed=3)
    t0 = time.perf_counter()
    for _ in range(3):
        next(probe)
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3 / 3

    recipe = dataclasses.replace(PRESETS["bert_base"], lr_schedule="constant", learning_rate=1e-4)
    tx, _ = _make_tx(recipe)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(make_bert_pretraining_loss(model), tx, clip_norm=recipe.clip_norm)
    rng = make_rng(SEED, "cuda")
    batches = prefetch(stream, 2)
    log = []
    hook = lambda s, st, m: log.append(  # noqa: E731
        (time.perf_counter(), m["loss"], m["host_wait_ms"]))
    try:
        # (a), (b) and the per-step time: the main path, synchronised at
        # every step by the loss fetch (log_every=1).
        n_steps = 12
        fm.reset_launch_counts()
        state, _ = fit(state, step, batches, num_steps=n_steps, rng=rng, log_every=1,
                       hooks=(hook,))
        torch.cuda.synchronize()
        launches = dict(fm.LAUNCHES)
        losses = [entry[1] for entry in log]
        host_wait_ms = statistics.median(entry[2] for entry in log[1:])
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"losses {losses}")
        for name, n in launches.items():
            check(n == 12 * n_steps, f"{name}: {n} launches in {n_steps} steps, expected 12 per step")
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        # A window with no per-step sync: fit's steady-state rate.
        window = 10
        state, last = fit(state, step, batches, num_steps=state.step + window, rng=rng,
                          log_every=window)
        torch.cuda.synchronize()
        free_ms = 1e3 / last["steps_per_sec"]
    finally:
        batches.close()

    # (d) One fixed batch, constant lr 1e-4: the loss falls over 10 steps.
    log.clear()
    fixed = next(mlm_device_batches(data, rows, device="cuda", seed=2))
    state, _ = fit(state, step, itertools.repeat(fixed), num_steps=state.step + 10, rng=rng,
                   log_every=1, hooks=(hook,))
    fixed_losses = [entry[1] for entry in log]
    check(fixed_losses[-1] < fixed_losses[0], f"fixed-batch losses did not fall: {fixed_losses}")

    tokens = rows * seq
    flops = train_flops_per_token(cfg, seq) * tokens
    median_ms = statistics.median(step_ms)
    emit({"phase": "train", "rows": rows, "L": seq, "steps": n_steps, "launches": launches,
          "losses": losses, "fixed_batch_losses": fixed_losses,
          "step_ms_median": median_ms, "step_ms_min": min(step_ms),
          "step_ms_unsynced": free_ms, "host_wait_ms_median": host_wait_ms,
          "feed_ms_per_batch": feed_ms,
          "tokens_per_s": tokens / (median_ms / 1e3),
          "tflop_per_step": flops / 1e12,
          "mfu": flops / (median_ms / 1e3) / PEAK_BF16_FLOPS,
          "mfu_unsynced": flops / (free_ms / 1e3) / PEAK_BF16_FLOPS,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


# Launches per ResNet-50 training step of each kernel under each backend.
RESNET50_LAUNCHES = {
    "conv": {},
    "pallas": {"pw_dgrad": 29, "pw_dgrad_n64": 2},
    "fused": {"bn_bwd_reduce": 29, "bn_bwd_apply_dx": 29, "bn_bwd_apply_dw": 29},
}


def _rel_errors(got: dict, ref: dict, torch):
    """Relative L2 error of a dict of tensors against a reference: over the
    whole dict, and per entry against a floor of 1e-3 of the whole
    reference's norm (entries whose exact value is near zero)."""
    total = torch.linalg.vector_norm(torch.stack([r.float().norm() for r in ref.values()])).item()
    diff = torch.linalg.vector_norm(torch.stack(
        [(got[n].float() - r.float()).norm() for n, r in ref.items()])).item()
    per = {n: (got[n].float() - r.float()).norm().item() / max(r.float().norm().item(), 1e-3 * total)
           for n, r in ref.items()}
    return diff / total, per


def phase_train_resnet50(pc, fcb, torch):
    """ResNet-50 training on the card under each 1x1 backend."""
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )

    from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image

    rows, hw, n_steps = 128, 224, 10
    recipe = dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                                 learning_rate=0.1, momentum=0.9, optimizer="sgd")
    t0 = time.monotonic()
    data = synthetic_image_classification(4 * rows, (hw, hw, 3), 1000, seed=SEED)
    data_s = time.monotonic() - t0
    flops = train_flops_per_image(ResNet50(device="cuda"), (hw, hw, 3)) * rows

    def build(backend):
        model = ResNet50(dtype=torch.bfloat16, pw_backend=backend, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(SEED))
        params, model_state = init_model(model)
        tx, _ = _make_tx(recipe)
        state = create_train_state(params, tx, model_state)
        return model, state, make_train_step(make_classification_loss(model), tx)

    def reset():
        pc.reset_launch_counts()
        fcb.reset_launch_counts()

    def counts():
        return {**pc.LAUNCHES, **fcb.LAUNCHES}

    launches, results, trained = {}, {}, None
    for backend in ("conv", "pallas", "fused"):
        model, state, step = build(backend)
        log = []
        hook = lambda s, st, m: log.append((time.perf_counter(), m["loss"]))  # noqa: E731
        batches = prefetch(device_batches(data, rows, device="cuda", seed=1), 2)
        torch.cuda.reset_peak_memory_stats()
        try:
            # The main path, synchronised at every step by the loss fetch.
            reset()
            state, _ = fit(state, step, batches, num_steps=n_steps, rng=make_rng(SEED, "cuda"),
                           log_every=1, hooks=(hook,))
            torch.cuda.synchronize()
            got = counts()
        finally:
            batches.close()
        losses = [entry[1] for entry in log]
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"{backend} losses {losses}")
        want = {k: v * n_steps for k, v in RESNET50_LAUNCHES[backend].items()}
        check({k: v for k, v in got.items() if v} == want,
              f"{backend}: launches {got} in {n_steps} steps, expected {want}")
        launches[backend] = got
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        med = statistics.median(step_ms)
        results[backend] = {
            "losses": losses, "step_ms_median": med, "step_ms_min": min(step_ms),
            "images_per_s": rows / (med / 1e3), "mfu": flops / (med / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": got}
        emit({"phase": "train_resnet50", "backend": backend, "rows": rows, "image": hw,
              "steps": n_steps, **results[backend]})
        if backend == "conv":
            trained = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                       {k: v.clone() for k, v in state.model_state["batch_stats"].items()})
        if backend == "fused":
            # One fixed batch, lr 0.1 with momentum: the loss falls in 10 steps.
            log.clear()
            fixed = next(device_batches(data, rows, device="cuda", seed=2))
            state, _ = fit(state, step, itertools.repeat(fixed), num_steps=state.step + 10,
                           rng=make_rng(SEED, "cuda"), log_every=1, hooks=(hook,))
            fixed_losses = [entry[1] for entry in log]
            emit({"phase": "train_resnet50_fixed_batch", "backend": backend,
                  "losses": fixed_losses})
            check(fixed_losses[-1] < fixed_losses[0], f"fixed-batch losses {fixed_losses}")
        del model, state, step
        torch.cuda.empty_cache()

    # The same params (the conv run's, after its steps: every block's
    # zero-initialised final BN scale has moved, so every leaf has a
    # gradient), batch_stats and batch through each backend.
    batch = next(device_batches(data, rows, device="cuda", seed=3))
    grads, stats = {}, {}
    for backend in ("conv", "pallas", "fused"):
        model = ResNet50(dtype=torch.bfloat16, pw_backend=backend, device="cuda")
        model.load_state_dict(trained[0])
        params = dict(model.named_parameters())
        loss, (new_state, _) = make_classification_loss(model)(
            params, {"batch_stats": trained[1]}, batch, None)
        grads[backend] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        stats[backend] = new_state["batch_stats"]
        del model, params, loss
    for backend in ("pallas", "fused"):
        total, per = _rel_errors(grads[backend], grads["conv"], torch)
        stat_total, _ = _rel_errors(stats[backend], stats["conv"], torch)
        worst = max(per, key=per.get)
        median = statistics.median(per.values())
        emit({"phase": "train_resnet50_grad_check", "backend": backend, "leaves": len(per),
              "rel_l2_err_total": total, "median_rel_l2_err": median,
              "worst_leaf": {worst: per[worst]}, "batch_stats_rel_l2_err": stat_total})
        # bf16 activations round at other places on each path (the fused
        # unit's dz and dW round to bf16, the conv path's BN backward runs
        # in f32 and its dgrad in cuDNN), through 53 BatchNorms.
        check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5,
              f"{backend} gradients differ from conv's: total {total}, median {median}, "
              f"worst {worst} {per[worst]}")
        check(stat_total <= 1e-2, f"{backend} batch_stats differ from conv's: {stat_total}")
    del grads, stats, trained
    torch.cuda.empty_cache()
    emit({"phase": "train_resnet50_setup", "data_seconds": data_s,
          "train_gflop_per_image": flops / rows / 1e9})
    return launches, results


def phase_train_inception(fcb, pc, torch):
    """Inception-v3 training on the card, plain and fused, under the
    ``imagenet_inception_async`` recipe (K = 4 stale gradients)."""
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import InceptionV3
    from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )

    # 128 images per card: bench.py's per-card batch for ResNet-50.
    rows, hw, n_steps = 128, 299, 8
    recipe = dataclasses.replace(PRESETS["imagenet_inception_async"], lr_schedule="constant")
    k = recipe.staleness
    t0 = time.monotonic()
    data = synthetic_image_classification(2 * rows, (hw, hw, 3), 1000, seed=SEED)
    data_s = time.monotonic() - t0
    flops = train_flops_per_image(InceptionV3(device="cuda"), (hw, hw, 3)) * rows
    per_step = {"bn_bwd_reduce": 27, "bn_bwd_apply_dx": 27, "bn_bwd_apply_dw": 27}
    check(sum(INCEPTION_FUSED_UNITS.values()) == 27, "Inception's fused units")

    def build(fused, dropout_rate=0.5):
        model = InceptionV3(dtype=torch.bfloat16, fused=fused, dropout_rate=dropout_rate,
                            device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
        params, model_state = init_model(model)
        tx, _ = _make_tx(recipe)
        state = create_train_state(params, tx, model_state, staleness=k)
        step = make_train_step(make_classification_loss(model), tx, mode="stale", staleness=k)
        return model, state, step

    def counts():
        return {**pc.LAUNCHES, **fcb.LAUNCHES}

    launches, results, trained = {}, {}, None
    for fused in (False, True):
        model, state, step = build(fused)
        log = []
        hook = lambda s, st, m: log.append((time.perf_counter(), m["loss"]))  # noqa: E731
        batches = prefetch(device_batches(data, rows, device="cuda", seed=1), 2)
        torch.cuda.reset_peak_memory_stats()
        try:
            # The main path, synchronised at every step by the loss fetch.
            pc.reset_launch_counts()
            fcb.reset_launch_counts()
            state, _ = fit(state, step, batches, num_steps=n_steps, rng=make_rng(SEED, "cuda"),
                           log_every=1, hooks=(hook,))
            torch.cuda.synchronize()
            got = counts()
        finally:
            batches.close()
        name = "fused" if fused else "plain"
        losses = [entry[1] for entry in log]
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"{name} losses {losses}")
        want = {kk: v * n_steps for kk, v in per_step.items()} if fused else {}
        check({kk: v for kk, v in got.items() if v} == want,
              f"inception {name}: launches {got} in {n_steps} steps, expected {want}")
        launches[name] = got
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        med = statistics.median(step_ms)
        results[name] = {
            "losses": losses, "step_ms_median": med, "step_ms_min": min(step_ms),
            "images_per_s": rows / (med / 1e3), "mfu": flops / (med / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": got}
        emit({"phase": "train_inception", "fused": fused, "rows": rows, "image": hw,
              "staleness": k, "steps": n_steps, **results[name]})
        if not fused:
            trained = ({kk: v.detach().clone() for kk, v in model.state_dict().items()},
                       {kk: v.clone() for kk, v in state.model_state["batch_stats"].items()})
        else:
            # One fixed batch under K = 4 staleness from a fresh ring: the
            # first 4 steps apply the zero ring, then the loss falls.
            tx, _ = _make_tx(recipe)
            state = create_train_state(dict(model.named_parameters()), tx, state.model_state,
                                       staleness=k)
            log.clear()
            fixed = next(device_batches(data, rows, device="cuda", seed=2))
            state, _ = fit(state, step, itertools.repeat(fixed), num_steps=14,
                           rng=make_rng(SEED, "cuda"), log_every=1, hooks=(hook,))
            fixed_losses = [entry[1] for entry in log]
            emit({"phase": "train_inception_fixed_batch", "fused": fused, "staleness": k,
                  "losses": fixed_losses})
            check(len(fixed_losses) == 14 and fixed_losses[-1] < fixed_losses[0],
                  f"fixed-batch losses under staleness {k}: {fixed_losses}")
        del model, state, step
        torch.cuda.empty_cache()

    # The same params (the plain run's, after its steps), batch_stats and
    # batch, dropout off, no stale ring: fused gradients against plain ones.
    batch = next(device_batches(data, rows, device="cuda", seed=3))
    grads, stats = {}, {}
    for fused in (False, True):
        model = InceptionV3(dtype=torch.bfloat16, fused=fused, dropout_rate=0.0, device="cuda")
        model.load_state_dict(trained[0])
        params = dict(model.named_parameters())
        loss, (new_state, _) = make_classification_loss(model)(
            params, {"batch_stats": trained[1]}, batch, None)
        grads[fused] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        stats[fused] = new_state["batch_stats"]
        del model, params, loss
    total, per = _rel_errors(grads[True], grads[False], torch)
    stat_total, _ = _rel_errors(stats[True], stats[False], torch)
    worst = max(per, key=per.get)
    median = statistics.median(per.values())
    emit({"phase": "train_inception_grad_check", "leaves": len(per),
          "rel_l2_err_total": total, "median_rel_l2_err": median,
          "worst_leaf": {worst: per[worst]}, "batch_stats_rel_l2_err": stat_total})
    # bf16 activations, dz and dW round at other places on the two paths,
    # through 95 BatchNorms (ResNet-50's tolerances).
    check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5,
          f"fused gradients differ from plain ones: total {total}, median {median}, "
          f"worst {worst} {per[worst]}")
    check(stat_total <= 1e-2, f"fused batch_stats differ from plain ones: {stat_total}")
    del grads, stats, trained
    torch.cuda.empty_cache()
    emit({"phase": "train_inception_setup", "data_seconds": data_s,
          "train_gflop_per_image": flops / rows / 1e9})
    return launches, results


def phase_train_cli_inception(torch):
    """``cli.train --config imagenet_inception_async`` at 75x75 for 3 steps
    with a checkpoint, then a ``Checkpointer`` restore of the step, the
    stale ring and every BatchNorm running average, on the card."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import InceptionV3
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    ckpt_dir = ROOT / "build" / "chip_smoke_inception"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "imagenet_inception_async", "--image-size", "75", "--global-batch", "16",
         "--steps", "3", "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln and "staleness=4" in ln for ln in steps),
          f"log: {steps}")
    preset = PRESETS["imagenet_inception_async"]
    model = InceptionV3(dtype=torch.bfloat16, aux_logits=False, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(preset)
    state = create_train_state(params, tx, model_state, staleness=preset.staleness)
    state, step = Checkpointer(ckpt_dir).restore_latest(state)
    stats = state.model_state["batch_stats"]
    ring = state.grad_buffer
    check(step == 3 and state.step == 3 and state.buffer_index == 3, f"restored step {step}")
    check(ring.keys() == params.keys()
          and all(v.is_cuda and v.shape[0] == preset.staleness for v in ring.values())
          and any(torch.any(v[:3] != 0).item() for v in ring.values()),
          "restored stale ring")
    check(stats.keys() == model_state["batch_stats"].keys()
          and all(t.is_cuda and torch.isfinite(t).all().item() for t in stats.values()),
          "restored batch_stats")
    moved = sum(int(not torch.equal(stats[kk], model_state["batch_stats"][kk])) for kk in stats)
    check(moved == len(stats), f"only {moved} of {len(stats)} running averages moved")
    emit({"phase": "train_cli_inception", "seconds": seconds,
          "last_log": steps[-1].split(": ", 1)[-1], "restored_step": step,
          "ring_depth": preset.staleness, "batch_stats": len(stats)})


def phase_train_cli_image(torch):
    """``cli.train --config imagenet_resnet50`` at 64x64 for 3 steps with a
    checkpoint, then a ``Checkpointer`` restore of step and batch_stats."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    ckpt_dir = ROOT / "build" / "chip_smoke_image"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "imagenet_resnet50", "--image-size", "64", "--global-batch", "16",
         "--steps", "3", "--lr", "0.05", "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(PRESETS["imagenet_resnet50"])
    state = create_train_state(params, tx, model_state)
    state, step = Checkpointer(ckpt_dir).restore_latest(state)
    stats = state.model_state["batch_stats"]
    check(step == 3 and state.step == 3, f"restored step {step}")
    check(stats.keys() == model_state["batch_stats"].keys()
          and all(t.is_cuda and torch.isfinite(t).all().item() for t in stats.values()),
          "restored batch_stats")
    moved = sum(int(not torch.equal(stats[k], model_state["batch_stats"][k])) for k in stats)
    check(moved == len(stats), f"only {moved} of {len(stats)} running averages moved")
    emit({"phase": "train_cli_image", "seconds": seconds, "last_log": steps[-1].split(": ", 1)[-1],
          "restored_step": step, "batch_stats": len(stats)})


def _payloads(vocab: int):
    rng = np.random.default_rng(SEED)
    lengths = ([int(x) for x in rng.integers(64, 129, 8)]
               + [int(x) for x in rng.integers(129, 257, 8)]
               + [int(x) for x in rng.integers(257, 513, 8)])
    out = []
    for i, n in enumerate(lengths):
        ids = rng.integers(5, vocab, size=n)
        tgt = ids.copy() if i % 2 == 0 else np.where(rng.random(n) < 0.15, ids, -1)
        tgt[0] = ids[0]  # every request is scored
        out.append({"input_ids": ids, "mlm_targets": tgt})
    return out


def _reference(ref_model, payload, bucket, torch):
    """One request through the plain-attention model, padded like the engine."""
    n = len(payload["input_ids"])
    ids = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    ids[0, :n] = torch.as_tensor(payload["input_ids"], dtype=torch.int32)
    mask = torch.zeros((1, bucket), dtype=torch.bool, device="cuda")
    mask[0, :n] = True
    logits, _, _ = ref_model.serve_outputs(ids, mask, torch.zeros_like(ids))
    logits = logits[0, :n].float()
    tgt = torch.as_tensor(payload["mlm_targets"], device="cuda").long()
    logp = torch.log_softmax(logits, dim=-1)
    w = (tgt >= 0).float()
    score = (logp.gather(-1, tgt.clamp_min(0)[:, None])[:, 0] * w).sum() / w.sum()
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(-1).cpu().numpy(), float(score), (top2[:, 0] - top2[:, 1]).cpu().numpy()


def phase_serve(fm, torch):
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        BertInferenceEngine,
        Client,
        build_http_server,
    )

    cfg = BertConfig(dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = BertForPreTraining(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(SEED))
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    ckpt.save(ckpt_dir, 0, model.state_dict())
    params, _, step = ckpt.restore_serving_state(ckpt_dir)
    engine = BertInferenceEngine(model, params, "cuda", buckets=(128, 256, 512),
                                 max_batch=8, batch_tiers=(1, 2, 4, 8))
    grid = engine.grid_status()
    check(grid["warm_fraction"] == 1.0 and grid["cells_total"] == 12, f"grid {grid}")
    emit({"phase": "serve_setup", "seconds": round(time.monotonic() - t0, 3),
          "params": sum(t.numel() for t in params.values()), "ckpt_step": step,
          "warm_cells": grid["cells_compiled"],
          "warm_seconds_total": round(grid["compile_seconds_total"], 3)})

    payloads = _payloads(cfg.vocab_size)
    with Client(engine, BatcherConfig(max_batch=8, max_delay_ms=20.0,
                                      bucket_queues=True)) as client:
        fm.reset_launch_counts()
        t0 = time.monotonic()
        futs = [client.submit(p) for p in payloads]
        results = [f.result(timeout=300) for f in futs]
        wall = time.monotonic() - t0
        launches = fm.LAUNCHES["flash_fwd"]
        hits = {int(k): v for k, v in client.metrics.bucket_hits.snapshot().items()}
        emit({"phase": "serve", "requests": len(results), "seconds": wall,
              "bucket_hits": hits, "flash_launches": launches})
        check(set(hits) == {128, 256, 512}, f"all three buckets must run, got {hits}")
        check(launches == 12 * (hits[256] + hits[512]),
              f"{launches} launches for {hits}: expected 12 per forward at 256/512")

        # Answers: shapes, finiteness, and agreement with plain attention.
        ref_model = BertForPreTraining(dataclasses.replace(cfg, attn_impl="dense"),
                                       device="cuda")
        ref_model.load_state_dict(params)
        agree = total = 0
        confident_miss = 0
        score_err = 0.0
        with torch.inference_mode():
            for p, r in zip(payloads, results):
                n = len(p["input_ids"])
                check(r["pred_ids"].shape == (n,), "pred_ids shape")
                check(r["embedding"].shape == (cfg.hidden_size,)
                      and np.isfinite(r["embedding"]).all(), "embedding")
                check(abs(float(np.sum(r["nsp_probs"])) - 1.0) < 1e-3, "nsp_probs")
                check(r["score"] is not None and np.isfinite(r["score"]), "score")
                pred, score, margin = _reference(ref_model, p, r["bucket"], torch)
                same = pred == r["pred_ids"]
                agree += int(same.sum())
                total += n
                confident_miss += int((~same & (margin > 0.125)).sum())
                score_err = max(score_err, abs(score - r["score"]))
        emit({"phase": "serve_check", "pred_agreement": agree / total,
              "confident_mismatches": confident_miss, "max_score_err": score_err})
        # bf16 logits round in steps of 1/64 near |logit| ~ 2: argmax may
        # flip where the plain model's top two are closer than 1/8.
        check(agree / total >= 0.95, f"pred_ids agree on {agree}/{total}")
        check(confident_miss == 0, f"{confident_miss} mismatches with margin > 0.125")
        check(score_err <= 0.05, f"score differs by {score_err}")

        server = build_http_server(client, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://{}:{}".format(*server.server_address)
            body = json.dumps({"input_ids": payloads[-1]["input_ids"].tolist()}).encode()
            req = urllib.request.Request(base + "/v1/mlm", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                check(resp.status == 200, f"/v1/mlm status {resp.status}")
                out = json.loads(resp.read())
            check(len(out["pred_ids"]) == len(payloads[-1]["input_ids"]), "http pred_ids")
            with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
                check(resp.status == 200, "healthz")
            emit({"phase": "http", "route": "/v1/mlm", "status": 200,
                  "bucket": out["bucket"], "phases_ms": out.get("phases")})
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    for bucket in engine.buckets:
        for tier in (1, 8):
            batch = [{"input_ids": np.full(bucket, 7)} for _ in range(tier)]
            engine.run_batch(batch)
            times = []
            for _ in range(5):
                t0 = time.monotonic()
                engine.run_batch(batch)
                times.append((time.monotonic() - t0) * 1e3)
            emit({"phase": "latency", "bucket": bucket, "tier": tier,
                  "ms_p50": float(np.median(times)), "ms_min": min(times)})
    return launches


def phase_train_cli(torch):
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "bert_base", "--steps", "3", "--global-batch", "32",
         "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    params, _, step = restore_serving_state(ckpt_dir)
    check(step == 3, f"restored step {step}")
    cfg = BertConfig(max_position=128, dropout_rate=0.1, dtype=torch.bfloat16)
    engine = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"), params, "cuda",
                                 buckets=(128,), max_batch=1, batch_tiers=(1,))
    ids = np.random.default_rng(SEED).integers(5, cfg.vocab_size, size=64)
    out = engine.run_batch([{"input_ids": ids, "mlm_targets": ids}])[0]
    check(out["pred_ids"].shape == (64,) and np.isfinite(out["embedding"]).all(),
          "served answer from the trained checkpoint")
    emit({"phase": "train_cli", "seconds": seconds, "last_log": steps[-1].split(": ", 1)[-1],
          "restored_step": step, "served_tokens": int(out["pred_ids"].shape[0]),
          "score": out["score"]})


def _step_record(rows: list, counts: list, field: str) -> dict:
    """One kernel's times per ResNet-50 training step: each shape's row
    (``rows``, one per shape) weighted by its launches per step
    (``counts``). ``field`` prefixes the row's keys (``""`` for the dgrad
    rows' ``kernel_ms``)."""
    def total(key):
        return sum(n * r[key] for r, n in zip(rows, counts))

    widest = max(rows, key=lambda r: r[f"{field}bound_ms"])
    return {"ms": total(f"{field}ms" if field else "kernel_ms"),
            "plain_ms": total(f"{field}plain_ms"), "bound_ms": total(f"{field}bound_ms"),
            "bound_by": widest[f"{field}bound_by"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # The plain versions' f32 products stay full f32 (no TF32), and so do
    # the f32 convolutions of any reference run here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")
    pc = importlib.import_module("distributed_tensorflow_tpu_torch.ops.pointwise_conv")
    fcb = importlib.import_module("distributed_tensorflow_tpu_torch.ops.fused_conv_bn")
    pwb = load_pw_bench()
    r50, n64, bench_shapes = pw_tables(pwb)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    t_start = time.monotonic()
    try:
        occupancy = phase_build(fm, pc, fcb)
        fwd_row, fwd_err = phase_kernel(fm, torch)
        bwd_row, bwd_err = phase_kernel_bwd(fm, torch)
        pw_rows = phase_kernel_conv1x1(pc, pwb, torch, r50, n64)
        wgrad_rows = phase_kernel_wgrad(pc, pwb, torch,
                                        list(dict.fromkeys([*r50, *n64, *bench_shapes])))
        bf16 = torch.bfloat16
        bn_rows = phase_kernel_bn_bwd(
            fcb, torch, [(m, k, n, bf16, (True, False)) for m, k, n in r50]
            + [(25091, 1024, 256, bf16, (True, False)),
               (6275, 512, 256, torch.float32, (True, False))], "resnet50")
        inception_bn_rows = phase_kernel_bn_bwd(
            fcb, torch, [(m, k, n, bf16, (True,)) for m, k, n in INCEPTION_FUSED_UNITS]
            + [(36992, 768, 160, torch.float32, (True,))], "inception_v3")
        torch.cuda.empty_cache()
        bench_launches, bench_rows = phase_pw_bench(torch)
        phase_serve(fm, torch)
        torch.cuda.empty_cache()
        launches = phase_train(fm, torch)
        torch.cuda.empty_cache()
        image_launches, _ = phase_train_resnet50(pc, fcb, torch)
        torch.cuda.empty_cache()
        inception_launches, _ = phase_train_inception(fcb, pc, torch)
        torch.cuda.empty_cache()
        phase_train_cli(torch)
        phase_train_cli_image(torch)
        phase_train_cli_inception(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.monotonic() - t_start:.1f} s",
          file=sys.stderr)
    print(smi[0] if smi else "nvidia-smi: no output")
    src = "distributed_tensorflow_tpu_torch/csrc/"
    ref = "distributed_tensorflow_tpu/ops/flash_attention.py:"
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": ref + "396", "launches": launches["flash_fwd"], "max_abs_err": fwd_err,
        "ms": fwd_row["kernel_ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        "blocks_per_sm": {tile: occupancy[f"flash_fwd_{tile}"]["blocks_per_sm"]
                          for tile in ("q64", "q128")},
    }]
    for name, key, line in (("flash_bwd_dq", "dq", "490"), ("flash_bwd_dkv", "dkv", "559")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
            "replaces": ref + line, "launches": launches[name], "max_abs_err": bwd_err[key],
            "ms": bwd_row[f"{key}_ms"], "plain_ms": bwd_row[key]["plain_ms"],
            "bound_ms": bwd_row[key]["bound_ms"], "bound_by": bwd_row[key]["bound_by"],
            "library_ms": bwd_row[key]["library_ms"],
            "blocks_per_sm": occupancy[name]["blocks_per_sm"],
        })
    # The 1x1 kernels' numbers are per ResNet-50 step (b=128): each
    # shape's time times its launches per step, summed. ``ms`` and
    # ``library_ms`` are times per call, as every other row's;
    # ``graph_ms`` and ``library_graph_ms`` the device times of the same
    # calls replayed from a CUDA graph.
    cell = "ResNet-50 b=128 224x224, per training step (launches x time, summed)"
    pw_ref = "distributed_tensorflow_tpu/ops/pointwise_conv.py:"
    for name, line, table in (("pw_dgrad", "74", r50), ("pw_dgrad_n64", "202", n64)):
        sel = [pw_rows[(*sh, "bfloat16", name)] for sh in table]
        counts = list(table.values())
        kernels.append({
            "name": name, "route": "cuda", "source": src + "pointwise_conv.cu",
            "replaces": pw_ref + line, "launches": image_launches["pallas"][name],
            "max_abs_err": max(r["max_abs_err"] for r in pw_rows.values()
                               if r["route"] == name),
            **_step_record(sel, counts, ""),
            "library_ms": sum(n * r["library_ms"] for r, n in zip(sel, counts)),
            "graph_ms": sum(n * r["kernel_graph_ms"] for r, n in zip(sel, counts)),
            "library_graph_ms": sum(n * r["library_graph_ms"] for r, n in zip(sel, counts)),
            "cell": cell,
            "blocks_per_sm": occupancy["pw_dgrad"]["blocks_per_sm"],
        })
    bn_ref = "distributed_tensorflow_tpu/ops/fused_conv_bn.py:"
    sel = [bn_rows[(*sh, "bfloat16")] for sh in r50]
    units = list(r50.values())
    for name, part, line in (("bn_bwd_reduce", "reduce", "126"),
                             ("bn_bwd_apply_dx", "dx", "136"),
                             ("bn_bwd_apply_dw", "dw", "136")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "fused_conv_bn.cu",
            "replaces": bn_ref + line, "launches": image_launches["fused"][name],
            "max_abs_err": max(r["max_abs_err"][part] for r in bn_rows.values()),
            **_step_record(sel, units, f"{part}_"), "library_ms": None, "cell": cell,
        })
    # The wgrad's only path is the bench: its 9 shapes, one call each,
    # summed; plain and error from kernel_wgrad at the same shapes.
    sel = [wgrad_rows[(*sh, "bfloat16")] for sh in bench_shapes]
    kernels.append({
        "name": "pw_wgrad", "route": "cuda", "source": src + "pointwise_conv.cu",
        "replaces": pw_ref + "85", "launches": bench_launches["pw_wgrad"],
        "max_abs_err": max(r["max_abs_err"] for r in wgrad_rows.values()),
        "ms": sum(r["ms"] for r in bench_rows),
        "plain_ms": sum(r["plain_ms"] for r in sel),
        "bound_ms": sum(r["bound_ms"] for r in sel),
        "bound_by": max(sel, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": sum(r["library_ms"] for r in bench_rows),
        "library": bench_rows[0]["library"],
        "graph_ms": sum(r["kernel_graph_ms"] for r in sel),
        "library_graph_ms": sum(r["library_graph_ms"] for r in sel),
        "blocks_per_sm": {key.removeprefix("pw_wgrad_"): rec["blocks_per_sm"]
                          for key, rec in occupancy.items() if key.startswith("pw_wgrad_")},
        "cell": "scripts/torch_pw_bench.py --shapes all: 9 ResNet-50 shapes at b=128, "
                "one call each, summed"})
    # Inception-v3's fused units per training step, for PERF.md.
    sel = [inception_bn_rows[(*sh, "bfloat16")] for sh in INCEPTION_FUSED_UNITS]
    counts = list(INCEPTION_FUSED_UNITS.values())
    emit({"phase": "inception_fused_per_step", "launches": inception_launches["fused"],
          **{name: _step_record(sel, counts, f"{part}_")
             for name, part in (("bn_bwd_reduce", "reduce"), ("bn_bwd_apply_dx", "dx"),
                                ("bn_bwd_apply_dw", "dw"))}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
