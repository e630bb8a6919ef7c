#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. build  — compile the port's CUDA kernels from ``csrc/`` (one nvcc per
   source, started together, sm_90a) into ``build/kernels/``; print the
   build seconds and ptxas' resource use.
2. kernel — hold the flash-attention forward kernel to its plain PyTorch
   version on the card: bf16 at B in {1, 8} x L in {256, 512, 300} with
   H=12, D=64, plus D=32, D=128 and an fp32 case; masks with padded and
   fully masked rows. Tolerances: bf16 o within 1e-2 (P rounds to bf16 per
   64-key tile in the kernel, once in the plain version), fp32 o within
   1e-5, lse within 1e-4. Prints kernel/plain/library (SDPA, a yardstick
   the port never calls) times and the card's bound, one JSON line per
   shape.
3. kernel_bwd — hold the backward kernels (dQ, dK/dV) to the plain backward
   on the card, with and without an lse cotangent: bf16 at B in {1, 8, 24}
   x L in {256, 512, 300}, H=12, D=64, plus D=32, D=128 and an fp32 case,
   with padded rows and one fully masked row (which must give exact zero
   gradients). Tolerances: bf16 within 3e-2 (the gradients are of order 1;
   P and dS round to bf16 per tile in both, from f32 products summed in
   another order), fp32 within 1e-4. Prints per shape the backward's time
   (delta pass + both kernels) and each kernel's, the plain version's, the
   backward of SDPA with the same mask as a yardstick, and the bound.
4. serve  — full-width BERT-base (the ``BertConfig()`` defaults: 12 layers,
   hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions) in bf16
   with seeded random weights: save and restore through ``ckpt``, build
   ``BertInferenceEngine`` (buckets 128/256/512, tiers 1/2/4/8) behind
   ``Client``, serve 24 requests across all three buckets, and check that
   the kernel ran 12 times per forward in buckets 256 and 512, that the
   answers agree with the same params run through plain attention on the
   card, and one HTTP ``/v1/mlm`` round trip. Then per-bucket latency.
5. train  — the slice's main path: full-width BERT-base pretraining (MLM +
   NSP) in bf16 over f32 params at L=512, 24 rows, ``SyntheticMLM`` data,
   AdamW(1e-4, weight decay 0.01 off biases/LayerNorms) + global-norm clip
   1.0, dropout 0.1 from an explicit CUDA generator, through
   ``make_train_step`` + ``fit``. Checks: a finite loss every step; each
   of flash_fwd, flash_bwd_dq and flash_bwd_dkv launched 12 times per
   step; with dropout off, one step's gradients through the kernels agree
   leaf by leaf with plain attention's: relative L2 error within 2e-2 over
   the whole gradient and for the median leaf, and within 0.25 for every
   leaf (bf16 activations round differently on the two paths; the pooler
   and NSP leaves ride on one bf16 [CLS] vector per row and move most),
   each against a floor of 1e-3 of the whole gradient's norm for the key
   biases, whose exact gradient is zero; on one
   fixed batch at a constant lr the loss falls over 10 steps. Then the
   median ms per step, tokens/s and MFU against 989 TFLOP/s.
6. train_cli — ``python -m distributed_tensorflow_tpu_torch.cli.train
   --config bert_base`` (the preset at its own width: L=128, dense
   attention) for 3 steps with a checkpoint, then ``restore_serving_state``
   on it and one ``run_batch``.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; without CUDA it exits 1.
"""

from __future__ import annotations

import dataclasses
import importlib
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


def phase_build(fm):
    from distributed_tensorflow_tpu_torch.ops import build as kbuild

    t0 = time.monotonic()
    fm.build()
    seconds = round(time.monotonic() - t0, 3)
    for name in ("flash_fwd", "flash_bwd"):
        info = kbuild.BUILD_INFO[name]
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "Compiling entry" in ln]
        emit({"phase": "build", "library": Path(info["path"]).name,
              "nvcc_seconds": round(info["seconds"], 3), "seconds": seconds,
              "ptxas": regs})


def phase_kernel(fm, torch):
    cases = [(b, l, 12, 64, torch.bfloat16) for b in (1, 8) for l in (256, 512, 300)]
    cases += [(2, 384, 24, 32, torch.bfloat16), (2, 512, 6, 128, torch.bfloat16),
              (2, 256, 12, 64, torch.float32)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows, max_err = [], 0.0
    for b, l, h, d, dtype in cases:
        q, k, v = (torch.randn(b, l, h, d, device="cuda", dtype=dtype, generator=gen)
                   for _ in range(3))
        valid = torch.randint(l // 2, l + 1, (b,), generator=gen, device="cuda")
        if b > 1:
            valid[-1] = 0  # a fully masked batch row
        mask = torch.arange(l, device="cuda")[None, :] < valid[:, None]
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        ro, rlse = fm.flash_attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        fp32 = dtype == torch.float32
        check(torch.isfinite(o.float()).all().item(), f"non-finite o at {(b, l, h, d)}")
        check(err <= (1e-5 if fp32 else 1e-2), f"o error {err} at {(b, l, h, d, dtype)}")
        check(lse_err <= 1e-4, f"lse error {lse_err} at {(b, l, h, d, dtype)}")
        if b > 1:
            check(torch.all(o[-1] == 0).item() and torch.all(lse[-1] == -1e30).item(),
                  "fully masked row must give o = 0 and lse = -1e30")
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
        emit(row)
        rows.append(row)
        max_err = max(max_err, err)
    emit({"phase": "kernel", "source_note_bound": {
        "cell": "tier 8, L=512, H=12, D=64, bf16, no padding",
        "gflop": 4 * 8 * 12 * 512**2 * 64 / 1e9,
        "mbytes": 4 * 8 * 512 * 768 * 2 / 1e6,
        "bound_ms": flash_bound(8, 512, 12, 64, [512] * 8, 2, False)[0]}})
    main_row = next(r for r in rows if (r["B"], r["L"], r["dtype"]) == (8, 512, "bfloat16"))
    return main_row, max_err


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


def phase_kernel_bwd(fm, torch):
    bf16 = torch.bfloat16
    cases = [(b, l, 12, 64, bf16) for b in (1, 8, 24) for l in (256, 512, 300)]
    cases += [(2, 384, 24, 32, bf16), (2, 512, 6, 128, bf16), (2, 256, 12, 64, torch.float32)]
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    main_row, max_err = None, {"dq": 0.0, "dkv": 0.0}
    for b, l, h, d, dtype in cases:
        q, k, v, do = (torch.randn(b, l, h, d, device="cuda", dtype=dtype, generator=gen)
                       for _ in range(4))
        valid = torch.randint(l // 2, l + 1, (b,), generator=gen, device="cuda")
        if b > 1:
            valid[-1] = 0  # a fully masked batch row
        mask = torch.arange(l, device="cuda")[None, :] < valid[:, None]
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        dlse = torch.randn(lse.shape, device="cuda", generator=gen)
        fp32 = dtype == torch.float32
        tol = 1e-4 if fp32 else 3e-2
        err = {"dq": 0.0, "dkv": 0.0}
        for cot in (None, dlse):
            got = fm.flash_bwd_cuda(q, k, v, mask, o, lse, do, cot)
            ref = fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do, cot)
            torch.cuda.synchronize()
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                check(torch.isfinite(g.float()).all().item(), f"non-finite {name} at {(b, l, h, d)}")
                e = (g.float() - r.float()).abs().max().item()
                check(e <= tol, f"{name} error {e} at {(b, l, h, d, dtype)}, dlse={cot is not None}")
                if b > 1:
                    check(torch.all(g[-1] == 0).item(),
                          f"fully masked row must give zero {name}")
                key = "dq" if name == "dq" else "dkv"
                err[key] = max(err[key], e)
        delta = fm.flash_bwd_delta(o, do)
        args = (q, k, v, mask, do, lse, delta)
        esize = q.element_size()
        keys = valid.tolist()
        bound_ms, bound_by = bwd_bound(b, l, h, d, keys, esize, fp32, 5, 8, 1)
        library = _sdpa_backward_ms(torch, q, k, v, mask, do)
        row = {"phase": "kernel_bwd", "B": b, "L": l, "H": h, "D": d,
               "dtype": str(dtype).removeprefix("torch."),
               "max_abs_err_dq": err["dq"], "max_abs_err_dkv": err["dkv"],
               "kernel_ms": cuda_ms(lambda: fm.flash_bwd_cuda(q, k, v, mask, o, lse, do), 10),
               "dq_ms": cuda_ms(lambda: fm.flash_bwd_dq_cuda(*args), 10),
               "dkv_ms": cuda_ms(lambda: fm.flash_bwd_dkv_cuda(*args), 10),
               "plain_ms": cuda_ms(
                   lambda: fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do), 3),
               "library_ms": library["all"], "bound_ms": bound_ms, "bound_by": bound_by}
        if (b, l, dtype) == (24, 512, bf16):
            # Per kernel, at the training cell: its own plain version, the
            # SDPA backward of just its outputs, and its own bound.
            row["dq"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dq_reference(*args), 3),
                         "library_ms": library["q"],
                         **dict(zip(("bound_ms", "bound_by"),
                                    bwd_bound(b, l, h, d, keys, esize, fp32, 3, 5, 2)))}
            row["dkv"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dkv_reference(*args), 3),
                          "library_ms": library["kv"],
                          **dict(zip(("bound_ms", "bound_by"),
                                     bwd_bound(b, l, h, d, keys, esize, fp32, 4, 6, 2)))}
            main_row = row
        emit(row)
        for key in max_err:
            max_err[key] = max(max_err[key], err[key])
    emit({"phase": "kernel_bwd", "source_note_bound": {
        "cell": "B=24, L=512, H=12, D=64, bf16, no padding",
        "gflop": 10 * 24 * 12 * 512**2 * 64 / 1e9,
        "mbytes": 8 * 24 * 512 * 768 * 2 / 1e6,
        "bound_ms": bwd_bound(24, 512, 12, 64, [512] * 24, 2, False, 5, 8, 0)[0]}})
    return main_row, max_err


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    t_start = time.monotonic()
    try:
        phase_build(fm)
        fwd_row, fwd_err = phase_kernel(fm, torch)
        bwd_row, bwd_err = phase_kernel_bwd(fm, torch)
        phase_serve(fm, torch)
        torch.cuda.empty_cache()
        launches = phase_train(fm, torch)
        torch.cuda.empty_cache()
        phase_train_cli(torch)
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
    }]
    for name, key, line in (("flash_bwd_dq", "dq", "490"), ("flash_bwd_dkv", "dkv", "559")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
            "replaces": ref + line, "launches": launches[name], "max_abs_err": bwd_err[key],
            "ms": bwd_row[f"{key}_ms"], "plain_ms": bwd_row[key]["plain_ms"],
            "bound_ms": bwd_row[key]["bound_ms"], "bound_by": bwd_row[key]["bound_by"],
            "library_ms": bwd_row[key]["library_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
