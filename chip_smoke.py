#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. build  — compile the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a)
   into ``build/kernels/``; print the build seconds and ptxas' resource use.
2. kernel — hold the flash-attention kernel to its plain PyTorch version on
   the card: bf16 at B in {1, 8} x L in {256, 512, 300} with H=12, D=64,
   plus D=32, D=128 and an fp32 case; masks with padded and fully masked
   rows. Tolerances: bf16 o within 1e-2 (P rounds to bf16 per 64-key tile
   in the kernel, once in the plain version), fp32 o within 1e-5, lse
   within 1e-4. Prints kernel/plain/library (SDPA, a yardstick the port
   never calls) times and the card's bound, one JSON line per shape.
3. serve  — full-width BERT-base (the ``BertConfig()`` defaults: 12 layers,
   hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions) in bf16
   with seeded random weights: save and restore through ``ckpt``, build
   ``BertInferenceEngine`` (buckets 128/256/512, tiers 1/2/4/8) behind
   ``Client``, serve 24 requests across all three buckets, and check that
   the kernel ran 12 times per forward in buckets 256 and 512, that the
   answers agree with the same params run through plain attention on the
   card, and one HTTP ``/v1/mlm`` round trip. Then per-bucket latency.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; without CUDA it exits 1.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
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
    info = kbuild.BUILD_INFO["flash_fwd"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    emit({"phase": "build", "library": Path(info["path"]).name,
          "nvcc_seconds": round(info["seconds"], 3),
          "seconds": round(time.monotonic() - t0, 3), "ptxas": regs})


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
        main_row, max_err = phase_kernel(fm, torch)
        launches = phase_serve(fm, torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.monotonic() - t_start:.1f} s",
          file=sys.stderr)
    print(smi[0] if smi else "nvidia-smi: no output")
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "distributed_tensorflow_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "distributed_tensorflow_tpu/ops/flash_attention.py:396",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
