#!/usr/bin/env python3
"""Time the flash-attention backward and the fused conv+BN backward
kernels on one CUDA card, at the shapes of their main paths.

- ``flash``: the BERT-base training cell (B=24, L=512, H=12, D=64, bf16,
  no padding): the dQ kernel (``flash_bwd_dq``), the dK/dV kernel and the whole backward
  (``flash_bwd_cuda``: the delta pass and both kernels), beside the
  backward of ``scaled_dot_product_attention`` with the same mask (a
  yardstick the port never calls: ``all`` = dq, dk, dv; ``q`` = dq alone,
  which SDPA computes in the same one pass);
- ``bn_dw``: ``bn_bwd_apply_dw`` (ReLU on) at ResNet-50's 12 fused shapes
  (b=128, 224x224, 29 units a step) and Inception-v3's 12 (299x299, 128
  images, 27 units a step), each shape's time times its units, summed
  (``scripts/torch_pw_bench.py``'s ``RESNET50`` and ``INCEPTION_FUSED``);
- ``bn_dx``: ``bn_bwd_apply_dx`` (ReLU on) at the same shapes, summed the
  same way, beside two yardsticks that are not ports of it: ``composite``,
  dz made by the plain elementwise code into device memory in bf16 and
  then ``pw_dgrad_cuda`` (what the fused kernel must beat for dz in
  shared memory to pay), and ``product``, ``torch.matmul(dz, w.t())`` of a
  dz made ahead (the product alone);
- ``bn_reduce``: ``bn_bwd_reduce`` at the same shapes, summed the same way:
  ``reduce`` the wrapper alone, and ``to_consts`` the whole sequence that
  ``_bn_bwd`` runs from the batch statistics to the apply kernels'
  constants (in a checkout whose reduce cannot write them: the reduce,
  then ``s / m`` and a second ``_pack_consts``);
- ``bn_dw_precision``: how close ``bn_bwd_apply_dw`` comes to its
  tolerance against the plain version (1e-5 x max |dW| + 1e-5, as the
  tests hold it) at the shapes whose M ranges sum the most rows, over 8
  seeded inputs each: the worst ratio of error to tolerance. The error of
  ``wgmma``'s f32 sums grows with the products one accumulator takes.

Each kernel is timed per call (``ms``: back-to-back calls between CUDA
events, the host's launch work included) and as device time (``graph_ms``:
the same calls replayed from one CUDA graph), with ``scripts/torch_pw_bench.py``'s
timers. Prints the card's name and power limit, then one JSON line per
measurement and per-step sums; needs a card::

    python3 scripts/torch_bwd_bench.py [--parts flash bn_dw bn_dx bn_reduce bn_dw_precision]

To time another checkout by the same method (for example a ``git archive``
of an earlier commit), copy this script and ``scripts/torch_pw_bench.py``
into that checkout's ``scripts/`` and run it there: it imports the port
from the checkout it sits in.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import pointwise_conv as pc  # noqa: E402

# The package re-exports the function under the module's name.
fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")

SEED = 0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def load_pw_bench():
    spec = importlib.util.spec_from_file_location("torch_pw_bench",
                                                  ROOT / "scripts" / "torch_pw_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_flash(pwb, iters: int) -> dict:
    gen = torch.Generator("cuda").manual_seed(SEED)
    b, l, h, d = 24, 512, 12, 64
    q, k, v, do = (torch.randn(b, l, h, d, device="cuda", dtype=torch.bfloat16, generator=gen)
                   for _ in range(4))
    mask = torch.ones(b, l, dtype=torch.bool, device="cuda")
    o, lse = fm.flash_fwd_cuda(q, k, v, mask)
    delta = fm.flash_bwd_delta(o, do)
    args = (q, k, v, mask, do, lse, delta)
    calls = {"flash_bwd_dq": lambda: fm.flash_bwd_dq_cuda(*args),
             "flash_bwd_dkv": lambda: fm.flash_bwd_dkv_cuda(*args),
             "flash_bwd_cuda": lambda: fm.flash_bwd_cuda(q, k, v, mask, o, lse, do)}
    out = {}
    for name, fn in calls.items():
        out[name] = {"ms": pwb.cuda_ms(fn, iters), "graph_ms": pwb.graph_ms(fn, iters)}
        emit({"part": "flash", "kernel": name, "B": b, "L": l, "H": h, "D": d, **out[name]})
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    y = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                         attn_mask=mask[:, None, None, :])
    dot = do.transpose(1, 2)
    for name, inputs in (("all", (qt, kt, vt)), ("q", (qt,))):
        ms = pwb.cuda_ms(lambda inputs=inputs: torch.autograd.grad(y, inputs, dot,
                                                                   retain_graph=True), iters)
        out[f"sdpa_bwd_{name}"] = {"ms": ms}
        emit({"part": "flash", "library": f"sdpa_bwd_{name}", "ms": ms})
    return out


def _bn_inputs(gen, m, k, n):
    """x, W, dA, z (bf16), the batch statistics (mean, inv, gamma, beta)
    and the apply pass's constants (s1/M, s2/M of the plain reduce)."""
    x = torch.randn(m, k, device="cuda", dtype=torch.bfloat16, generator=gen)
    w = (torch.randn(k, n, device="cuda", generator=gen) * k**-0.5).bfloat16()
    da = torch.randn(m, n, device="cuda", dtype=torch.bfloat16, generator=gen)
    z = torch.matmul(x, w)
    zf = z.float()
    mean = zf.mean(0)
    inv = torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5)
    gamma = torch.rand(n, device="cuda", generator=gen) + 0.5
    beta = torch.randn(n, device="cuda", generator=gen) * 0.5
    stats = (mean, inv, gamma, beta)
    s1, s2 = fcb.bn_bwd_reduce_reference(da, z, fcb._pack_consts(*stats), True)
    return x, w, da, z, stats, fcb._pack_consts(*stats, s1 / m, s2 / m)


def _per_step(pwb, iters: int, part: str, seed: int, calls) -> dict:
    """Time ``calls(m, k, n, inputs) -> {name: fn}`` at ResNet-50's and
    Inception-v3's fused shapes (``ms`` and ``graph_ms`` of each), and sum
    each name's times weighted by the shape's units a step."""
    gen = torch.Generator("cuda").manual_seed(seed)
    out = {}
    for cell, table in (("resnet50", pwb.RESNET50), ("inception_v3", pwb.INCEPTION_FUSED)):
        table = {pwb.mkn(*sh): units for sh, units in table.items()}
        total = {}
        for (m, k, n), units in table.items():
            inputs = _bn_inputs(gen, m, k, n)
            for name, fn in calls(m, k, n, inputs).items():
                rec = {"ms": pwb.cuda_ms(fn, iters), "graph_ms": pwb.graph_ms(fn, iters)}
                emit({"part": part, "cell": cell, "call": name, "M": m, "K": k, "N": n,
                      "units": units, **rec})
                acc = total.setdefault(name, {"ms": 0.0, "graph_ms": 0.0, "units": 0})
                for key in ("ms", "graph_ms"):
                    acc[key] += units * rec[key]
                acc["units"] += units
            del inputs
        out[cell] = total
        emit({"part": part, "cell": cell, "per_step": total})
    return out


def bench_bn_dw(pwb, iters: int) -> dict:
    def calls(m, k, n, inputs):
        x, _, da, z, _, consts = inputs
        return {"bn_bwd_apply_dw": lambda: fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, True)}

    return _per_step(pwb, iters, "bn_dw", SEED + 1, calls)


def bench_bn_dx(pwb, iters: int) -> dict:
    def calls(m, k, n, inputs):
        _, w, da, z, _, consts = inputs
        dz = fcb._dz(da, z, consts, True, torch.bfloat16)
        return {"bn_bwd_apply_dx": lambda: fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, True),
                "composite": lambda: pc.dgrad_cuda(fcb._dz(da, z, consts, True, torch.bfloat16),
                                                   w),
                "product": lambda: torch.matmul(dz, w.t())}

    return _per_step(pwb, iters, "bn_dx", SEED + 2, calls)


def bench_bn_reduce(pwb, iters: int) -> dict:
    writes = "write_consts" in inspect.signature(fcb.bn_bwd_reduce_cuda).parameters

    def calls(m, k, n, inputs):
        _, _, da, z, stats, _ = inputs
        c0 = fcb._pack_consts(*stats)

        def to_consts():
            consts = fcb._pack_consts(*stats)
            if writes:
                fcb.bn_bwd_reduce_cuda(da, z, consts, True, write_consts=True)
                return consts
            s1, s2 = fcb.bn_bwd_reduce_cuda(da, z, consts, True)
            return fcb._pack_consts(*stats, s1 / m, s2 / m)

        return {"reduce": lambda: fcb.bn_bwd_reduce_cuda(da, z, c0, True),
                "to_consts": to_consts}

    return _per_step(pwb, iters, "bn_reduce", SEED + 3, calls)


PRECISION_SHAPES = [(6272, 1024, 2048), (6272, 2048, 2048), (3136, 2048, 2048),
                    (401408, 256, 128), (25088, 1024, 512), (8192, 2048, 448)]


def bench_bn_dw_precision(seeds: int = 8) -> dict:
    out = {}
    for m, k, n in PRECISION_SHAPES:
        worst = 0.0
        for seed in range(seeds):
            gen = torch.Generator("cuda").manual_seed(1000 + seed)
            x, _, da, z, _, consts = _bn_inputs(gen, m, k, n)
            ref = fcb.bn_bwd_apply_dw_reference(da, z, x, consts, True)
            got = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, True)
            tol = 1e-5 * ref.abs().max().item() + 1e-5
            worst = max(worst, (got - ref).abs().max().item() / tol)
            del x, da, z, consts, ref, got
        out[f"{m}x{k}x{n}"] = worst
        emit({"part": "bn_dw_precision", "M": m, "K": k, "N": n, "seeds": seeds,
              "worst_err_over_tol": worst})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parts = ["flash", "bn_dw", "bn_dx", "bn_reduce", "bn_dw_precision"]
    ap.add_argument("--parts", nargs="+", default=parts, choices=parts)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bwd_bench: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": str(ROOT)})
    pwb = load_pw_bench()
    summary = {}
    if "flash" in args.parts:
        summary["flash"] = bench_flash(pwb, args.iters)
    if "bn_dw" in args.parts:
        summary["bn_dw"] = bench_bn_dw(pwb, args.iters)
    if "bn_dx" in args.parts:
        summary["bn_dx"] = bench_bn_dx(pwb, args.iters)
    if "bn_reduce" in args.parts:
        summary["bn_reduce"] = bench_bn_reduce(pwb, args.iters)
    if "bn_dw_precision" in args.parts:
        summary["bn_dw_precision"] = bench_bn_dw_precision()
    emit({"summary": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
