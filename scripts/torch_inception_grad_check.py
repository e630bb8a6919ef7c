#!/usr/bin/env python3
"""How far Inception-v3's bf16 gradients sit from its fp32 gradient, plain
and fused, beside the controls that say how far the fp32 gradient moves
on its own.

Per seed (weights and batch drawn from it), at the initial params, dropout
off, train-mode BatchNorm over the batch, the classification loss (the aux
head's included where the input is 299x299), every gradient is compared
with an fp32 run of the plain model under deterministic algorithms (cuDNN
deterministic, no TF32):

- ``fp32_repeat``: the same fp32 run again on the same images. Must read
  exactly 0: a control that does not repeat cannot tell the model's
  sensitivity from nondeterminism. The script exits 1 otherwise.
- ``fp32_other_algorithms``: the same fp32 run with cuDNN free to choose
  its algorithms (``benchmark``, nondeterministic allowed): the same
  arithmetic summed in another order.
- ``fp32_on_bf16_images``: the fp32 run on the images rounded to bf16.
- ``bf16_plain`` and ``bf16_fused``: the port's two bf16 paths
  (``fused=True`` runs the fused conv+BN backward kernels on the card).

Each comparison prints the relative L2 error over all gradients and the
median over the parameter leaves (each leaf against a floor of 1e-3 of
the whole reference's norm). On the card (default)::

    python3 scripts/torch_inception_grad_check.py [--seeds 2] [--images 128]

and on the CPU at a small size (the fused path then runs the kernels' plain
versions)::

    python3 scripts/torch_inception_grad_check.py --device cpu --image-size 75 --images 4
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import warnings
from pathlib import Path

# cuBLAS repeats its sums only with a fixed workspace; read when the
# library starts, so before torch is imported.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.data.loader import device_batches  # noqa: E402
from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_image_classification,
)
from distributed_tensorflow_tpu_torch.device import resolve_device  # noqa: E402
from distributed_tensorflow_tpu_torch.models import InceptionV3  # noqa: E402
from distributed_tensorflow_tpu_torch.train.objectives import (  # noqa: E402
    init_model,
    make_classification_loss,
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rel_errors(got: dict, ref: dict) -> tuple[float, float]:
    """Relative L2 error of a dict of tensors against a reference: over the
    whole dict, and the median over entries, each against a floor of 1e-3
    of the whole reference's norm."""
    total = torch.linalg.vector_norm(torch.stack([r.norm() for r in ref.values()])).item()
    diffs = {n: (got[n].float() - r).norm().item() for n, r in ref.items()}
    per = [diffs[n] / max(r.norm().item(), 1e-3 * total) for n, r in ref.items()]
    whole = torch.linalg.vector_norm(torch.tensor(list(diffs.values()))).item()
    return whole / total, statistics.median(per)


def set_deterministic(on: bool) -> None:
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = not on


def gradients(weights, batch, device, dtype, fused, aux, images=None) -> dict:
    """Every parameter's f32 gradient of the classification loss at
    ``weights`` (a state dict), in train mode on a fresh batch_stats."""
    model = InceptionV3(dtype=dtype, fused=fused, dropout_rate=0.0, aux_logits=aux,
                        device=device)
    model.load_state_dict(weights)
    params, state = init_model(model)
    if images is not None:
        batch = {**batch, "image": images}
    loss, _ = make_classification_loss(model)(params, state, batch, None)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {n: g.float() for n, g in zip(params, grads)}


def check_seed(seed: int, device, images: int, hw: int) -> dict:
    aux = hw >= 299
    data = synthetic_image_classification(images, (hw, hw, 3), 1000, seed=seed)
    batch = next(device_batches(data, images, device=device, seed=seed))
    weights = {n: t.detach().clone() for n, t in InceptionV3(
        aux_logits=aux, device=device,
        generator=torch.Generator(device).manual_seed(seed)).state_dict().items()}
    f32 = torch.float32
    set_deterministic(True)
    exact = gradients(weights, batch, device, f32, False, aux)
    runs = {"fp32_repeat": gradients(weights, batch, device, f32, False, aux)}
    runs["fp32_on_bf16_images"] = gradients(weights, batch, device, f32, False, aux,
                                            batch["image"].bfloat16().float())
    runs["bf16_plain"] = gradients(weights, batch, device, torch.bfloat16, False, aux)
    runs["bf16_fused"] = gradients(weights, batch, device, torch.bfloat16, True, aux)
    set_deterministic(False)
    runs["fp32_other_algorithms"] = gradients(weights, batch, device, f32, False, aux)
    set_deterministic(True)
    row = {"seed": seed, "images": images, "image_size": hw, "leaves": len(exact),
           "grad_norm": torch.linalg.vector_norm(
               torch.stack([g.norm() for g in exact.values()])).item()}
    for name, got in runs.items():
        total, median = rel_errors(got, exact)
        row[name] = {"rel_l2_err_total": total, "median_rel_l2_err": median}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=299)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for seed in range(args.seeds):
            rows.append(check_seed(seed, device, args.images, args.image_size))
            emit(rows[-1])
    nondeterministic = sorted({str(w.message).split("\n")[0] for w in caught
                               if "deterministic" in str(w.message)})
    repeat = max(r["fp32_repeat"]["rel_l2_err_total"] for r in rows)
    emit({"summary": {name: [r[name]["rel_l2_err_total"] for r in rows]
                      for name in ("fp32_repeat", "fp32_other_algorithms",
                                   "fp32_on_bf16_images", "bf16_plain", "bf16_fused")},
          "nondeterministic_ops": nondeterministic, "fp32_repeats_exactly": repeat == 0.0})
    return 0 if repeat == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
