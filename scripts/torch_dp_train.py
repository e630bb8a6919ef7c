#!/usr/bin/env python3
"""One rank of multi-process data-parallel ResNet-50 training on CUDA cards.

Run one process a rank, all with the same arguments but ``--rank``::

    python3 scripts/torch_dp_train.py --world 2 --rank 0 --port 29500 --backend gloo &
    python3 scripts/torch_dp_train.py --world 2 --rank 1 --port 29500 --backend gloo

Each rank starts the process group through ``initialize_runtime`` (NCCL
between cards; gloo when several ranks share one card, which NCCL
refuses) on ``cuda:<rank % device_count>`` and trains full-width
ResNet-50 (torchvision widths, 224x224, bf16 over f32 params, seeded random
weights, ``pw_backend="fused"``) with SGD 0.1 and momentum 0.9, through
``make_train_step`` + ``fit``, on its ``rows / world`` rows of one fixed
global batch of synthetic class-template images (``device_batches``), in
``--mode sync`` or ``--mode stale --staleness K``. It prints one JSON line:

- ``losses`` (the data-parallel mean), ``digests`` and ``param_digests``
  over the first ``--steps`` steps: after every step a BLAKE2 digest of the
  params, the optimizer's momentum slots, the BatchNorm statistics and the
  stale ring, byte for byte, equal on every rank when the ranks are in
  lockstep; and one of the params alone (under ``--mode stale`` they stand
  still until the first stored gradient comes back, K steps later);
- ``launches``: the fused conv+BN kernels' launch counts over those steps
  (set to 0 just before ``fit``);
- ``step_ms``: then ``--timed-steps`` more steps with no digest, the host
  clock between steps, each ending in the loss fetch (every rank waits for
  the slowest at the all-reduce); ``step_ms_median``;
- ``allreduce_ms``: one ``all_reduce`` of the params packed as the step
  packs the gradient (one flat f32 bucket), median of 5 after 2 of
  warm-up, each ending in a synchronise; ``bucket_numel``; and
  ``allreduce_ok``: the bucket ends as the ranks' identical params times
  ``world ** 7`` (within 1e-6; exactly at world 1 and 2);
- the card's name, ``torch.cuda.max_memory_allocated()``.

With ``--save DIR`` rank 0 also saves its params, momentum slots and
BatchNorm statistics after steps 1 and 2 to ``DIR/dp_step{1,2}.pt``. cuDNN
picks deterministic algorithms only and no product runs in TF32
(:func:`numerics`), so another process can repeat a rank's step bit for
bit. Needs a card.

``--chaos DIR`` runs the chaos rehearsal instead: each process trains
alone (no process group: ``--rank`` is its host id; the processes share
only ``DIR``), ``--steps`` steps of ``--rows`` rows of a seeded synthetic
stream (:func:`chaos_batches`), each step padded by ``--pad-s`` seconds of
sleep, through ``fit`` with the flight recorder (``DIR/dumps_<rank>``), a
fault injector, checkpoints every ``CHAOS_CKPT_EVERY`` steps into
``DIR/ckpt_<rank>`` and a health beacon in ``DIR/beacons``. Rank 0's plan
holds ``slow_step`` at 5 and ``host_drop`` at ``CHAOS_HOST_DROP_AT``: it
dumps its recorder and dies by SIGKILL. A survivor writes its beacon once
more when rank 0's dump is there, then prints one JSON line with its
step, newest checkpoint, losses and kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx  # noqa: E402
from distributed_tensorflow_tpu_torch.data.loader import device_batches  # noqa: E402
from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_image_classification,
)
from distributed_tensorflow_tpu_torch.models import ResNet50  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_runtime,
    shutdown_runtime,
)
from distributed_tensorflow_tpu_torch.train import (  # noqa: E402
    create_train_state,
    fit,
    make_rng,
    make_train_step,
)
from distributed_tensorflow_tpu_torch.train.objectives import (  # noqa: E402
    init_model,
    make_classification_loss,
)

SEED = 0
HW = 224
CHAOS_CKPT_EVERY = 4  # --chaos: the checkpoint cadence
CHAOS_HOST_DROP_AT = 11  # --chaos: the step rank 0 is killed at


def recipe():
    """SGD 0.1 with momentum 0.9 at a constant rate (``chip_smoke.py``'s
    ResNet-50 recipe)."""
    return dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                               learning_rate=0.1, momentum=0.9, optimizer="sgd")


def numerics() -> None:
    """Deterministic cuDNN algorithms and full-f32 products, in every
    process that trains or repeats a rank's step."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(device, staleness: int = 0, pw_backend: str = "fused"):
    """``(model, state, tx)``: seeded full-width ResNet-50, ``fused``
    unless ``pw_backend`` names another 1x1 backend."""
    model = ResNet50(dtype=torch.bfloat16, pw_backend=pw_backend, device=device,
                     generator=torch.Generator(device).manual_seed(SEED))
    params, model_state = init_model(model)
    tx, _ = _make_tx(recipe())
    return model, create_train_state(params, tx, model_state, staleness=staleness), tx


def fixed_batch(rows: int, device):
    """This process's rows of the one fixed global batch."""
    data = synthetic_image_classification(rows, (HW, HW, 3), 1000, seed=SEED)
    return next(device_batches(data, rows, device=device, seed=2))


def slots(state) -> dict:
    """The optimizer's tensor slots by parameter name."""
    opt = state.opt_state.optimizer.state
    return {name: {k: t for k, t in opt[p].items() if isinstance(t, torch.Tensor)}
            for name, p in state.params.items() if p in opt}


def digest(state, params_only: bool = False) -> str:
    h = hashlib.blake2b(digest_size=16)
    tensors = list(state.params.values())
    if not params_only:
        tensors += [*(t for slot in slots(state).values() for t in slot.values()),
                    *state.model_state["batch_stats"].values(),
                    *(state.grad_buffer or {}).values()]
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def allreduce_ms(params: dict, world: int, iters: int = 5) -> tuple[float, bool]:
    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    want = flat * float(world) ** (iters + 2)
    times = []
    for i in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.allclose(flat, want, rtol=1e-6, atol=0.0)


def chaos_batches(rows: int, device, start_step: int = 0):
    """The chaos rehearsal's stream: ``rows`` rows a step of a seeded
    synthetic set, resumable at ``start_step``."""
    data = synthetic_image_classification(4 * rows, (HW, HW, 3), 1000, seed=SEED)
    return device_batches(data, rows, device=device, seed=1, start_step=start_step)


def chaos(args) -> dict:
    """One host of the chaos rehearsal (see the module docstring)."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.obs.fleet import HostBeacon, StepTimeline
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.train import FaultEvent, FaultInjector, FaultPlan

    work = Path(args.chaos)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    model, state, tx = build(device)
    step = make_train_step(make_classification_loss(model), tx)
    recorder = FlightRecorder(dump_dir=work / f"dumps_{args.rank}")
    plan = FaultPlan((FaultEvent("slow_step", 5, duration_s=0.05),
                      FaultEvent("host_drop", CHAOS_HOST_DROP_AT)) if args.rank == 0 else ())
    injector = FaultInjector(plan, recorder=recorder)
    timeline = StepTimeline()
    beacon = HostBeacon(work / "beacons", args.rank, timeline, extras=injector.summary)
    losses, marks = [], []

    def padded(state_, batch_, rng_):
        # Wall time a step, so the checkpoint writer finishes between steps.
        time.sleep(args.pad_s)
        return step(state_, batch_, rng_)

    def hook(s, st, metrics):
        losses.append(metrics["loss"])
        marks.append(time.perf_counter())
        beacon.write()

    fcb.reset_launch_counts()
    batches = prefetch(chaos_batches(args.rows, device), 2)
    try:
        with Checkpointer(work / f"ckpt_{args.rank}", fault_injector=injector) as ckpt:
            fit(state, padded, batches, num_steps=args.steps, rng=make_rng(SEED, device),
                log_every=1, hooks=(hook,), checkpointer=ckpt, ckpt_every=CHAOS_CKPT_EVERY,
                timeline=timeline, recorder=recorder, fault_injector=injector)
            latest = ckpt.latest_step()
    finally:
        batches.close()
    # A survivor stays up, its beacon fresh, until rank 0's dump shows its
    # death: a survivor that started first could end before rank 0 dies.
    deadline = time.monotonic() + 300
    while not any((work / "dumps_0").glob("flightrec-*.json")):
        if time.monotonic() > deadline:
            raise RuntimeError(f"chaos host {args.rank}: rank 0 never dumped its death")
        time.sleep(0.05)
    beacon.write()
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"rank": args.rank, "step": state.step, "latest_ckpt": latest,
            "last_step": timeline.last_step, "losses": losses, "launches": dict(fcb.LAUNCHES),
            "step_ms_median": statistics.median(step_ms), "pad_s": args.pad_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, default=0, help="the process group's port")
    p.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    p.add_argument("--chaos", default="", help="run the chaos rehearsal in this directory")
    p.add_argument("--pad-s", type=float, default=0.0, help="--chaos: sleep a step")
    p.add_argument("--mode", choices=["sync", "stale"], default="sync")
    p.add_argument("--staleness", type=int, default=0)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--timed-steps", type=int, default=5)
    p.add_argument("--rows", type=int, default=128, help="global batch")
    p.add_argument("--save", default="", help="rank 0 saves steps 1 and 2 here")
    args = p.parse_args(argv)
    if not args.chaos and not args.port:
        p.error("--port is required (the process group's port) unless --chaos")
    if not torch.cuda.is_available():
        print("torch_dp_train: needs a CUDA card", file=sys.stderr)
        return 1
    numerics()
    if args.chaos:
        print(json.dumps(chaos(args)), flush=True)
        return 0
    device = initialize_runtime(f"127.0.0.1:{args.port}", args.world, args.rank,
                                device="cuda", backend=args.backend, timeout_s=300)
    try:
        staleness = args.staleness if args.mode == "stale" else 0
        model, state, tx = build(device, staleness)
        step = make_train_step(make_classification_loss(model), tx, mode=args.mode,
                               staleness=staleness)
        batch = fixed_batch(args.rows, device)
        digests, param_digests, losses, marks = [], [], [], []

        def checked(s, st, metrics):
            losses.append(metrics["loss"])
            digests.append(digest(st))
            param_digests.append(digest(st, params_only=True))
            if s in (1, 2) and args.rank == 0 and args.save:
                torch.save({"params": {k: v.detach().cpu() for k, v in st.params.items()},
                            "slots": {k: {n: t.cpu() for n, t in slot.items()}
                                      for k, slot in slots(st).items()},
                            "batch_stats": {k: v.cpu() for k, v in
                                            st.model_state["batch_stats"].items()}},
                           Path(args.save) / f"dp_step{s}.pt")

        torch.cuda.reset_peak_memory_stats()
        fcb.reset_launch_counts()
        rng = make_rng(SEED, device)
        fit(state, step, itertools.repeat(batch), num_steps=args.steps, rng=rng,
            log_every=1, hooks=(checked,))
        torch.cuda.synchronize()
        launches = dict(fcb.LAUNCHES)
        marks.append(time.perf_counter())
        fit(state, step, itertools.repeat(batch), num_steps=args.steps + args.timed_steps,
            rng=rng, log_every=1, hooks=(lambda *_: marks.append(time.perf_counter()),))
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        numel = sum(v.numel() for v in state.params.values())
        reduce_ms, reduce_ok = allreduce_ms(state.params, args.world)
        out = {
            "rank": args.rank, "world": args.world, "backend": args.backend,
            "mode": args.mode, "staleness": staleness, "device": str(device),
            "card": torch.cuda.get_device_name(device), "rows": args.rows // args.world,
            "losses": losses, "digests": digests, "param_digests": param_digests,
            "launches": launches,
            "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
            "allreduce_ms": reduce_ms, "allreduce_ok": reduce_ok, "bucket_numel": numel,
            "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        }
    finally:
        shutdown_runtime()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
