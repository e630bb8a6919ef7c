#!/usr/bin/env python3
"""One rank of model-parallel BERT training (tensor parallelism, ring and
Ulysses attention, mixture-of-experts under its three dispatches, the GPipe
pipeline), and the model-parallel collectives checked on the rank's
device.

Run one process a rank, all with the same arguments but ``--rank``::

    python3 scripts/torch_mp_train.py --world 2 --rank 0 --port 29500 --out DIR &
    python3 scripts/torch_mp_train.py --world 2 --rank 1 --port 29500 --out DIR

Each rank starts the process group through ``initialize_runtime`` on
``--device`` (``cuda:<rank % device_count>``, or ``cpu``) over
``--backend``: by default NCCL on a card (one process a card) and gloo on
the CPU, as ``initialize_runtime`` picks; ``--backend gloo`` when several
ranks share one card, which NCCL refuses. Then:

1. ``collectives``: on a ``{"seq": world}`` mesh, :mod:`..parallel.collectives`'
   ``psum``, ``ppermute``, ``all_to_all`` and ``all_gather`` (with the
   gradients of a weighted sum of each output) and the bucketed
   ``pmean_tree``, on seeded inputs of every rank, values checked against
   the same arithmetic done here on the gathered inputs; then each of
   the backend's ``all_reduce`` (f32 and bf16), ``all_gather`` and
   ``all_to_all_single`` called raw on device tensors, recording whether
   it takes them, and the collectives' list of ops staged through host
   memory under gloo (``GLOO_HOST_STAGED``: ``send``/``recv``, which gloo
   cannot do from device memory);
2. for each of :data:`CONFIGS` (``{"model": world}`` Megatron TP, ``{"seq":
   world}`` ring (its flash inner: ``attn_impl="flash"``) and Ulysses,
   ``{"expert": world}`` MoE of :data:`EXPERTS`
   experts dispatched replicated, all-to-all and sharded (top-1, and
   sharded top-2), ``{"pipeline": world}`` GPipe at ``4 * world``
   microbatches), BERT (``BertConfig()``'s widths unless
   ``--layers/--hidden/--heads/--vocab/--seq-len`` cut them) from the
   seeded global parameters on one fixed batch of ``--rows`` rows
   (default :data:`ROWS`)
   (:func:`fixed_batch`, the sequence split over ``"seq"``, the rows over
   ``"expert"`` under the sharded dispatch):
   ``held_bf16``: one bf16 step with dropout off (AdamW 1e-4, decay 0.01,
   clip 1.0): loss and grad_norm; ``held_fp32``: one fp32 SGD 0.1 step with
   dropout off, whose parameters each rank saves to
   ``DIR/params_<config>_rank<R>.pt`` (its slices, with their specs). The
   held MoE steps run at capacity factor :data:`HELD_CAPACITY` (= the
   expert count: no token is dropped, so the
   grouped and the global capacity rules agree). Then :func:`steps` bf16
   steps with dropout 0.1 (the AdamW recipe; MoE at capacity factor 1.25):
   the flash kernels' launches a step (counters set to 0 first), ms a step
   (synchronised), the collectives' ms a step (each collective call timed
   between two synchronisations) and of it the pipeline hand-offs'
   (``ppermute``), and ``moe_aux``; then ``--plain-steps`` steps with the
   timer off (ms a step without its synchronisations); then writes
   ``DIR/rank<R>.json``.

:func:`single_process_references` are the unsharded runs of the held steps
on the same parameters and batch, for the caller's comparison, one for
each of :data:`REFERENCE` 's kinds: dense BERT (the pipeline's stacked
encoder is the module list stacked), the MoE in one routing group, and
the MoE over ``world`` row groups with their losses averaged (the sharded
dispatch's groups, one a rank).

``--cli ARGS...`` instead runs ``cli.train.main(ARGS)`` with the
``bert_base`` recipe at ``BertConfig()``'s 512 positions registered as
``bert_base_l512`` (the preset pins 128, where the ring's local 64 keys
run dense attention) and the process group on ``--backend`` (not a CLI
flag: several ranks on one card need gloo).

``--serve ARGS... [--launch-log FILE] [--comm-timer-file GATE]`` runs
``cli.serve.main(ARGS)`` as one rank of a serving group on ``--backend``,
with two presets registered for the card's checks: ``bert_base_l512_f32``
(BERT-base at 512 positions, fp32 compute) and ``lm_base_f32``
(``lm_base`` in fp32). ``{rank}`` in ``FILE`` becomes the rank (a
launcher's ``RANK``, else ``--process-id``, else 0); the process writes
its pid to ``FILE.pid`` at start, and at exit ``FILE``: the exit code,
the flash kernels' launches since the engine's warm-up ended, the
collectives' seconds and calls over the same span (each call between two
synchronisations, as the training layouts time them) and the serving
group's control-channel digest. With ``GATE`` the collectives are timed
only in the cells a rank takes while that file exists (read once a cell),
so requests can be served with and without the timer's synchronisations
in one group.
SIGUSR1 prints every thread's stack to the process's stderr.

``--backend`` takes ``nccl`` or ``gloo`` in every mode and refuses any
other name (exit 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import functools
import importlib
import json
import os
import signal
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.data.text import (  # noqa: E402
    SyntheticMLM,
    SyntheticMLMConfig,
    mlm_device_batches,
)
from distributed_tensorflow_tpu_torch.models import bert  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import collectives as coll  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from distributed_tensorflow_tpu_torch.train.state import Transform  # noqa: E402

# The module (``ops.flash_attention`` the attribute is the function).
fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")
SEED = 0
ROWS, STEPS = 8, 3  # the fixed global batch (at 512 positions) and the timed steps
# Switch-Base-8's expert count (Fedus et al., 2021), its capacity factor in
# the timed steps, and the held steps' (the expert count: nothing dropped).
EXPERTS, CAPACITY, HELD_CAPACITY = 8, 1.25, 8.0
_MOE = dict(moe_experts=EXPERTS, expert_axis="expert")
# name -> (mesh axes with the world's size put in for -1, BertConfig fields)
CONFIGS = {
    "tp": ({"model": -1}, dict(model_axis="model")),
    "ring": ({"seq": -1}, dict(seq_axis="seq", sp_impl="ring", attn_impl="flash")),
    "ulysses": ({"seq": -1}, dict(seq_axis="seq", sp_impl="ulysses")),
    "ep_replicated": ({"expert": -1}, dict(_MOE, moe_dispatch="replicated")),
    "ep_alltoall": ({"expert": -1}, dict(_MOE, moe_dispatch="alltoall")),
    "ep_sharded": ({"expert": -1}, dict(_MOE, moe_dispatch="sharded")),
    "ep_sharded_top2": ({"expert": -1}, dict(_MOE, moe_dispatch="sharded", moe_topk=2)),
    "pp": ({"pipeline": -1}, dict(pipeline_axis="pipeline")),
}
# Each config's single-process reference: (kind, BertConfig fields, row groups).
REFERENCE = {"tp": "dense", "ring": "dense", "ulysses": "dense", "pp": "dense",
             "ep_replicated": "moe1", "ep_alltoall": "moe1", "ep_sharded": "moe1_groups",
             "ep_sharded_top2": "moe2_groups"}
# TP, the ring and Ulysses time two steps: their third paid for the MoE
# and pipeline layouts in chip_smoke.py's budget.
SHORT = ("tp", "ring", "ulysses")


def steps(name: str) -> int:
    """The timed steps of a config."""
    return STEPS - 1 if name in SHORT else STEPS


def reference_kinds(world: int) -> dict:
    """Each reference kind's ``(BertConfig fields, row groups)``: the
    sharded dispatch routes one group a rank."""
    return {"dense": ({}, 1), "moe1": (dict(moe_experts=EXPERTS), 1),
            "moe1_groups": (dict(moe_experts=EXPERTS), world),
            "moe2_groups": (dict(moe_experts=EXPERTS, moe_topk=2), world)}


FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The raw backend calls of the collectives phase, by the name the port's
# collective uses them under.
RAW_OPS = ("psum", "psum_bf16", "all_gather", "all_to_all")
BACKENDS = ("nccl", "gloo")


def geometry(args) -> dict:
    """BertConfig fields of the run: the defaults (BERT-base, 512
    positions) unless cut."""
    over = {}
    for flag, field in (("layers", "num_layers"), ("hidden", "hidden_size"),
                        ("heads", "num_heads"), ("vocab", "vocab_size"),
                        ("seq_len", "max_position")):
        if getattr(args, flag):
            over[field] = getattr(args, flag)
    if args.hidden:
        over["intermediate_size"] = 4 * args.hidden
    return over


def config(geom: dict, name: str | None, world: int, *, dtype, dropout: float,
           capacity: float = CAPACITY, extra: dict | None = None):
    fields = dict(geom, dtype=dtype, dropout_rate=dropout, moe_capacity_factor=capacity,
                  **(extra or {}))
    if name is not None:
        fields.update(CONFIGS[name][1])
        for axis, size in (("model", "model_parallel"), ("expert", "expert_parallel"),
                           ("pipeline", "pipeline_parallel")):
            if f"{axis}_axis" in fields:
                fields[size] = world
        if "pipeline_axis" in fields:
            fields["pipeline_microbatches"] = 4 * world
    return bert.BertConfig(**fields)


def fixed_batch(cfg, rows: int, device) -> dict:
    """The run's one global batch (seeded ``SyntheticMLM``): this rank's
    sequence slice of it under sequence parallelism, its rows under the
    sharded MoE dispatch."""
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=cfg.vocab_size, seq_len=cfg.max_position,
                                           seed=SEED))
    return next(mlm_device_batches(data, rows, device=device, seed=SEED,
                                   seq_sharded=cfg.seq_axis is not None,
                                   expert_sharded=cfg.moe_dispatch == "sharded"))


def grouped(loss_fn, groups: int):
    """``loss_fn`` averaged over ``groups`` equal row groups of the batch
    (the sharded dispatch's routing groups and its mean over them)."""
    if groups == 1:
        return loss_fn

    def fn(params, model_state, batch, generator):
        n = batch["nsp_label"].shape[0] // groups
        outs = [loss_fn(params, model_state, {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                        generator) for i in range(groups)]
        metrics = {k: sum(o[1][1][k] for o in outs) / groups for k in outs[0][1][1]}
        return sum(o[0] for o in outs) / groups, (model_state, metrics)

    return fn


def recipe(fp32: bool) -> tuple[Transform, float]:
    """``(tx, clip_norm)``: SGD 0.1 for the fp32 parameter check (the
    update is the gradient, scaled), else bert_base's AdamW 1e-4 with decay
    0.01 and clipping at 1.0."""
    if fp32:
        return Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1),
                         lambda c: 0.1), 0.0
    from distributed_tensorflow_tpu_torch.cli.train import _decay_mask

    def make(params):
        mask = _decay_mask(params)
        groups = [{"params": [p for n, p in params.items() if mask[n]], "weight_decay": 0.01},
                  {"params": [p for n, p in params.items() if not mask[n]],
                   "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)

    return Transform(make, lambda c: 1e-4), 1.0


def build(cfg, device, groups: int = 1):
    """``(model, state, step, specs)`` from the seeded global parameters."""
    model = bert.BertForPreTraining(cfg, device=device, seed=SEED)
    params = dict(model.named_parameters())
    specs = None
    if cfg.model_parallel > 1 or cfg.expert_parallel > 1 or cfg.pipelined:
        specs = bert.bert_param_specs(params, cfg.model_axis, cfg.expert_axis,
                                      cfg.pipeline_axis)
    tx, clip = recipe(cfg.dtype == torch.float32)
    state = create_train_state(params, tx)
    step = make_train_step(grouped(bert.make_bert_pretraining_loss(model), groups), tx,
                           clip_norm=clip, param_specs=specs,
                           batch_axes=("expert",) if cfg.moe_dispatch == "sharded" else ())
    return model, state, step, specs


def held_steps(geom, name, world, rows, device, extra=None, groups: int = 1):
    """The two held steps of one layout (``name`` None: unsharded, one
    process, with ``extra`` fields over ``groups`` row groups): bf16
    ``(loss, grad_norm)``, and the fp32 step's parameters with their specs:
    on a rank its own slices (``specs`` says how they lie in the global
    tree; rank 0 keeps the replicated leaves, the others only the sharded
    ones), unsharded the whole tree."""
    out = {}
    for key, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg = config(geom, name, world, dtype=dtype, dropout=0.0, capacity=HELD_CAPACITY,
                     extra=extra)
        _, state, step, specs = build(cfg, device, groups)
        state, m = step(state, fixed_batch(cfg, rows, device),
                        torch.Generator(device).manual_seed(SEED))
        if key == "bf16":
            out[key] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        else:
            specs = specs or {}
            keep = mesh_lib.process_index() == 0
            out[key] = {"params": {k: v.detach().cpu() for k, v in state.params.items()
                                   if keep or specs.get(k)}, "specs": specs}
        del state, step
    return out


def single_process_references(geom: dict, rows: int, device="cuda", world: int = 2) -> dict:
    """:func:`held_steps` unsharded, in this process (no process group),
    for each kind of :func:`reference_kinds` of a ``world``-rank job, with
    the kind's initial parameters under ``"init"``."""
    out = {}
    for kind, (extra, groups) in reference_kinds(world).items():
        out[kind] = held_steps(geom, None, 1, rows, device, extra, groups)
        cfg = config(geom, None, 1, dtype=torch.float32, dropout=0.0, extra=extra)
        out[kind]["init"] = {k: v.detach().cpu() for k, v in bert.BertForPreTraining(
            cfg, device=device, seed=SEED).state_dict().items()}
        if device != "cpu" and torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


class CommTimer:
    """Times every call of the collectives' transport functions (the
    all-reduce, the ring shift, the all-to-all and the all-gather, host
    staging included), each between two synchronisations of the device,
    while ``on``; ``by_name`` splits the seconds by function (``_shift``: the ring's and
    the pipeline's hand-offs). The synchronisations are the timer's cost:
    they stop each rank at every collective."""

    NAMES = ("_all_reduce", "_shift", "_a2a", "_gather")

    def __init__(self, device):
        self.device, self.seconds, self.calls, self.on = device, 0.0, 0, False
        self.by_name = dict.fromkeys(self.NAMES, 0.0)
        for name in self.NAMES:
            setattr(coll, name, self._wrap(name, getattr(coll, name)))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            dt = time.perf_counter() - t0
            self.seconds += dt
            self.by_name[name] += dt
            self.calls += 1
            return out

        return timed


def timed_steps(geom, name, world, rows, device, n_steps, timer, plain_steps: int = 0) -> dict:
    """``n_steps`` bf16 steps with dropout 0.1: flash launches, ms and the
    collectives' ms of each step, and the losses; then ``plain_steps`` more
    with the timer off (``step_ms_plain``: the step without its
    synchronisations)."""
    cfg = config(geom, name, world, dtype=torch.bfloat16, dropout=0.1)
    _, state, step, _ = build(cfg, device)
    batch = fixed_batch(cfg, rows, device)
    gen = torch.Generator(device).manual_seed(SEED)
    fm.reset_launch_counts()
    launches, step_ms, comm_ms, shift_ms, losses, aux = [], [], [], [], [], []
    for _ in range(n_steps):
        before = dict(fm.LAUNCHES)
        timer.seconds, timer.calls, timer.on = 0.0, 0, True
        timer.by_name = dict.fromkeys(timer.NAMES, 0.0)
        timer._sync()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        if "moe_aux" in m:
            aux.append(float(m["moe_aux"]))
        timer._sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        timer.on = False
        comm_ms.append(timer.seconds * 1e3)
        shift_ms.append(timer.by_name["_shift"] * 1e3)
        launches.append({k: fm.LAUNCHES[k] - before[k] for k in FLASH})
    plain_ms = []
    for _ in range(plain_steps):
        timer._sync()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
        timer._sync()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    return {"launches": launches, "step_ms": step_ms, "comm_ms": comm_ms,
            "step_ms_plain": plain_ms,
            "step_ms_plain_median": statistics.median(plain_ms) if plain_ms else None,
            "ppermute_ms": shift_ms, "collective_calls": timer.calls, "losses": losses,
            "moe_aux": aux, "step_ms_median": statistics.median(step_ms[1:] or step_ms),
            "comm_ms_median": statistics.median(comm_ms[1:] or comm_ms),
            "ppermute_ms_median": statistics.median(shift_ms[1:] or shift_ms)}


def _inputs(rank: int, device) -> torch.Tensor:
    g = np.random.default_rng(100 + rank).standard_normal((4, 6)).astype(np.float32)
    return torch.from_numpy(g).to(device)


def collectives_check(rank: int, world: int, device) -> dict:
    """Every model-parallel collective on device tensors over ``"seq"``,
    values and gradients against the arithmetic done here on every rank's
    inputs; then the raw backend calls."""
    mesh_lib.build_mesh({"seq": world})
    xs = [_inputs(r, device) for r in range(world)]
    total = sum(xs)
    w = {r: torch.arange(24.0, device=device).reshape(4, 6) + r for r in range(world)}
    expect = {
        "psum": (total, sum(w.values())),
        "ppermute": (xs[(rank - 1) % world], w[(rank + 1) % world]),
        "all_to_all": (torch.cat([x.chunk(world, 0)[rank] for x in xs], 1), None),
        "all_gather": (torch.cat(xs, 1), None),
    }
    fns = {"psum": lambda x: coll.psum(x, "seq"),
           "ppermute": lambda x: coll.ppermute(x, "seq", 1),
           "all_to_all": lambda x: coll.all_to_all(x, "seq", 0, 1),
           "all_gather": lambda x: coll.all_gather(x, "seq", 1)}
    errors = {}
    for name, fn in fns.items():
        x = xs[rank].clone().requires_grad_()
        y = fn(x)
        weight = torch.arange(y.numel(), dtype=torch.float32, device=device).reshape(y.shape)
        (y * (weight + rank)).sum().backward()
        want_y, want_g = expect[name]
        err = float((y.detach() - want_y).abs().max())
        if want_g is not None:
            err = max(err, float((x.grad - want_g).abs().max()))
        errors[name] = err
    tree = {"a": xs[rank], "b": [xs[rank].double()]}
    mean = coll.pmean_tree(tree, "seq")
    errors["pmean_tree"] = max(float((mean["a"] - total / world).abs().max()),
                               float((mean["b"][0] - (total / world).double()).abs().max()))
    raw = {}
    for op in RAW_OPS:
        try:
            x = xs[rank].clone()
            if op == "psum":
                dist.all_reduce(x)
                ok = torch.allclose(x, total, atol=1e-5)
            elif op == "psum_bf16":
                x = x.bfloat16()
                dist.all_reduce(x)
                ok = torch.allclose(x.float(), total, atol=0.1)
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = torch.equal(torch.cat(parts), torch.cat(xs))
            else:
                send = torch.stack(x.chunk(world, 0)).contiguous()
                recv = torch.empty_like(send)
                dist.all_to_all_single(recv, send)
                ok = torch.equal(torch.cat(recv.unbind(0), 1), expect["all_to_all"][0])
            raw[op] = "ok" if ok else "wrong values"
        except Exception as e:  # the backend's refusal, recorded
            raw[op] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return {"max_abs_err": errors, "raw_device_ops": raw,
            "host_staged": sorted(coll.GLOO_HOST_STAGED)}


def backend_flag(argv: list[str]) -> str | None:
    """Take ``--backend NAME`` out of ``argv`` (in place) and return NAME,
    None when it is absent; a name but :data:`BACKENDS` exits 2."""
    p = argparse.ArgumentParser(prog="torch_mp_train.py", add_help=False,
                                allow_abbrev=False)
    p.add_argument("--backend", choices=BACKENDS)
    args, rest = p.parse_known_args(argv)
    argv[:] = rest
    return args.backend


def _pin_backend(backend: str | None) -> None:
    """Make the CLI's ``initialize_runtime`` start its group on ``backend``
    (None: its own default)."""
    if backend is not None:
        mesh_lib.initialize_runtime = functools.partial(mesh_lib.initialize_runtime,
                                                        backend=backend)


def run_cli(argv: list[str]) -> int:
    from distributed_tensorflow_tpu_torch.cli import train as cli

    base = cli.PRESETS["bert_base"]
    cli.PRESETS["bert_base_l512"] = dataclasses.replace(
        base, name="bert_base_l512", build=cli._build_bert_workload(
            dict(max_position=512, dropout_rate=0.1, dtype=torch.bfloat16)))
    _pin_backend(backend_flag(argv))
    return cli.main(argv)


def run_serve(argv: list[str]) -> int:
    from distributed_tensorflow_tpu_torch.cli import serve as cli
    from distributed_tensorflow_tpu_torch.serve import engine as engine_mod
    from distributed_tensorflow_tpu_torch.serve import group as group_mod

    gate = None
    if "--comm-timer-file" in argv:
        i = argv.index("--comm-timer-file")
        gate = Path(argv[i + 1])
        del argv[i:i + 2]
    log = None
    if "--launch-log" in argv:
        i = argv.index("--launch-log")
        rank = os.environ.get("RANK") or (
            argv[argv.index("--process-id") + 1] if "--process-id" in argv else "0")
        log = Path(argv[i + 1].replace("{rank}", rank))
        del argv[i:i + 2]
        Path(f"{log}.pid").write_text(str(os.getpid()))
    cli.PRESETS["bert_base_l512_f32"] = cli.ServePreset(
        "bert_base_l512_f32", bert_kwargs=dict(max_position=512, dropout_rate=0.1,
                                               dtype=torch.float32))
    cli.PRESETS["lm_base_f32"] = cli.ServePreset(
        "lm_base_f32", causal_kwargs=dict(max_position=128, dtype=torch.float32))
    _pin_backend(backend_flag(argv))
    # SIGUSR1 prints every thread's stack to the rank's log (where a stuck
    # rank waits).
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    timer = CommTimer(torch.device("cuda" if torch.cuda.is_available() else "cpu"))
    engines = []
    start = engine_mod._AotEngine._start_group

    def started(engine):
        # The end of the warm-up: count what the served requests launch.
        fm.reset_launch_counts()
        timer.on = True
        engines.append(engine)
        start(engine)

    engine_mod._AotEngine._start_group = started
    if gate is not None:
        # The gate is read once a cell, as each rank takes the cell from
        # the control channel: a cell's collectives are timed while it
        # exists.
        for name in ("_send", "_recv"):
            def gated(group, *args, _channel=getattr(group_mod.ServingGroup, name)):
                timer.on = gate.exists()
                return _channel(group, *args)

            setattr(group_mod.ServingGroup, name, gated)
    rc = cli.main(argv)
    if log is not None:
        group = engines[-1].group if engines else None
        log.write_text(json.dumps({
            "rc": rc, "launches": {k: fm.LAUNCHES[k] for k in FLASH},
            "comm_s": timer.seconds, "comm_calls": timer.calls,
            "group": group.status() if group is not None else None}))
    return rc


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "--cli":
        return run_cli(argv[1:])
    if argv and argv[0] == "--serve":
        return run_serve(argv[1:])
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="the process group's backend (default: NCCL on a card, gloo on "
                        "the CPU; gloo for several ranks on one card)")
    p.add_argument("--rows", type=int, default=ROWS, help="the fixed global batch")
    p.add_argument("--plain-steps", type=int, default=0,
                   help="steps after the timed ones with the collectives' timer off")
    for flag in ("layers", "hidden", "heads", "vocab", "seq-len"):
        p.add_argument(f"--{flag}", type=int, default=0)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(args.out)
    t0 = time.perf_counter()
    device = mesh_lib.initialize_runtime(f"127.0.0.1:{args.port}", args.world, args.rank,
                                         device=args.device, backend=args.backend,
                                         timeout_s=120)
    timer = CommTimer(device)
    result = {"rank": args.rank, "init_s": time.perf_counter() - t0,
              "backend": dist.get_backend(), "device": str(device), "rows": args.rows}
    t0 = time.perf_counter()
    result["collectives"] = collectives_check(args.rank, args.world, device)
    result["collectives"]["seconds"] = time.perf_counter() - t0
    geom = geometry(args)
    result["configs"] = {}
    for name in CONFIGS:
        t0 = time.perf_counter()
        axes = {a: args.world if n == -1 else n for a, n in CONFIGS[name][0].items()}
        mesh_lib.build_mesh(axes)
        held = held_steps(geom, name, args.world, args.rows, device)
        torch.save(held["fp32"], out_dir / f"params_{name}_rank{args.rank}.pt")
        rec = {"held_bf16": held["bf16"]}
        rec.update(timed_steps(geom, name, args.world, args.rows, device, steps(name), timer,
                               args.plain_steps))
        rec["seconds"] = time.perf_counter() - t0
        result["configs"][name] = rec
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        result["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    (out_dir / f"rank{args.rank}.json").write_text(json.dumps(result))
    mesh_lib.shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
