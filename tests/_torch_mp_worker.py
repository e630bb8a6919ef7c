"""One rank of the port's multi-process tests (``tests/test_torch_multiprocess.py``).

    python tests/_torch_mp_worker.py JOB RANK WORLD OUT_DIR PORTS [ARGV_JSON]

``PORTS`` is a comma-separated list of free localhost ports, one a process
group the job starts. Every job runs on the CPU over gloo, imports only
torch, numpy and the port, and saves its results to
``OUT_DIR/<job>_rank<RANK>.pt``:

- ``collectives``: the bucketed psum/pmean beside a per-leaf reduction
  written here as the reference, and every other collective on seeded
  inputs (saved too, for the JAX side of the test);
- ``dropout``: a 1-layer BERT with dropout 0.1 trained 2 steps through
  ``fit`` with a checkpoint at step 1, then restored from it and step 2
  run again; the dropout masks each step drew;
- ``cli``: ``cli.train.main`` once for each argv of ``ARGV_JSON`` (a JSON
  list of lists), each as a new process group on the next port, and the
  final state of each run with the number of checkpoint files this rank
  wrote;
- ``chaos``: LeNet trained 16 steps through ``fit`` with the flight
  recorder, a fault injector, checkpoints every 4 steps into
  ``OUT_DIR/ckpt_<RANK>`` and a health beacon into ``OUT_DIR/beacons``. The
  two processes share NO process group: the beacons, checkpoints and dumps
  are their only channels, so the survivor cannot hang in a collective.
  Rank 0's plan holds ``slow_step`` at 5 and ``host_drop`` at 11: it dumps
  its recorder into ``OUT_DIR/dumps_0`` and dies by SIGKILL mid-run; rank 1
  runs fault-free to the end;
- ``elastic``: LeNet trained 2 steps as two gloo ranks (16 rows each of a
  global batch of 32), rank 0 checkpointing step 2 into
  ``OUT_DIR/elastic_ckpt``;
- ``mp_attn`` (2 ranks, ``tests/test_torch_model_parallel.py``): on a
  ``{"seq": 2}`` mesh the differentiable collectives, ring attention (einsum
  and flash inners, masks, fully masked rows, bf16) and Ulysses (dense and
  flash inners, the refusal of indivisible heads), each with the gradients
  of ``sum(sin(out))`` for q, k and v, on :func:`attn_inputs`; the dropout
  masks of a ``{"model": 2}`` and a ``{"seq": 2}`` BERT step; then
  ``cli.train.main`` with ``--tensor-parallel 2`` (the BERT preset with
  dropout off, see :func:`no_dropout`) and with ``--config mnist_lenet
  --tensor-parallel 2`` (refused, exit 2);
- ``mp_bert`` (4 ranks): :data:`MP_GEOM` BERT trained 2 AdamW steps from
  the global seeded parameters under each of :data:`MP_RUNS` (TP, TP with
  clipping, the ring, Ulysses, TP x ring); per step loss and grad_norm, the
  gathered global parameters, and for the TP run a checkpoint written
  through ``Checkpointer(param_specs=...)`` into ``OUT_DIR/tp_ckpt`` and
  restored into a fresh TP state;
- ``mp_moe`` (2 ranks, ``tests/test_torch_moe.py``): on an ``{"expert": 2}``
  mesh the toy MoE of :func:`moe_toy_params`: ``moe_apply`` top-1, top-2
  and ``moe_apply_a2a`` top-2 on seeded tokens, and 3 SGD steps of the toy
  classifier (router, experts, head) with its per-step loss, grad_norm and
  gathered parameters;
- ``mp_pipe`` (4 ranks, ``tests/test_torch_pipeline.py``): on a
  ``{"pipeline": 4}`` mesh the toy stack of :func:`pipe_params` forward
  under every ``mask_bubble``, the refusals of a bad microbatch split and
  of ``mask_bubble="off"``, 3 SGD steps of the toy classifier; on a
  ``{"pipeline": 2, "seq": 2}`` mesh a layer that runs a ``"seq"`` ring
  inside the stage, masked and unmasked;
- ``mp_moe_pp`` (4 ranks, ``tests/test_torch_bert_moe_pp.py``): :data:`MP_GEOM`
  BERT trained 2 Adam steps under each of :data:`MOE_PP_RUNS` (expert,
  tensor, pipeline and sequence layouts and their compositions); the
  routing of every layer at step 1 of the ``ep`` run; an eval step of the
  ``sharded`` and ``dp4_moe`` runs; the ``pp_ep`` run's
  checkpoint in ``OUT_DIR/ppep_ckpt``; then ``cli.train.main`` under
  ``--moe-experts 4 --expert-parallel 2 --pipeline-parallel 2`` (dropout off)
  and two requests it refuses;
- ``serve_mesh`` (4 ranks, ``tests/test_torch_serve_mesh.py``): a
  :data:`SERVE_BERT_GEOM` BERT served by ``BertInferenceEngine`` over a
  serving group under each of :data:`SERVE_LAYOUTS` (TP, EP and PP, each
  beside a data axis of 2, and TP and EP at int8): rank 0 leads and
  answers 1 and 4 of :func:`serve_payloads`, the others follow; the TP
  engine also behind a ``Client`` and ``/statusz``. Then ``cli.serve.main``
  with ``ARGV_JSON`` as a 4-rank group on the next port;
- ``causal_tp`` (2 ranks, ``tests/test_torch_causal_tp.py``): on a
  ``{"data": 1, "model": 2}`` mesh the :data:`CAUSAL_TP_GEOM` causal LM
  trained 2 SGD steps under TP on :func:`lm_batch`; the decode engine,
  the prefix-cache engine and the int8 weights + KV engine over a serving
  group, rank 0 running the JAX tests' mixed, shared-prefix and
  teacher-forced request sets (and the page export/import cells, whole
  heads on the wire, round trip); then ``cli.train --config lm_base
  --tensor-parallel 2`` and ``cli.serve --tp 2 --selftest`` on its
  checkpoint, each as a group on the next port; last, a group whose
  follower exits (code 3) after warm-up, and the leader's next cells;
- ``migrate_tp`` (2 ranks, ``tests/test_torch_migrate.py``): a
  ``{"model": 2}`` serving group of the :data:`CAUSAL_TP_GEOM` LM with the
  slot export/import cells, and on rank 0 a one-process engine of the same
  LM: a stream exported mid-generation from the one process is adopted by
  the group (``into_group``), and one exported from the group is adopted
  by the one process (``out_of_group``), each with the one process's
  uninterrupted stream as its reference;
- ``axis4_train`` (4 ranks, ``tests/test_torch_axis4.py``): one Adam step
  of the :data:`MP_GEOM` BERT under each of :data:`AXIS4_RUNS`, every
  layout on one axis of 4 (TP, Ulysses, the ring with its einsum and
  flash inners, EP under the four dispatches, PP), with the gathered
  parameters and whether the axis's group is the world group;
- ``axis4_serve`` (4 ranks, the same test): the :data:`SERVE_BERT_GEOM`
  BERT served under each of :data:`AXIS4_SERVE` (TP 4, EP 4, PP 4), then
  the :data:`CAUSAL4_GEOM` causal LM's mixed requests over a ``{"model":
  4}`` serving group;
- ``stuck_follower`` (2 ranks, ``tests/test_torch_causal_tp.py``): a
  serving group whose follower lives but never takes a cell; the leader's
  two cells and how each failed.
"""

from __future__ import annotations

import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.parallel import collectives as coll  # noqa: E402
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: E402
    initialize_runtime,
    shutdown_runtime,
)


def _cpu(tree):
    return coll._map(lambda x: x.detach().clone(), tree)


def job_collectives(rank: int, world: int, ports: list[int], argv) -> dict:
    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    rng = np.random.default_rng(100 + rank)
    tree = {
        "w": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
        "b": [torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((2, 3)))],  # float64: its own bucket
        "s": torch.tensor(float(rng.standard_normal()), dtype=torch.float32),
    }

    def per_leaf(x, mean):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y / world if mean else y

    x = tree["w"]
    global_batch = {"image": torch.arange(24.0).reshape(8, 3), "label": torch.arange(8)}
    out = {
        "tree": _cpu(tree),
        "psum": _cpu(coll.psum_tree(tree)),
        "pmean": _cpu(coll.pmean_tree(tree)),
        "psum_per_leaf": coll._map(lambda t: per_leaf(t, False), tree),
        "pmean_per_leaf": coll._map(lambda t: per_leaf(t, True), tree),
        "gather0": coll.all_gather_tree(x, axis=0),
        "gather1": coll.all_gather_tree(x, axis=1),
        "stack0": coll.all_gather_tree(x, axis=0, tiled=False),
        "scatter0": coll.reduce_scatter_mean_tree(x, axis=0),
        "scatter1": coll.reduce_scatter_mean_tree(x, axis=1),
        "ring": coll.ppermute_ring(x),
        "ring_back": coll.ppermute_ring(x, shift=-1),
        "index": coll.axis_index("data"),
        "size": coll.axis_size("data"),
        "replicated": _cpu(coll.replicate(tree)),
        "shard": coll.shard_batch(global_batch),
    }
    shutdown_runtime()
    return out


def job_dropout(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.train import create_train_state, fit, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    masks: list[torch.Tensor] = []
    draw = bert.dropout

    def recording(x, rate, train, generator):
        y = draw(x, rate, train, generator)
        if train and rate > 0:
            masks.append(y == 0)
        return y

    bert.dropout = recording
    cfg = bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                          intermediate_size=64, max_position=16, dropout_rate=0.1)
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=64, seq_len=16, seed=7))
    batches = list(itertools.islice(mlm_device_batches(data, 16, device="cpu", seed=1), 2))
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1), lambda count: 0.1)

    def build():
        model = bert.BertForPreTraining(cfg, device="cpu", seed=0)
        state = create_train_state(dict(model.named_parameters()), tx)
        return state, make_train_step(bert.make_bert_pretraining_loss(model), tx)

    ckpt = Checkpointer(out_dir / "dropout_ckpt")
    state, step = build()
    rng = torch.Generator().manual_seed(0)
    fit(state, step, iter(batches), num_steps=1, rng=rng, log_every=0,
        checkpointer=ckpt, ckpt_every=1)
    masks.clear()
    fit(state, step, iter(batches[1:]), num_steps=2, rng=rng, log_every=0)
    first = list(masks)
    resumed, step2 = build()
    rng2 = torch.Generator().manual_seed(0)
    resumed, start = ckpt.restore_latest(resumed, generator=rng2)
    masks.clear()
    fit(resumed, step2, iter(batches[1:]), num_steps=2, rng=rng2, log_every=0)
    out = {"first": first, "again": list(masks), "start": start,
           "params": _cpu(state.params), "resumed_params": _cpu(resumed.params)}
    shutdown_runtime()
    return out


def job_cli(rank: int, world: int, ports: list[int], argv) -> dict:
    from distributed_tensorflow_tpu_torch.ckpt import checkpoint
    from distributed_tensorflow_tpu_torch.cli import train as cli

    runs = []
    for port, args in zip(ports, argv):
        captured, writes = {}, []
        run, write = cli.run, checkpoint._write

        def capture(cfg, ns, run=run, captured=captured):
            state, last = run(cfg, ns)
            captured["state"] = state
            return state, last

        def counted(directory, step, blob, write=write, writes=writes):
            writes.append(step)
            return write(directory, step, blob)

        cli.run, checkpoint._write = capture, counted
        try:
            code = cli.main(args + [
                "--device", "cpu", "--coordinator-address", f"127.0.0.1:{port}",
                "--num-processes", str(world), "--process-id", str(rank),
                "--init-timeout", "60"])
        finally:
            cli.run, checkpoint._write = run, write
        state = captured["state"]
        runs.append({"code": code, "step": state.step, "writes": writes,
                     "params": _cpu(state.params), "model_state": _cpu(state.model_state),
                     "grad_buffer": _cpu(state.grad_buffer or {}),
                     "buffer_index": state.buffer_index})
    return {"runs": runs}


def attn_inputs(case: str):
    """Seeded global ``(q, k, v, mask)`` numpy arrays of a ``mp_attn`` case
    ``[B, L, H, D]`` (mask ``[B, L]`` or None)."""
    b, l, h, d = (2, 32, 4, 16)
    rng = np.random.default_rng({"ring": 0, "mask": 1, "bf16": 3, "flash": 4,
                                 "uly": 5, "masked": 2}[case])
    q, k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))
    mask = None
    if case in ("mask", "flash", "uly"):
        mask = np.ones((b, l), bool)
        mask[0, 22:] = False
        mask[1, 5:9] = False
    if case == "masked":
        mask = np.ones((b, l), bool)
        mask[1, :] = False
    return q, k, v, mask


# The attention cases of mp_attn: (inputs, implementation, inner, dtype).
ATTN_CASES = {
    "ring": ("ring", "ring", "einsum", "float32"),
    "ring_mask": ("mask", "ring", "einsum", "float32"),
    "ring_masked_rows": ("masked", "ring", "einsum", "float32"),
    "ring_bf16": ("bf16", "ring", "einsum", "bfloat16"),
    "ring_flash": ("flash", "ring", "flash", "float32"),
    "ulysses_dense": ("uly", "ulysses", "dense", "float32"),
    "ulysses_flash": ("uly", "ulysses", "flash", "float32"),
}

MP_GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position=32, dropout_rate=0.0)
# mp_bert's runs: (mesh, BertConfig fields, clip_norm).
MP_RUNS = {
    "tp": ({"data": 2, "model": 2}, dict(model_axis="model", model_parallel=2), 0.0),
    "tp_clip": ({"data": 2, "model": 2}, dict(model_axis="model", model_parallel=2), 0.05),
    "ring": ({"data": 2, "seq": 2}, dict(seq_axis="seq"), 0.0),
    "ulysses": ({"data": 2, "seq": 2}, dict(seq_axis="seq", sp_impl="ulysses"), 0.0),
    "tp_sp": ({"seq": 2, "model": 2},
              dict(model_axis="model", model_parallel=2, seq_axis="seq"), 0.0),
}
MP_BATCH, MP_STEPS, MP_LR = 16, 2, 1e-3
TP_CLI_ARGS = ["--config", "bert_base", "--bert-layers", "1", "--bert-hidden", "48",
               "--bert-vocab", "64", "--global-batch", "8", "--steps", "2",
               "--lr-schedule", "constant", "--lr", "1e-3", "--log-every", "1"]


def no_dropout(bert_module):
    """Patch ``bert_module.BertConfig`` so every config built through it has
    dropout off (the CLI presets' 0.1 would draw masks the two packages
    cannot share); returns the undo."""
    real = bert_module.BertConfig

    def config(*args, **kwargs):
        return real(*args, **{**kwargs, "dropout_rate": 0.0})

    bert_module.BertConfig = config
    return lambda: setattr(bert_module, "BertConfig", real)


def _attn_case(name: str, axis: str = "seq") -> dict:
    from distributed_tensorflow_tpu_torch.parallel import collectives as pc
    from distributed_tensorflow_tpu_torch.parallel.ring_attention import ring_attention
    from distributed_tensorflow_tpu_torch.parallel.ulysses import ulysses_attention

    inputs, impl, inner, dtype = ATTN_CASES[name]
    q, k, v, mask = attn_inputs(inputs)
    n, i = pc.axis_size(axis), pc.axis_index(axis)
    width = q.shape[1] // n
    cols = slice(i * width, (i + 1) * width)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(x[:, cols])).to(dt).requires_grad_()
               for x in (q, k, v))
    m = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask[:, cols]))
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(q, k, v, axis, mask=m, inner=inner)
    torch.sin(out.float()).sum().backward()
    return {"out": out.detach().float(), "dq": q.grad.float(), "dk": k.grad.float(),
            "dv": v.grad.float()}


def _collectives_on_seq(rank: int) -> dict:
    """psum, ppermute, all_to_all and all_gather on a {"seq": 2} mesh, with
    the gradients of a weighted sum of each output."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as pc

    rng = np.random.default_rng(50 + rank)
    out = {}
    for name, fn in (("psum", lambda x: pc.psum(x, "seq")),
                     ("ppermute", lambda x: pc.ppermute(x, "seq", 1)),
                     ("all_to_all", lambda x: pc.all_to_all(x, "seq", 0, 1)),
                     ("all_gather", lambda x: pc.all_gather(x, "seq", 1))):
        x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).requires_grad_()
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) + rank
        (y * w).sum().backward()
        out[name] = {"x": x.detach(), "y": y.detach(), "grad": x.grad}
    return out


def _dropout_masks(spec: dict, over: dict) -> list:
    """The dropout masks one step of a tiny BERT draws on ``spec``'s mesh."""
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    build_mesh(spec)
    masks: list[torch.Tensor] = []
    draw = bert.dropout

    def recording(x, rate, train, generator):
        y = draw(x, rate, train, generator)
        if train and rate > 0:
            masks.append(y == 0)
        return y

    bert.dropout = recording
    try:
        cfg = bert.BertConfig(**{**MP_GEOM, "dropout_rate": 0.1, **over})
        model = bert.BertForPreTraining(cfg, device="cpu", seed=0)
        tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1), lambda c: 0.1)
        state = create_train_state(dict(model.named_parameters()), tx)
        step = make_train_step(bert.make_bert_pretraining_loss(model), tx)
        data = SyntheticMLM(SyntheticMLMConfig(vocab_size=128, seq_len=32, seed=7))
        batch = next(mlm_device_batches(data, 8, device="cpu", seed=1,
                                        seq_sharded="seq_axis" in over))
        step(state, batch, torch.Generator().manual_seed(0))
    finally:
        bert.dropout = draw
    return masks


def job_mp_attn(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.cli import train as cli
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.parallel.ulysses import ulysses_attention

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    build_mesh({"seq": 2})
    out = {"collectives": _collectives_on_seq(rank),
           "attn": {name: _attn_case(name) for name in ATTN_CASES}}
    try:
        x = torch.zeros((1, 4, 3, 8))
        ulysses_attention(x, x, x, "seq")
    except ValueError as e:
        out["ulysses_refusal"] = str(e)
    out["masks_model"] = _dropout_masks({"model": 2}, dict(model_axis="model",
                                                           model_parallel=2))
    out["masks_seq"] = _dropout_masks({"seq": 2}, dict(seq_axis="seq"))
    shutdown_runtime()
    codes, lines = [], []
    undo = no_dropout(bert)
    try:
        for port, args in zip(ports[1:], (["--config", "mnist_lenet", "--global-batch", "8",
                                          "--steps", "1", "--tensor-parallel", "2"],
                                         TP_CLI_ARGS + ["--tensor-parallel", "2",
                                                        "--metrics-jsonl",
                                                        str(out_dir / f"tp_cli_{rank}.jsonl")])):
            try:
                codes.append(cli.main(args + [
                    "--device", "cpu", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", str(world), "--process-id", str(rank),
                    "--init-timeout", "60"]))
            except SystemExit as e:
                codes.append(e.code)
    finally:
        undo()
    out["cli_codes"] = codes
    return out


def _gathered(params: dict, specs, mesh) -> dict:
    from distributed_tensorflow_tpu_torch.interop import gather_params

    params = {k: v.detach() for k, v in params.items()}
    return _cpu(gather_params(params, specs, mesh) if specs else params)


def job_mp_bert(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    tx = Transform(lambda p: torch.optim.Adam(list(p.values()), lr=MP_LR, betas=(0.9, 0.999),
                                              eps=1e-8), lambda c: MP_LR)
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=128, seq_len=32, seed=0))
    out = {}
    for name, (spec, over, clip) in MP_RUNS.items():
        mesh = build_mesh(spec)
        model = bert.BertForPreTraining(bert.BertConfig(**MP_GEOM, **over), device="cpu",
                                        seed=0)
        params = dict(model.named_parameters())
        specs = bert.bert_param_specs(params) if "model_axis" in over else None
        state = create_train_state(params, tx)
        step = make_train_step(bert.make_bert_pretraining_loss(model), tx, clip_norm=clip,
                               param_specs=specs)
        batches = mlm_device_batches(data, MP_BATCH, device="cpu", seed=3,
                                     seq_sharded="seq_axis" in over)
        metrics = []
        for _ in range(MP_STEPS):
            state, m = step(state, next(batches), torch.Generator().manual_seed(1))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        out[name] = {"metrics": metrics, "params": _gathered(state.params, specs, mesh)}
        if name == "tp":
            ckpt = Checkpointer(out_dir / "tp_ckpt", param_specs=specs)
            ckpt.save(state.step, state)
            ckpt.wait()
            fresh = create_train_state(dict(bert.BertForPreTraining(
                bert.BertConfig(**MP_GEOM, **over), device="cpu", seed=1).named_parameters()),
                tx)
            fresh, start = ckpt.restore_latest(fresh)
            out["tp_restored"] = {
                "start": start,
                "params_equal": all(torch.equal(fresh.params[k], state.params[k])
                                    for k in state.params),
                "slots_equal": all(
                    torch.equal(a, b) for sa, sb in zip(
                        fresh.opt_state.optimizer.state_dict()["state"].values(),
                        state.opt_state.optimizer.state_dict()["state"].values())
                    for a, b in zip(sa.values(), sb.values()))}
            ckpt.close()
    shutdown_runtime()
    return out


# The toy MoE of tests/test_moe.py: tokens [N, MOE_H], MOE_E experts, a head.
MOE_H, MOE_E, MOE_CLASSES = 16, 8, 10


def moe_toy_params() -> dict:
    """Seeded numpy params of the toy MoE classifier: ``router [H, E]``,
    the expert stacks ``w1 [E, H, 2H]`` and ``w2 [E, 2H, H]``, ``head [H, C]``."""
    rng = np.random.default_rng(11)
    shapes = {"router": (MOE_H, MOE_E), "w1": (MOE_E, MOE_H, 2 * MOE_H),
              "w2": (MOE_E, 2 * MOE_H, MOE_H), "head": (MOE_H, MOE_CLASSES)}
    return {k: (rng.standard_normal(v) * 0.3).astype(np.float32) for k, v in shapes.items()}


def moe_toy_tokens(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, MOE_H)).astype(np.float32)


def moe_toy_batches(n_steps: int = 3, rows: int = 32) -> list:
    """Seeded ``(x [rows, H], labels [rows])`` a step."""
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((rows, MOE_H)).astype(np.float32),
             rng.integers(0, MOE_CLASSES, rows)) for _ in range(n_steps)]


def moe_toy_expert(p, tokens):
    return torch.bmm(torch.tanh(torch.bmm(tokens, p["w1"])), p["w2"])


def moe_toy_loss(axis_name):
    """The toy classifier's loss for ``make_train_step``: residual MoE,
    then the head; CE + 0.01 aux."""
    from distributed_tensorflow_tpu_torch.parallel.moe import moe_apply

    def loss_fn(params, model_state, batch, generator):
        x = batch["x"]
        y, aux = moe_apply(moe_toy_expert, {"w1": params["w1"], "w2": params["w2"]},
                           x @ params["router"], x, axis_name=axis_name)
        logits = (x + y) @ params["head"]
        loss = torch.nn.functional.cross_entropy(logits, batch["label"]) + 0.01 * aux
        return loss, (model_state, {"aux": aux.detach()})

    return loss_fn


def job_mp_moe(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.parallel.moe import moe_apply, moe_apply_a2a
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    mesh = build_mesh({"expert": world})
    full = {k: torch.from_numpy(v) for k, v in moe_toy_params().items()}
    local = {k: full[k].chunk(world, 0)[rank].contiguous() for k in ("w1", "w2")}
    x = torch.from_numpy(moe_toy_tokens(1, 32))
    out = {"top1": moe_apply(moe_toy_expert, local, x @ full["router"], x, axis_name="expert")}
    x2 = torch.from_numpy(moe_toy_tokens(2, 64))
    logits2 = torch.from_numpy(moe_toy_tokens(3, 64)[:, :MOE_E].copy())
    for name, fn, kw in (("top2", moe_apply, {}),
                         ("top2_a2a", moe_apply_a2a, {"stats_axes": ("expert",)})):
        out[name] = fn(moe_toy_expert, local, logits2, x2, axis_name="expert",
                       capacity_factor=16.0, topk=2, **kw)
    params = {k: (local[k] if k in local else full[k]).clone().requires_grad_()
              for k in ("router", "w1", "w2", "head")}
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1, momentum=0.9),
                   lambda c: 0.1)
    specs = {"w1": (("expert", 0),), "w2": (("expert", 0),)}
    state = create_train_state(params, tx)
    step = make_train_step(moe_toy_loss("expert"), tx, param_specs=specs)
    metrics = []
    for xb, yb in moe_toy_batches():
        state, m = step(state, {"x": torch.from_numpy(xb), "label": torch.from_numpy(yb)},
                        torch.Generator().manual_seed(0))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
    out["train"] = {"metrics": metrics, "params": _gathered(state.params, specs, mesh)}
    shutdown_runtime()
    return out


# The toy stack of tests/test_pipeline.py: PIPE_LAYERS residual tanh layers.
PIPE_D, PIPE_LAYERS, PIPE_CLASSES = 16, 8, 10


def pipe_params() -> dict:
    """Seeded numpy params: the stack ``w [L, D, D]``, ``b [L, D]`` and the
    head ``head_w [D, C]``, ``head_b [C]``."""
    rng = np.random.default_rng(21)
    return {"w": (rng.standard_normal((PIPE_LAYERS, PIPE_D, PIPE_D)) * 0.3).astype(np.float32),
            "b": np.zeros((PIPE_LAYERS, PIPE_D), np.float32),
            "head_w": (rng.standard_normal((PIPE_D, PIPE_CLASSES)) * 0.3).astype(np.float32),
            "head_b": np.zeros(PIPE_CLASSES, np.float32)}


def pipe_layer(p, h):
    return h + torch.tanh(h @ p["w"] + p["b"])


def pipe_batches(n_steps: int = 3, rows: int = 32) -> list:
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((rows, PIPE_D)).astype(np.float32),
             rng.integers(0, PIPE_CLASSES, rows)) for _ in range(n_steps)]


def pipe_ring_inputs():
    """``(w [4, D, D], x [8, 8, D])`` of the seq-ring layer case."""
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((4, PIPE_D, PIPE_D)) * 0.3).astype(np.float32),
            rng.standard_normal((8, 8, PIPE_D)).astype(np.float32))


def pipe_ring_layer(p, h):
    """A layer whose stage runs a ring over "seq" (JAX's ``ring_layer``)."""
    from distributed_tensorflow_tpu_torch.parallel import collectives as pc

    acc, kv = torch.zeros_like(h), h @ p["w"]
    for _ in range(pc.axis_size("seq")):
        acc = acc + h * kv.sum(dim=1, keepdim=True)
        kv = pc.ppermute(kv, "seq", 1)
    return torch.tanh(acc)


def job_mp_pipe(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.parallel.pipeline import pipeline_apply
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    mesh = build_mesh({"pipeline": 4})
    full = {k: torch.from_numpy(v) for k, v in pipe_params().items()}
    local = {k: full[k].chunk(4, 0)[rank].contiguous() for k in ("w", "b")}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, PIPE_D))
                         .astype(np.float32))
    out = {"forward": {str(m): pipeline_apply(pipe_layer, local, x, n_microbatches=4,
                                              mask_bubble=m)
                       for m in ("auto", True, False)}}
    for key, kw in (("bad_split", {"n_microbatches": 5}),
                    ("bad_mask", {"n_microbatches": 4, "mask_bubble": "off"})):
        try:
            pipeline_apply(pipe_layer, local, x, **kw)
        except ValueError as e:
            out[key] = str(e)

    def loss_fn(params, model_state, batch, generator):
        h = pipeline_apply(pipe_layer, {"w": params["w"], "b": params["b"]}, batch["x"],
                           n_microbatches=4)
        logits = h @ params["head_w"] + params["head_b"]
        return torch.nn.functional.cross_entropy(logits, batch["label"]), (model_state, {})

    params = {k: (local[k] if k in local else full[k]).clone().requires_grad_()
              for k in ("w", "b", "head_w", "head_b")}
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1, momentum=0.9),
                   lambda c: 0.1)
    specs = {"w": (("pipeline", 0),), "b": (("pipeline", 0),)}
    state = create_train_state(params, tx)
    step = make_train_step(loss_fn, tx, param_specs=specs)
    metrics = []
    for xb, yb in pipe_batches():
        state, m = step(state, {"x": torch.from_numpy(xb), "label": torch.from_numpy(yb)},
                        torch.Generator().manual_seed(0))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out["train"] = {"metrics": metrics, "params": _gathered(state.params, specs, mesh)}
    build_mesh({"pipeline": 2, "seq": 2})
    w, xr = pipe_ring_inputs()
    coords = {"pipeline": rank // 2, "seq": rank % 2}
    w_local = torch.from_numpy(w).chunk(2, 0)[coords["pipeline"]].contiguous()
    x_local = torch.from_numpy(xr).chunk(2, 1)[coords["seq"]].contiguous()
    out["ring"] = {str(m): pipeline_apply(pipe_ring_layer, {"w": w_local}, x_local,
                                          n_microbatches=4, mask_bubble=m)
                   for m in ("auto", False)}
    shutdown_runtime()
    return out


# mp_moe_pp's runs: name -> (mesh, BertConfig fields (the JAX package's
# names too), batch layout: "plain", "expert_sharded", "seq" or "tiled").
MOE_PP_RUNS = {
    "ep": ({"data": 2, "expert": 2},
           dict(moe_experts=4, expert_axis="expert", expert_parallel=2), "plain"),
    "moe_dp": ({"data": 2, "model": 2}, dict(moe_experts=4), "plain"),
    "tp_moe": ({"data": 2, "model": 2},
               dict(moe_experts=4, model_axis="model", model_parallel=2), "plain"),
    "a2a": ({"data": 2, "expert": 2},
            dict(moe_experts=4, moe_capacity_factor=16.0, expert_axis="expert",
                 expert_parallel=2, moe_dispatch="alltoall"), "plain"),
    "sharded": ({"data": 2, "expert": 2},
                dict(moe_experts=4, expert_axis="expert", expert_parallel=2,
                     moe_dispatch="sharded"), "expert_sharded"),
    "dp4_moe": ({"data": 4}, dict(moe_experts=4), "plain"),
    "sharded_top2": ({"data": 2, "expert": 2},
                     dict(moe_experts=4, moe_topk=2, expert_axis="expert", expert_parallel=2,
                          moe_dispatch="sharded"), "expert_sharded"),
    "dp": ({"data": 2, "model": 2}, dict(), "plain"),
    "pp": ({"data": 2, "pipeline": 2},
           dict(pipeline_axis="pipeline", pipeline_parallel=2, pipeline_microbatches=4),
           "plain"),
    "pp_tp": ({"pipeline": 2, "model": 2},
              dict(pipeline_axis="pipeline", pipeline_parallel=2, pipeline_microbatches=4,
                   model_axis="model", model_parallel=2), "plain"),
    "moe_seq": ({"data": 2, "model": 2},
                dict(moe_experts=4, moe_capacity_factor=16.0, pipeline_parallel=2), "tiled"),
    "pp_moe": ({"data": 2, "pipeline": 2},
               dict(moe_experts=4, moe_capacity_factor=16.0, pipeline_axis="pipeline",
                    pipeline_parallel=2, pipeline_microbatches=4), "tiled"),
    "pp_ep": ({"data": 1, "pipeline": 2, "expert": 2},
              dict(moe_experts=4, moe_capacity_factor=16.0, pipeline_axis="pipeline",
                   pipeline_parallel=2, pipeline_microbatches=4, expert_axis="expert",
                   expert_parallel=2), "tiled"),
    "pp_ring": ({"pipeline": 2, "seq": 2},
                dict(pipeline_axis="pipeline", pipeline_parallel=2, pipeline_microbatches=4,
                     seq_axis="seq"), "seq"),
    "pp_ulysses": ({"pipeline": 2, "seq": 2},
                   dict(pipeline_axis="pipeline", pipeline_parallel=2,
                        pipeline_microbatches=4, seq_axis="seq", sp_impl="ulysses"), "seq"),
}
MOE_PP_CLI_ARGS = ["--config", "bert_base", "--bert-layers", "2", "--bert-hidden", "48",
                   "--bert-vocab", "64", "--global-batch", "8", "--steps", "2",
                   "--lr-schedule", "constant", "--lr", "1e-3", "--log-every", "1",
                   "--moe-experts", "4", "--expert-parallel", "2", "--pipeline-parallel", "2"]
# Requests the CLI refuses only on a multi-process mesh, with the reason.
MOE_PP_CLI_REFUSALS = (
    (["--expert-parallel", "2"], "shards no params over it"),
    (["--pipeline-parallel", "2", "--pipeline-microbatches", "3"],
     "not divisible by pipeline_microbatches 3"),
)


def tiled_batch(step: int, dp: int, base_rows: int = 2, tile: int = 4) -> dict:
    """The global batch of step ``step`` whose every data shard's rows are
    ``tile`` copies of a ``base_rows``-row base (the JAX tests'
    ``_tiled_batches``): every GPipe microbatch of a shard is then the same,
    so routing a microbatch at a time equals routing the shard."""
    from distributed_tensorflow_tpu_torch.data.text import SyntheticMLM, SyntheticMLMConfig

    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=MP_GEOM["vocab_size"], seq_len=32,
                                           seed=0))
    small = data.batch(base_rows * dp, seed=(3, step, 0))
    return {k: np.concatenate([np.tile(s, (tile,) + (1,) * (v.ndim - 1))
                               for s in np.split(v, dp)]) for k, v in small.items()}


def moe_pp_batches(name: str, runs: dict = MOE_PP_RUNS):
    """This rank's batches of a ``mp_moe_pp`` run (or of another job's
    ``runs``, laid out alike) on its active mesh."""
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.parallel.mesh import active_mesh, process_rows

    spec, _, kind = runs[name]
    if kind == "tiled":
        def tiled():
            step = 0
            while True:
                glob = tiled_batch(step, spec.get("data", 1))
                start, stop = process_rows(len(glob["nsp_label"]), active_mesh())
                yield {k: torch.from_numpy(v[start:stop]) for k, v in glob.items()}
                step += 1

        return tiled()
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=MP_GEOM["vocab_size"], seq_len=32,
                                           seed=0))
    return mlm_device_batches(data, MP_BATCH, device="cpu", seed=3,
                              seq_sharded=kind == "seq",
                              expert_sharded=kind == "expert_sharded")


def job_mp_moe_pp(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli import train as cli
    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.parallel import moe
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    tx = Transform(lambda p: torch.optim.Adam(list(p.values()), lr=MP_LR, betas=(0.9, 0.999),
                                              eps=1e-8), lambda c: MP_LR)
    out = {}
    route = moe._route
    for name, (spec, over, kind) in MOE_PP_RUNS.items():
        mesh = build_mesh(spec)
        model = bert.BertForPreTraining(bert.BertConfig(**MP_GEOM, **over), device="cpu",
                                        seed=0)
        params = dict(model.named_parameters())
        specs = bert.bert_param_specs(
            params, "model" if "model_axis" in over else None,
            "expert" if "expert_axis" in over else None,
            "pipeline" if "pipeline_axis" in over else None)
        state = create_train_state(params, tx)
        step = make_train_step(bert.make_bert_pretraining_loss(model), tx, param_specs=specs,
                               batch_axes=("expert",) if kind == "expert_sharded" else ())
        batches = moe_pp_batches(name)
        routing: list = []
        if name == "ep":
            def recording(*args, **kwargs):
                res = route(*args, **kwargs)
                routing.append({"assign": res[0].clone(), "kept": res[3].clone()})
                return res

            moe._route = recording
        metrics = []
        try:
            for _ in range(MP_STEPS):
                state, m = step(state, next(batches), torch.Generator().manual_seed(1))
                moe._route = route
                metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux")
                                if k in m})
        finally:
            moe._route = route
        out[name] = {"metrics": metrics, "params": _gathered(state.params, specs, mesh)}
        if name in ("sharded", "dp4_moe"):
            evaluate = make_eval_step(bert.make_bert_eval_metrics(model),
                                      batch_axes=("expert",) if kind == "expert_sharded" else ())
            out[name]["eval"] = {k: float(v) for k, v in evaluate(state, next(batches)).items()}
        if routing:
            out[name]["routing"] = routing
        if name == "pp_ep":
            with Checkpointer(out_dir / "ppep_ckpt", param_specs=specs) as ckpt:
                ckpt.save(state.step, state)
    shutdown_runtime()
    undo = no_dropout(bert)
    codes = []
    try:
        for port, args in zip(ports[1:], [
                MOE_PP_CLI_ARGS + ["--metrics-jsonl", str(out_dir / f"moe_pp_cli_{rank}.jsonl")],
                *(MOE_PP_CLI_ARGS[:14] + extra for extra, _ in MOE_PP_CLI_REFUSALS)]):
            try:
                codes.append(cli.main(args + [
                    "--device", "cpu", "--coordinator-address", f"127.0.0.1:{port}",
                    "--num-processes", str(world), "--process-id", str(rank),
                    "--init-timeout", "60"]))
            except SystemExit as e:
                codes.append(e.code)
    finally:
        undo()
    out["cli_codes"] = codes
    return out


CHAOS_STEPS, CHAOS_CKPT_EVERY, CHAOS_ROWS = 16, 4, 32


def lenet_run(global_batch: int = CHAOS_ROWS, grad_accum: int = 1):
    """``(state, step, make_batches)``: seeded LeNet on the CPU with SGD 0.05
    and momentum 0.9, over a seeded synthetic MNIST-shaped stream;
    ``make_batches(start_step, injector=None)`` is the prefetched stream at
    ``start_step`` (``run_resilient``'s contract)."""
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import LeNet5
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )
    from distributed_tensorflow_tpu_torch.train.state import Transform

    model = LeNet5(device="cpu")
    params, model_state = init_model(model)
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.05, momentum=0.9),
                   lambda count: 0.05)
    state = create_train_state(params, tx, model_state)
    step = make_train_step(make_classification_loss(model), tx, grad_accum=grad_accum)
    ds = synthetic_image_classification(256, (28, 28, 1), 10, seed=0)

    def make_batches(start_step: int, injector=None):
        return prefetch(device_batches(ds, global_batch, device="cpu", seed=1,
                                       start_step=start_step), 2, fault_injector=injector)

    return state, step, make_batches


def job_chaos(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    import time

    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.obs.fleet import HostBeacon, StepTimeline
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.train import (
        FaultEvent,
        FaultInjector,
        FaultPlan,
        fit,
    )

    state, step, make_batches = lenet_run()
    recorder = FlightRecorder(dump_dir=out_dir / f"dumps_{rank}")
    plan = FaultPlan((FaultEvent("slow_step", 5, duration_s=0.05),
                      FaultEvent("host_drop", 11)) if rank == 0 else ())
    injector = FaultInjector(plan, recorder=recorder)
    timeline = StepTimeline()
    beacon = HostBeacon(out_dir / "beacons", rank, timeline, extras=injector.summary)

    def padded_step(state_, batch_, rng_):
        # Real wall time a step, so the checkpoint writer runs between steps
        # and the beacons' wall times order cleanly.
        time.sleep(0.12)
        return step(state_, batch_, rng_)

    with Checkpointer(out_dir / f"ckpt_{rank}", fault_injector=injector) as ckpt:
        batches = make_batches(0)
        try:
            state, _ = fit(state, padded_step, batches, num_steps=CHAOS_STEPS,
                           rng=torch.Generator().manual_seed(0), log_every=1,
                           hooks=(lambda s, st, m: beacon.write(),), checkpointer=ckpt,
                           ckpt_every=CHAOS_CKPT_EVERY, timeline=timeline,
                           recorder=recorder, fault_injector=injector)
        finally:
            batches.close()
        latest = ckpt.latest_step()
    return {"step": state.step, "latest_ckpt": latest, "last_step": timeline.last_step}


def job_elastic(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.train import fit

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    state, step, make_batches = lenet_run()
    batches = make_batches(0)
    with Checkpointer(out_dir / "elastic_ckpt") as ckpt:
        state, _ = fit(state, step, batches, num_steps=2, rng=torch.Generator().manual_seed(0),
                       log_every=0, checkpointer=ckpt, ckpt_every=2)
    batches.close()
    out = {"step": state.step, "params": _cpu(state.params)}
    shutdown_runtime()
    return out



# ------------------------------------------------------------ serving groups


class Pacer:
    """Decode-pace hook for a continuous batcher: sleeps EVERY step (a
    seeded fault plan runs out), so streams are reliably mid-generation
    when a test exports them."""

    def __init__(self, slow_s: float):
        self.slow_s = slow_s

    def on_decode_step(self, step: int) -> None:
        time.sleep(self.slow_s)


def wait_active(batcher, n: int = 1, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and batcher.status()["slots_active"] < n:
        time.sleep(0.005)


def export_live(batcher, payload: dict, rid: str, *, want_pages: bool = True,
                slow_s: float = 0.05, settle_s: float = 0.12):
    """Submit ``payload`` to ``batcher`` (the JAX package's or the port's)
    and lift it back out mid-generation. Retries with a fresh request id
    when the race loses (stream finished or still prefilling); anything
    unsuitable re-adopts locally so no future dangles. Returns the
    ExportedStream."""
    from distributed_tensorflow_tpu_torch.serve.disagg import _chain_future

    for attempt in range(4):
        r = rid if attempt == 0 else f"{rid}-retry{attempt}"
        batcher.fault_injector = Pacer(slow_s)
        try:
            fut = batcher.submit(dict(payload), request_id=r)
            wait_active(batcher)
            time.sleep(settle_s)
            exported = batcher.export_streams(10.0)
        finally:
            batcher.fault_injector = None
        mine = [e for e in exported if e.state.request_id == r]
        if not mine:
            fut.result(timeout=10)  # finished before the export: go again
            continue
        exp = mine[0]
        ok_pages = exp.pages_k is not None or not want_pages
        if ok_pages and 0 < len(exp.state.tokens) < payload["max_new_tokens"]:
            return exp
        # Wrong phase (still prefilling / already done): resume locally.
        _chain_future(batcher.adopt_stream(exp.state, exp.pages_k, exp.pages_v), exp.future)
        fut.result(timeout=10)
    raise AssertionError(f"never caught {rid} mid-generation with pages")


def seeded_state(template: dict, seed: int, scale: float) -> dict:
    """A state dict of ``template``'s names and shapes drawn with numpy from
    ``seed``: LayerNorm scales ``1 + 0.1 N``, every other leaf ``scale *
    N``, in f32 (wide enough that greedy choices have clear margins)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in template.items():
        a = (1.0 + 0.1 * rng.standard_normal(tuple(v.shape)) if k.endswith("ln.weight")
             else scale * rng.standard_normal(tuple(v.shape)))
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


# The JAX tests/test_serve_mesh.py geometry: heads 4 and FFN 64 split 2 ways.
SERVE_BERT_GEOM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                       intermediate_size=64, max_position=32, dropout_rate=0.0)
# serve_mesh's layouts: (mesh, BertConfig fields of the checkpoint, weight dtype).
SERVE_LAYOUTS = {
    "tp": ({"data": 2, "model": 2}, {}, None),
    "ep": ({"data": 2, "expert": 2}, dict(moe_experts=4, moe_topk=1, moe_capacity_factor=4.0),
           None),
    "pp": ({"data": 2, "pipeline": 2}, dict(num_layers=2, pipeline_parallel=2), None),
    "tp_int8": ({"data": 2, "model": 2}, {}, "int8"),
    "ep_int8": ({"data": 2, "expert": 2}, dict(moe_experts=4, moe_topk=1, moe_capacity_factor=4.0),
                "int8"),
}
# The MoE layouts run at a capacity factor of the expert count: no token is
# dropped, so routing the rows of one data rank (tier 4) and routing them
# all (the one-process engine) give the same answer.
# Tier 1 replicates its row over the data ranks, tier 4 splits them.
SERVE_ENGINE_KW = dict(buckets=(32,), max_batch=4, batch_tiers=(1, 4))


def serve_bert(over: dict):
    """``(template model, seeded global state dict)`` of a serve_mesh
    checkpoint (a pipeline config's encoder stacked)."""
    from distributed_tensorflow_tpu_torch.models import bert

    model = bert.BertForPreTraining(bert.BertConfig(**{**SERVE_BERT_GEOM, **over}),
                                    device="cpu")
    return model, seeded_state(model.state_dict(), 5, 0.2)


def serve_payloads(n: int = 4, vocab: int = 64) -> list:
    """The JAX test's ``_payloads``: ``n`` requests of 6..30 tokens."""
    rng = np.random.default_rng(0)
    return [{"input_ids": ids, "mlm_targets": ids}
            for ids in (rng.integers(5, vocab, size=int(n_))
                        for n_ in rng.integers(6, 31, size=n))]


def _client_statusz(engine, payloads: list) -> dict:
    """The engine behind a ``Client`` and the HTTP front end: every payload
    served, then ``/statusz``; closing the client stops the followers."""
    import threading
    import urllib.request

    from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, Client, build_http_server

    m = ServeMetrics()
    with Client(engine, BatcherConfig(max_batch=4, max_delay_ms=2.0), metrics=m) as client:
        server = build_http_server(client, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            for f in [client.submit(p) for p in payloads]:
                f.result(timeout=60)
            base = "http://{}:{}".format(*server.server_address)
            with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
                status = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    return {"snapshot": m.snapshot(), "statusz": status, "group": engine.group.status()}


def job_serve_mesh(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.cli import serve as serve_cli
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    out = {}
    for name, (spec, over, wd) in SERVE_LAYOUTS.items():
        mesh = build_mesh(spec)
        model, params = serve_bert(over)
        engine = BertInferenceEngine(model, params, "cpu", mesh=mesh, weight_dtype=wd,
                                     **SERVE_ENGINE_KW)
        if rank:
            assert engine.follow() == 0
            continue
        payloads = serve_payloads()
        out[name] = {"layout": engine.layout, "mesh_info": engine.mesh_info(),
                     "moe_dispatch": engine.model.cfg.moe_dispatch,
                     "weight_dtype": engine.weight_dtype,
                     "results": {n: engine.run_batch(payloads[:n]) for n in (1, 4)}}
        if name == "tp":
            out[name].update(_client_statusz(engine, serve_payloads(6)))
        engine.close()
    shutdown_runtime()
    out["cli_rc"] = serve_cli.main(argv + [
        "--coordinator-address", f"127.0.0.1:{ports[1]}", "--num-processes", str(world),
        "--process-id", str(rank)])
    return out


CAUSAL_TP_GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                      intermediate_size=64, max_position=48)
CAUSAL_TP_KW = dict(buckets=(8, 16), slots=3, max_batch=2, max_new_tokens=8)
CAUSAL_PREFIX_KW = dict(prefix_cache_mb=0.05, block_tokens=4, prefill_chunk=8)
CAUSAL_TP_LR, CAUSAL_TP_STEPS = 0.1, 2
LM_TP_CLI_ARGS = ["--config", "lm_base", "--bert-layers", "1", "--bert-hidden", "48",
                  "--bert-vocab", "64", "--global-batch", "8", "--steps", "2",
                  "--log-every", "1", "--tensor-parallel", "2", "--device", "cpu"]
LM_SERVE_CLI_ARGS = ["--config=lm_base", "--device=cpu", "--bert-layers=1",
                     "--bert-hidden=48", "--bert-vocab=64", "--slots=3", "--max-batch=2",
                     "--buckets", "16", "32", "--max-new-tokens=8", "--selftest=4"]


def causal_tp_params() -> dict:
    """The seeded global state dict of the :data:`CAUSAL_TP_GEOM` LM."""
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig

    model = CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu")
    return seeded_state(model.state_dict(), 7, 0.15)


def lm_batch(step: int) -> dict:
    """A fixed next-token batch of 4 rows of 16 tokens, pads at the ends."""
    rng = np.random.default_rng(40 + step)
    ids = rng.integers(5, 64, size=(4, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < rng.integers(10, 17, size=(4, 1))
    return {"input_ids": ids * mask, "attention_mask": mask}


def mixed_requests() -> list:
    """The JAX ``_run_mixed_batch`` requests: 7 of 3..13 tokens, 2..8 new."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(7):
        plen = int(rng.integers(3, 14))
        reqs.append({"input_ids": rng.integers(5, 64, size=plen),
                     "max_new_tokens": int(rng.integers(2, 9))})
    return reqs


def shared_prefix_requests(seed: int, head_len: int = 12, n_tails: int = 3) -> list:
    """The JAX ``_shared_prefix_reqs``: one 12-token head, short tails."""
    rng = np.random.default_rng(seed)
    head = rng.integers(5, 64, size=head_len)
    return [{"input_ids": np.concatenate([head, rng.integers(5, 64, size=int(rng.integers(1, 4)))]),
             "max_new_tokens": int(rng.integers(2, 7))} for _ in range(n_tails)]


def greedy_reference(model, prompt, n: int) -> list:
    """n greedy tokens by re-running the FULL causal forward of ``model``
    after each appended token."""
    toks = [int(t) for t in prompt]
    out = []
    with torch.inference_mode():
        for _ in range(n):
            ids = torch.tensor([toks])
            nxt = int(model(ids, torch.ones_like(ids, dtype=torch.bool))[0, -1].argmax())
            out.append(nxt)
            toks.append(nxt)
    return out


def teacher_forced_agreement(engine, model, n_prompts: int = 3, n_steps: int = 6):
    """The JAX ``_teacher_forced_agreement``: top-1 agreement of ``engine``
    against ``model``'s full forward, each probe re-submitting the
    reference prefix for 2 tokens (a prefill token and a decode token)."""
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher

    rng = np.random.default_rng(23)
    agree = total = 0
    with ContinuousBatcher(engine, BatcherConfig(max_batch=2)) as b:
        for _ in range(n_prompts):
            p = rng.integers(5, 64, size=int(rng.integers(5, 10)))
            ref = greedy_reference(model, p, n_steps)
            for t in range(len(ref) - 1):
                forced = np.concatenate([p, np.asarray(ref[:t], np.int64)])
                got = b.submit({"input_ids": forced, "max_new_tokens": 2}).result(
                    timeout=120)["tokens"]
                agree += (got[0] == ref[t]) + (got[1] == ref[t + 1])
                total += 2
    return agree / total, total


def _lm_streams(engine, requests: list, warm_first: bool = False) -> dict:
    from distributed_tensorflow_tpu_torch.obs.metrics import ServeMetrics
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher

    m = ServeMetrics()
    with ContinuousBatcher(engine, BatcherConfig(max_batch=2, max_queue=32), metrics=m) as b:
        first = (b.submit(dict(requests[0])).result(timeout=120)["tokens"]
                 if warm_first else None)
        results = [f.result(timeout=120) for f in [b.submit(dict(r)) for r in requests]]
    return {"streams": [r["tokens"] for r in results], "first": first,
            "prefix_hits": m.prefix_hits.value, "layout": engine.layout,
            "mesh_info": engine.mesh_info()}


def _page_round_trips(engine) -> dict:
    """The page cells over the group: two pool blocks exported (every head,
    gathered onto the leader), imported into the last two blocks and
    exported again; slot 0's lane exported, imported into slot 1 and
    exported again. Each second export must equal the first."""
    n = engine._pool_blocks
    k, v = engine.export_prefix_pages([0, 1])
    engine.import_prefix_pages([(n - 2, 0), (n - 1, 1)], k, v)
    k2, v2 = engine.export_prefix_pages([n - 2, n - 1])
    sk, sv = engine.export_slot_pages(0)
    engine.import_slot_pages(1, sk, sv, last_token=5)
    sk2, sv2 = engine.export_slot_pages(1)
    return {"page_heads": engine.page_meta()["heads"],
            "stream_heads": engine.stream_page_meta()["heads"],
            "stage_shape": tuple(k.shape), "slot_shape": tuple(sk.shape),
            "pool_round_trip": bool(torch.equal(k[:, :2], k2[:, :2])
                                    and torch.equal(v[:, :2], v2[:, :2])),
            "slot_round_trip": bool(torch.equal(sk, sk2) and torch.equal(sv, sv2))}


def job_causal_tp(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    import os

    from distributed_tensorflow_tpu_torch.cli import serve as serve_cli
    from distributed_tensorflow_tpu_torch.cli import train as train_cli
    from distributed_tensorflow_tpu_torch.interop import shard_params
    from distributed_tensorflow_tpu_torch.models.causal_lm import (
        CausalLM,
        CausalLMConfig,
        causal_param_specs,
        make_causal_lm_loss,
    )
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.serve import CausalLMEngine
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    mesh = build_mesh({"data": 1, "model": 2})
    params = causal_tp_params()
    specs = causal_param_specs(params)
    # One TP train run from the seeded global parameters.
    model = CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM, model_axis="model", model_parallel=2),
                     device="cpu")
    model.load_state_dict(shard_params(params, specs, mesh))
    # SGD: the key bias's gradient is zero up to rounding (softmax ignores a
    # shift of every key), which Adam's normalisation would blow up to
    # full-size steps of noise.
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=CAUSAL_TP_LR),
                   lambda c: CAUSAL_TP_LR)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(make_causal_lm_loss(model), tx, param_specs=specs)
    metrics = []
    for i in range(CAUSAL_TP_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(i).items()}
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    out = {"train": {"metrics": metrics, "params": _gathered(state.params, specs, mesh)}}
    # Serving over the group.
    plain = CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu")
    plain.load_state_dict(params)
    for name, kw in (("decode", {}),
                     ("prefix", dict(CAUSAL_PREFIX_KW, kv_transfer=True, stream_migrate=True)),
                     ("int8", dict(weight_dtype="int8", kv_dtype="int8"))):
        engine = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu"),
                                params, "cpu", mesh=mesh, **CAUSAL_TP_KW, **kw)
        if rank:
            assert engine.follow() == 0
            continue
        if name == "decode":
            out[name] = _lm_streams(engine, mixed_requests())
        elif name == "prefix":
            out[name] = _lm_streams(engine, shared_prefix_requests(13), warm_first=True)
            out[name].update(_page_round_trips(engine))
        else:
            ratio, total = teacher_forced_agreement(engine, plain)
            out[name] = {"ratio": ratio, "total": total, "weight_dtype": engine.weight_dtype,
                         "kv_dtype": engine.kv_dtype}
        engine.close()
    shutdown_runtime()
    # The CLIs: train the causal LM at TP 2, then serve its checkpoint at TP 2.
    ckpt = out_dir / "lm_tp_ckpt"
    group = ["--num-processes", str(world), "--process-id", str(rank)]
    out["train_rc"] = train_cli.main(LM_TP_CLI_ARGS + [
        "--ckpt-dir", str(ckpt), "--coordinator-address", f"127.0.0.1:{ports[1]}", *group])
    out["serve_rc"] = serve_cli.main(LM_SERVE_CLI_ARGS + [
        f"--ckpt-dir={ckpt}", "--tp=2", "--coordinator-address", f"127.0.0.1:{ports[2]}",
        *group])
    # A follower that dies: the leader's next cell raises, and so does
    # every later one; the leader never serves alone.
    initialize_runtime(f"127.0.0.1:{ports[3]}", world, rank, device="cpu", timeout_s=20)
    engine = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu"), params,
                            "cpu", mesh=build_mesh({"model": 2}), **CAUSAL_TP_KW)
    if rank:
        os._exit(3)
    errors = []
    for _ in range(2):
        try:
            engine.fetch_step(engine.decode(np.zeros(3, np.int32), np.zeros(3, bool),
                                            np.zeros(3, np.float32), np.zeros(3, np.int32)))
            errors.append(None)
        except Exception as e:  # the group's failure, recorded for the test
            errors.append(f"{type(e).__name__}: {e}")
    out["dead_follower"] = errors
    torch.save(out, out_dir / f"causal_tp_rank{rank}.pt")
    os._exit(0)

def job_migrate_tp(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        CausalLMEngine,
        ContinuousBatcher,
    )
    from distributed_tensorflow_tpu_torch.serve.disagg import (
        make_stream_receiver,
        serialize_stream,
    )

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    mesh = build_mesh({"model": 2})
    params = causal_tp_params()
    kw = dict(CAUSAL_TP_KW, stream_migrate=True)
    group_engine = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu"),
                                  params, "cpu", mesh=mesh, **kw)
    if rank:
        assert group_engine.follow() == 0
        shutdown_runtime()
        return {}
    single = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu"),
                            params, "cpu", **kw)
    rng = np.random.default_rng(47)
    max_new = kw["max_new_tokens"]
    requests = {"into_group": {"input_ids": rng.integers(5, 64, size=9).tolist(),
                               "max_new_tokens": max_new},
                "out_of_group": {"input_ids": rng.integers(5, 64, size=7).tolist(),
                                 "max_new_tokens": max_new, "temperature": 0.8, "seed": 3}}
    cfg = BatcherConfig(max_batch=2, max_queue=8)
    out = {"stream_heads": group_engine.stream_page_meta()["heads"]}
    with ContinuousBatcher(single, cfg) as one, ContinuousBatcher(group_engine, cfg) as grp:
        for name, payload in requests.items():
            reference = one.submit(dict(payload)).result(timeout=60)["tokens"]
            src, src_engine, dst, dst_engine = (
                (one, single, grp, group_engine) if name == "into_group"
                else (grp, group_engine, one, single))
            exp = export_live(src, payload, name, slow_s=0.1, settle_s=0.3)
            recv = make_stream_receiver(dst, dst_engine)
            got = recv(serialize_stream(exp.state, exp.pages_k, exp.pages_v,
                                        src_engine.stream_page_meta()))
            out[name] = {"reference": reference, "pages": got["pages"],
                         "resume_at": got["resume_at"], "max_new": max_new,
                         "tokens": recv.wait(exp.state.request_id, timeout_s=60)["tokens"]}
    group_engine.close()
    shutdown_runtime()
    return out


# axis4_train's runs: one axis of 4 spanning the job (its group is the world
# group), the MP_GEOM BERT (4 layers under the pipeline: one a stage) with
# its fields beside it, and the batch layout of MOE_PP_RUNS. 4 heads and an
# FFN of 128 split 1 and 32 a rank under TP; 8 experts 2 a rank under EP.
_EP4 = dict(moe_experts=8, expert_axis="expert", expert_parallel=4)
AXIS4_RUNS = {
    "tp": ({"model": 4}, dict(model_axis="model", model_parallel=4), "plain"),
    "ulysses": ({"seq": 4}, dict(seq_axis="seq", sp_impl="ulysses"), "seq"),
    "ring": ({"seq": 4}, dict(seq_axis="seq"), "seq"),
    "ring_flash": ({"seq": 4}, dict(seq_axis="seq", attn_impl="flash"), "seq"),
    "ep_replicated": ({"expert": 4}, dict(_EP4), "plain"),
    "ep_alltoall": ({"expert": 4}, dict(_EP4, moe_capacity_factor=16.0,
                                        moe_dispatch="alltoall"), "plain"),
    "ep_sharded": ({"expert": 4}, dict(_EP4, moe_dispatch="sharded"), "expert_sharded"),
    "ep_sharded_top2": ({"expert": 4}, dict(_EP4, moe_dispatch="sharded", moe_topk=2),
                        "expert_sharded"),
    "pp": ({"pipeline": 4}, dict(num_layers=4, pipeline_axis="pipeline", pipeline_parallel=4,
                                 pipeline_microbatches=4), "plain"),
}
AXIS4_STEPS = 1
# axis4_serve's layouts (SERVE_BERT_GEOM; MoE at a capacity factor of the
# expert count, as serve_mesh's), and the causal LM's TP 4 geometry.
AXIS4_SERVE = {
    "tp": ({"model": 4}, {}, None),
    "ep": ({"expert": 4}, dict(moe_experts=8, moe_topk=1, moe_capacity_factor=8.0), None),
    "pp": ({"pipeline": 4}, dict(num_layers=4, pipeline_parallel=4), None),
}
CAUSAL4_GEOM = dict(CAUSAL_TP_GEOM, num_heads=4)


def causal4_params() -> dict:
    """The seeded global state dict of the :data:`CAUSAL4_GEOM` LM."""
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig

    model = CausalLM(CausalLMConfig(**CAUSAL4_GEOM), device="cpu")
    return seeded_state(model.state_dict(), 7, 0.15)


def job_stuck_follower(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    """A serving group whose follower stays alive but never takes a cell:
    the leader's broadcast of a 64 MB operand (more than the sockets
    buffer) must raise within the job's collective timeout (2 s here), and
    the next cell at once."""
    import os

    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.serve.group import ServingGroup

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=2)
    group = ServingGroup(build_mesh({"model": 2}))
    if rank:
        time.sleep(8)
        os._exit(3)  # no results: it took no cell
    group.start()
    big = torch.zeros(64 << 20, dtype=torch.uint8)
    out = {"errors": [], "seconds": []}
    for _ in range(2):
        t0 = time.monotonic()
        try:
            group.issue("cell", (big,), lambda x: None)
            out["errors"].append(None)
        except Exception as e:  # the group's failure, recorded for the test
            out["errors"].append(f"{type(e).__name__}: {e}")
        out["seconds"].append(time.monotonic() - t0)
    torch.save(out, out_dir / f"stuck_follower_rank{rank}.pt")
    os._exit(0)


def job_axis4_train(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.models import bert
    from distributed_tensorflow_tpu_torch.parallel.mesh import axis_group, build_mesh
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    tx = Transform(lambda p: torch.optim.Adam(list(p.values()), lr=MP_LR, betas=(0.9, 0.999),
                                              eps=1e-8), lambda c: MP_LR)
    out = {}
    for name, (spec, over, kind) in AXIS4_RUNS.items():
        mesh = build_mesh(spec)
        model = bert.BertForPreTraining(bert.BertConfig(**{**MP_GEOM, **over}), device="cpu",
                                        seed=0)
        params = dict(model.named_parameters())
        specs = bert.bert_param_specs(
            params, "model" if "model_axis" in over else None,
            "expert" if "expert_axis" in over else None,
            "pipeline" if "pipeline_axis" in over else None)
        state = create_train_state(params, tx)
        step = make_train_step(bert.make_bert_pretraining_loss(model), tx, param_specs=specs,
                               batch_axes=("expert",) if kind == "expert_sharded" else ())
        batches = moe_pp_batches(name, AXIS4_RUNS)
        metrics = []
        for _ in range(AXIS4_STEPS):
            state, m = step(state, next(batches), torch.Generator().manual_seed(1))
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux") if k in m})
        out[name] = {"metrics": metrics, "params": _gathered(state.params, specs, mesh),
                     "world_group": axis_group(mesh, tuple(spec)) is dist.group.WORLD}
    shutdown_runtime()
    return out


def job_axis4_serve(rank: int, world: int, ports: list[int], argv, out_dir: Path) -> dict:
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine, CausalLMEngine

    initialize_runtime(f"127.0.0.1:{ports[0]}", world, rank, device="cpu", timeout_s=60)
    out = {}
    for name, (spec, over, wd) in AXIS4_SERVE.items():
        mesh = build_mesh(spec)
        model, params = serve_bert(over)
        engine = BertInferenceEngine(model, params, "cpu", mesh=mesh, weight_dtype=wd,
                                     **SERVE_ENGINE_KW)
        if rank:
            assert engine.follow() == 0
            continue
        payloads = serve_payloads()
        out[name] = {"layout": engine.layout, "mesh_info": engine.mesh_info(),
                     "moe_dispatch": engine.model.cfg.moe_dispatch,
                     "results": {n: engine.run_batch(payloads[:n]) for n in (1, 4)}}
        engine.close()
    engine = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL4_GEOM), device="cpu"),
                            causal4_params(), "cpu", mesh=build_mesh({"model": 4}),
                            **CAUSAL_TP_KW)
    if rank:
        assert engine.follow() == 0
    else:
        out["causal"] = _lm_streams(engine, mixed_requests())
        engine.close()
    shutdown_runtime()
    return out


def main() -> int:
    job, rank, world, out_dir, ports = sys.argv[1:6]
    argv = json.loads(sys.argv[6]) if len(sys.argv) > 6 else None
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    ports = [int(p) for p in ports.split(",")]
    torch.set_num_threads(1)
    if job in ("dropout", "chaos", "elastic", "mp_attn", "mp_bert", "mp_moe", "mp_pipe",
               "mp_moe_pp", "serve_mesh", "causal_tp", "migrate_tp", "axis4_train",
               "axis4_serve", "stuck_follower"):
        job_fn = {"dropout": job_dropout, "chaos": job_chaos, "elastic": job_elastic,
                  "mp_attn": job_mp_attn, "mp_bert": job_mp_bert, "mp_moe": job_mp_moe,
                  "mp_pipe": job_mp_pipe, "mp_moe_pp": job_mp_moe_pp,
                  "serve_mesh": job_serve_mesh, "causal_tp": job_causal_tp,
                  "migrate_tp": job_migrate_tp, "axis4_train": job_axis4_train,
                  "axis4_serve": job_axis4_serve, "stuck_follower": job_stuck_follower}[job]
        out = job_fn(rank, world, ports, argv, out_dir)
    else:
        out = {"collectives": job_collectives, "cli": job_cli}[job](rank, world, ports, argv)
    torch.save(out, out_dir / f"{job}_rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
