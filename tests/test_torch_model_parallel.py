"""Port parity: tensor and sequence parallelism (Megatron TP, ring and
Ulysses attention) on the CPU.

The torch side runs as gloo processes of ``tests/_torch_mp_worker.py``, two
jobs each launched once for the module: ``mp_attn`` (2 ranks, a ``{"seq":
2}`` mesh, then the CLI) and ``mp_bert`` (4 ranks). The JAX side runs
under ``shard_map`` on conftest's CPU devices, on the same meshes, from
the same numpy-seeded inputs and (for BERT) the same global parameters
through ``interop``, dropout off, with the Pallas flash kernel in interpret
mode for the flash inners. The cases mirror the JAX package's
``tests/test_ring_attention.py`` (equal to dense, with a mask, fully
masked rows zero, bf16 inputs, the flash inner; values and the gradients
of q, k and v), ``tests/test_ulysses.py`` (dense and flash inners,
gradients, indivisible heads), ``tests/test_bert_tp.py`` (TP training,
with clipping, ``bert_param_specs`` covering attention and FFN, TP x SP)
and ``tests/test_bert.py``'s seq-parallel cases (ring and Ulysses
training); ``shard_params`` of the global tree equals the JAX TP
placement, device by device. Tolerances: f32 1e-5 (values and gradients of the attention,
loss and grad_norm relative), parameters after two Adam steps within 2e-5
(the JAX recipe test's bound); bf16 attention within 1e-2 (one bf16
rounding of the output). Also: the dropout generator's fold (the ranks of
a ``"model"`` group draw the same masks, ``"seq"`` ranks different ones),
a TP-2 checkpoint holding the gathered tree and restoring at TP 1 and TP 2,
and the CLI under ``--tensor-parallel 2`` against the JAX recipe's step,
with its refusals (exit 2).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax, bert_params_to_flax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    ATTN_CASES,
    MP_BATCH,
    MP_GEOM,
    MP_LR,
    MP_RUNS,
    MP_STEPS,
    TP_CLI_ARGS,
    attn_inputs,
)
from test_torch_multiprocess import _launch  # noqa: E402

F32_TOL = 1e-5
PARAM_TOL = 2e-5
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def attn_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp_attn")
    return d, _launch(d, "mp_attn", n_groups=3)


@pytest.fixture(scope="module")
def bert_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp_bert")
    return d, _launch(d, "mp_bert", world=4)


def _seq_mesh():
    return jax_build_mesh({"seq": 2}, devices=jax.devices()[:2])


def _global(ranks, key, case=None):
    """The ranks' sequence shards of one output, concatenated along L."""
    parts = [r["attn"][case][key] if case else r[key] for r in ranks]
    return torch.cat(parts, dim=1).numpy()


def _jax_attention(case: str):
    from distributed_tensorflow_tpu.parallel.ring_attention import ring_attention
    from distributed_tensorflow_tpu.parallel.ulysses import ulysses_attention

    inputs, impl, inner, dtype = ATTN_CASES[case]
    q, k, v, mask = attn_inputs(inputs)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(x, dt) for x in (q, k, v))
    fn = ring_attention if impl == "ring" else ulysses_attention
    spec = P(None, "seq")
    if mask is None:
        sm = jax.shard_map(lambda q, k, v: fn(q, k, v, "seq", inner=inner), mesh=_seq_mesh(),
                           in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
        run = sm
    else:
        sm = jax.shard_map(lambda q, k, v, m: fn(q, k, v, "seq", mask=m, inner=inner),
                           mesh=_seq_mesh(), in_specs=(spec,) * 4, out_specs=spec,
                           check_vma=False)
        m = jnp.asarray(mask)

        def run(q, k, v):
            return sm(q, k, v, m)

    def loss(q, k, v):
        out = run(q, k, v)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out

    # One compiled program (eager shard_map dispatch takes seconds a case).
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_sequence_parallel_attention_matches_jax(attn_ranks, case):
    """Ring (einsum and flash inners) and Ulysses (dense and flash) on a
    {"seq": 2} mesh: values and the gradients of q, k and v equal the JAX
    package's under shard_map."""
    _, ranks = attn_ranks
    out, grads = _jax_attention(case)
    tol = BF16_TOL if ATTN_CASES[case][3] == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_global(ranks, "out", case), out, atol=tol)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_global(ranks, name, case), g, atol=4 * tol, err_msg=name)
    if case == "ring_masked_rows":
        assert not _global(ranks, "out", case)[1].any()
        assert not _global(ranks, "dq", case)[1].any()


def test_ulysses_refuses_indivisible_heads(attn_ranks):
    _, ranks = attn_ranks
    for r in ranks:
        assert "num_heads 3 not divisible by axis size 2" in r["ulysses_refusal"]


def test_collectives_and_their_gradients_match_jax(attn_ranks):
    """psum, ppermute, all_to_all and all_gather on a {"seq": 2} mesh, and
    the gradients of sum(y * w): JAX's transposes under shard_map
    (check_vma=False), psum's being a psum."""
    _, ranks = attn_ranks
    from jax import lax

    fns = {"psum": lambda x: lax.psum(x, "seq"),
           "ppermute": lambda x: lax.ppermute(x, "seq", [(0, 1), (1, 0)]),
           "all_to_all": lambda x: lax.all_to_all(x, "seq", 0, 1, tiled=True),
           "all_gather": lambda x: lax.all_gather(x, "seq", axis=1, tiled=True)}
    for name, fn in fns.items():
        xs = np.stack([r["collectives"][name]["x"].numpy() for r in ranks])

        def per_device(x, fn=fn):
            x = x[0]
            y = fn(x)
            w = jnp.arange(y.size, dtype=jnp.float32).reshape(y.shape) + lax.axis_index("seq")
            g = jax.grad(lambda x: jnp.sum(fn(x) * w))(x)
            return y[None], g[None]

        y, g = jax.jit(jax.shard_map(per_device, mesh=_seq_mesh(), in_specs=P("seq"),
                                     out_specs=(P("seq"), P("seq")), check_vma=False))(xs)
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out["collectives"][name]["y"].numpy(), y[r],
                                       atol=F32_TOL, err_msg=name)
            np.testing.assert_allclose(out["collectives"][name]["grad"].numpy(), g[r],
                                       atol=F32_TOL, err_msg=name)


def test_dropout_masks_are_shared_along_model_and_differ_along_seq(attn_ranks):
    """The step folds the data and seq coordinates into its generator, not
    the rank: the two ranks of a {"model": 2} group draw the same masks (on
    activations they both hold), the two ranks of a {"seq": 2} line
    different ones."""
    _, ranks = attn_ranks
    a, b = ranks[0]["masks_model"], ranks[1]["masks_model"]
    assert len(a) == len(b) == 5  # embeddings + 2 a layer
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a, b = ranks[0]["masks_seq"], ranks[1]["masks_seq"]
    assert len(a) == len(b) == 5
    assert all(not torch.equal(x, y) for x, y in zip(a, b))


def _init_params():
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining

    model = BertForPreTraining(BertConfig(**MP_GEOM), device="cpu", seed=0)
    return {k: v.detach() for k, v in model.state_dict().items()}


def _jax_bert_run(name: str):
    from distributed_tensorflow_tpu.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        bert_batch_specs,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu.models.bert import (
        BertConfig,
        BertForPreTraining,
        bert_param_specs,
        make_bert_pretraining_loss,
    )
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state

    spec, over, clip = MP_RUNS[name]
    mesh = jax_build_mesh(spec, devices=jax.devices()[:4])
    params = jax.tree.map(jnp.asarray, bert_params_to_flax(_init_params(),
                                                            MP_GEOM["num_heads"]))
    tx = optax.adam(MP_LR)
    specs = None
    if "model_axis" in over:
        specs = make_state_specs(create_train_state(params, tx), tx, bert_param_specs(params))
    seq = "seq_axis" in over
    state = place_state(create_train_state(params, tx), mesh, specs)
    step = make_train_step(
        make_bert_pretraining_loss(BertForPreTraining(BertConfig(**MP_GEOM, **over))), tx,
        mesh, batch_spec=bert_batch_specs(mesh, seq_sharded=seq), state_specs=specs,
        clip_norm=clip)
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=128, seq_len=32, seed=0))
    batches = mlm_device_batches(data, mesh, MP_BATCH, seq_sharded=seq, seed=3)
    metrics = []
    for _ in range(MP_STEPS):
        state, m = step(state, next(batches), jax.random.key(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, bert_params_from_flax(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("name", list(MP_RUNS))
def test_bert_model_parallel_training_matches_jax(bert_ranks, name):
    """Two Adam steps of a 2-layer BERT under TP ({"data": 2, "model": 2}),
    TP with global-norm clipping at 0.05 (engaged every step), the ring and
    Ulysses ({"data": 2, "seq": 2}) and TP x ring ({"seq": 2, "model": 2}),
    on four gloo ranks: every rank's loss and grad_norm (the global norm:
    sharded leaves' squares summed over the model axis) and its gathered
    parameters equal the JAX package's run on the same mesh."""
    _, ranks = bert_ranks
    ref_metrics, ref_params = _jax_bert_run(name)
    if name == "tp_clip":
        assert all(m["grad_norm"] > MP_RUNS[name][2] for m in ref_metrics)
    for r in ranks:
        got = r[name]
        for g, w in zip(got["metrics"], ref_metrics):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=F32_TOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=F32_TOL)
        assert got["params"].keys() == ref_params.keys()
        for k, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), ref_params[k].numpy(), atol=PARAM_TOL,
                                       err_msg=k)


def test_bert_param_specs_cover_attention_and_ffn():
    from distributed_tensorflow_tpu.models.bert import bert_param_specs as jax_specs
    from distributed_tensorflow_tpu_torch.models.bert import bert_param_specs

    params = _init_params()
    specs = bert_param_specs(params)
    sharded = sorted(k for k, s in specs.items() if s is not None)
    # 2 layers x (3 qkv kernels + 3 qkv biases + out kernel + up kernel +
    # up bias + down kernel), as in the JAX package.
    assert len(sharded) == 20
    assert all(("attention" in k or "intermediate" in k or "output" in k) for k in sharded)
    assert all(specs[k] is None for k in specs if "embeddings" in k or ".ln." in k
               or k.endswith("_bias") or "pooler" in k)
    # The JAX tree's spec of each leaf names the model axis exactly where
    # the port's does, on the flax dim that maps to the port's dim.
    flax = bert_params_to_flax(params, MP_GEOM["num_heads"])
    jspecs = jax_specs(flax)
    marked = {k: torch.full_like(v, float(specs[k] is not None)) for k, v in params.items()}
    jax.tree.map(lambda s, m: np.testing.assert_array_equal(
        float("model" in tuple(s)), np.unique(m)), jspecs,
        bert_params_to_flax(marked, MP_GEOM["num_heads"]),
        is_leaf=lambda x: isinstance(x, P))
    assert bert_param_specs(params, model_axis=None) == dict.fromkeys(params)


def test_shard_params_equals_the_jax_tp_placement():
    """``bert_params_from_flax`` of the global tree, then ``shard_params``
    for each rank of a ``{"model": 2}`` mesh, equals each JAX device's shard
    of the same tree placed under ``bert_param_specs``, leaf for leaf."""
    from jax.sharding import NamedSharding

    from distributed_tensorflow_tpu.models.bert import bert_param_specs as jax_specs
    from distributed_tensorflow_tpu_torch.interop import shard_params
    from distributed_tensorflow_tpu_torch.models.bert import bert_param_specs
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh

    flax = bert_params_to_flax(_init_params(), MP_GEOM["num_heads"])
    mesh = jax_build_mesh({"model": 2}, devices=jax.devices()[:2])
    placed = jax.tree.map(lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
                          flax, jax_specs(flax), is_leaf=lambda x: isinstance(x, P))
    full = bert_params_from_flax(flax)
    specs = bert_param_specs(full)
    for r, device in enumerate(mesh.devices.flat):
        local = jax.tree.map(lambda x, d=device: np.asarray(
            next(sh.data for sh in x.addressable_shards if sh.device == d)), placed)
        want = bert_params_from_flax(local)
        got = shard_params(full, specs, build_mesh({"model": 2}, world_size=2, rank=r))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), (r, k)


def test_tp2_checkpoint_holds_the_global_tree_and_restores_at_tp1(bert_ranks):
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer, restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.state import Transform

    d, ranks = bert_ranks
    for r in ranks:
        assert r["tp_restored"] == {"start": MP_STEPS, "params_equal": True,
                                    "slots_equal": True}
    params, _, step = restore_serving_state(d / "tp_ckpt")
    assert step == MP_STEPS
    for k, p in ranks[0]["tp"]["params"].items():
        assert torch.equal(params[k], p), k
    # The same file into an unsharded (TP 1) train state: params and Adam
    # moments of the global shapes.
    model = BertForPreTraining(BertConfig(**MP_GEOM), device="cpu", seed=5)
    tx = Transform(lambda p: torch.optim.Adam(list(p.values()), lr=MP_LR), lambda c: MP_LR)
    state, start = Checkpointer(d / "tp_ckpt").restore_latest(
        create_train_state(dict(model.named_parameters()), tx))
    assert start == MP_STEPS
    for k, p in state.params.items():
        assert torch.equal(p.detach(), params[k]), k
    moments = state.opt_state.optimizer.state_dict()["state"]
    assert all(v["exp_avg"].shape == p.shape
               for v, p in zip(moments.values(), state.params.values()))


def test_cli_tensor_parallel_matches_the_jax_recipe_and_refuses(attn_ranks):
    """``cli.train --config bert_base --tensor-parallel 2`` as two gloo
    processes (1 layer, hidden 48, the preset's 12 heads and 128 positions,
    bf16, dropout off, a constant 1e-3 with the preset's AdamW, decay mask
    and clipping): the logged losses equal the JAX step's on a {"data": 1,
    "model": 2} mesh from the CLI's seeded parameters within 2e-2 (bf16, the
    CLI recipe test's bound), the moves within 2e-3, and the log names the
    layout. ``--config mnist_lenet --tensor-parallel 2`` exits 2."""
    from distributed_tensorflow_tpu.cli.train import PRESETS as JAX_PRESETS
    from distributed_tensorflow_tpu.cli.train import _make_tx as jax_tx
    from distributed_tensorflow_tpu.data.text import SyntheticMLM, SyntheticMLMConfig
    from distributed_tensorflow_tpu.data.text import bert_batch_specs, mlm_device_batches
    from distributed_tensorflow_tpu.models import bert as jbert
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS

    d, ranks = attn_ranks
    assert [r["cli_codes"] for r in ranks] == [[2, 0], [2, 0]]
    records = [json.loads(line) for line in (d / "tp_cli_0.jsonl").read_text().splitlines()]
    assert not (d / "tp_cli_1.jsonl").exists()  # rank 0 writes the records
    assert "layout=tp2" in (d / "mp_attn_rank0.log").read_text()
    port_losses = [r["loss"] for r in records]

    width = dict(bert_layers=1, bert_hidden=48, bert_vocab=64, global_batch=8, num_steps=2,
                 lr_schedule="constant", learning_rate=1e-3)
    pcfg = dataclasses.replace(PRESETS["bert_base"], **width)
    init = pcfg.build(pcfg)("cpu")["params"]  # the CLI's seeded global init
    flax = jax.tree.map(jnp.asarray, bert_params_to_flax(
        {k: v.detach() for k, v in init.items()}, num_heads=12))
    jcfg = dataclasses.replace(JAX_PRESETS["bert_base"], **width)
    tx, _ = jax_tx(jcfg)
    mesh = jax_build_mesh({"data": 1, "model": 2}, devices=jax.devices()[:2])
    specs = make_state_specs(create_train_state(flax, tx), tx, jbert.bert_param_specs(flax))
    state = place_state(create_train_state(flax, tx), mesh, specs)
    cfg = jbert.BertConfig(vocab_size=64, hidden_size=48, num_layers=1,
                           intermediate_size=192, max_position=128, dropout_rate=0.0,
                           dtype=jnp.bfloat16, model_axis="model", model_parallel=2)
    step = make_train_step(jbert.make_bert_pretraining_loss(jbert.BertForPreTraining(cfg)),
                           tx, mesh, batch_spec=bert_batch_specs(mesh), state_specs=specs,
                           clip_norm=jcfg.clip_norm)
    batches = mlm_device_batches(SyntheticMLM(SyntheticMLMConfig(vocab_size=64, seq_len=128,
                                                                 seed=0)), mesh, 8, seed=1)
    jax_losses = []
    for _ in range(2):
        state, metrics = step(state, next(batches), jax.random.key(0))
        jax_losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(port_losses, jax_losses, atol=2e-2)
    np.testing.assert_allclose(np.diff(port_losses), np.diff(jax_losses), atol=2e-3)


@pytest.mark.parametrize(
    "argv,message",
    [(["--config", "bert_base", "--seq-parallel", "5", "--sp-impl", "ulysses"],
      "not divisible by --seq-parallel 5"),
     (["--config", "lm_base", "--tensor-parallel", "2"], "does not fit the job's processes"),
     (["--config", "bert_base", "--pipeline-parallel", "2"],
      "does not fit the job's processes")],
    ids=["ulysses-heads", "lm-tp", "pipeline"],
)
def test_cli_refuses_model_parallel_requests_with_exit_2(argv, message, capsys):
    from distributed_tensorflow_tpu_torch.cli.train import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
