"""Port parity: mixture-of-experts and GPipe pipeline BERT on the CPU,
mirroring the non-``slow`` cases of the JAX package's
``tests/test_bert_moe.py`` and ``tests/test_bert_pp.py``.

The torch side is one gloo job of ``tests/_torch_mp_worker.py``
(``mp_moe_pp``, four ranks): a 2-layer :data:`MP_GEOM` BERT trained 2 Adam
steps from the same seeded global parameters under each of
:data:`MOE_PP_RUNS`: expert parallelism (replicated, all-to-all and
sharded dispatch, top-1 and top-2), MoE x TP, the pipeline alone and with
TP, MoE, EP and the ring and Ulysses, and the references they equal (all
experts local, pure DP, the sequential encoder). The JAX side runs each
layout under ``shard_map`` on the same mesh of conftest's CPU devices from
the same global parameters (through ``interop``), dropout off. Tolerances:
loss, grad_norm and ``moe_aux`` within 1e-5 relative (f32), parameters
after 2 Adam steps within 2e-5 (PR 14's); the port's layouts against the
port's references the same. Also: the MoE parameter structure and the
specs (expert stacks over ``"expert"``, the stacked encoder alone over
``"pipeline"``, composed with TP), the rows of the sharded dispatch, the
routing of every layer at step 1 against JAX's, the interop round trip of
a MoE tree and of a stacked tree, a PP x EP checkpoint served at one
process, and the CLI under ``--moe-experts --expert-parallel
--pipeline-parallel`` against the JAX recipe's step, with its refusals
(exit 2 with the JAX CLI's reasons).
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax, bert_params_to_flax
from distributed_tensorflow_tpu_torch.models import bert

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    MOE_PP_CLI_REFUSALS,
    MOE_PP_RUNS,
    MP_BATCH,
    MP_GEOM,
    MP_LR,
    MP_STEPS,
    tiled_batch,
)
from test_torch_multiprocess import _launch  # noqa: E402

F32_TOL = 1e-5
PARAM_TOL = 2e-5
HEADS = MP_GEOM["num_heads"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mp_moe_pp")
    return d, _launch(d, "mp_moe_pp", n_groups=1 + 1 + len(MOE_PP_CLI_REFUSALS), world=4)


def _global_params(over: dict) -> dict:
    """The port's seeded global parameters of a run's config."""
    cfg = bert._global_config(bert.BertConfig(**MP_GEOM, **over))
    model = bert.BertForPreTraining(cfg, device="cpu", seed=0)
    return {k: v.detach() for k, v in model.state_dict().items()}


def _jax_batches(name: str, mesh):
    from distributed_tensorflow_tpu.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )

    spec, _, kind = MOE_PP_RUNS[name]
    if kind == "tiled":
        step = 0
        while True:
            glob = tiled_batch(step, spec.get("data", 1))
            yield {k: jax.device_put(v, NamedSharding(
                mesh, P("data") if v.ndim == 1 else P("data", None))) for k, v in glob.items()}
            step += 1
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=MP_GEOM["vocab_size"], seq_len=32,
                                           seed=0))
    yield from mlm_device_batches(data, mesh, MP_BATCH, seq_sharded=kind == "seq",
                                  expert_sharded=kind == "expert_sharded", seed=3)


def _jax_run(name: str):
    from distributed_tensorflow_tpu.data.text import bert_batch_specs
    from distributed_tensorflow_tpu.models.bert import (
        BertConfig,
        BertForPreTraining,
        bert_param_specs,
        make_bert_pretraining_loss,
    )
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state

    spec, over, kind = MOE_PP_RUNS[name]
    mesh = jax_build_mesh(spec, devices=jax.devices()[:4])
    params = jax.tree.map(jnp.asarray, bert_params_to_flax(_global_params(over), HEADS))
    tx = optax.adam(MP_LR)
    axes = {a: a if f"{a}_axis" in over else None for a in ("model", "expert", "pipeline")}
    specs = None
    if any(axes.values()):
        specs = make_state_specs(create_train_state(params, tx), tx, bert_param_specs(
            params, model_axis=axes["model"], expert_axis=axes["expert"],
            pipeline_axis=axes["pipeline"]))
    state = place_state(create_train_state(params, tx), mesh, specs)
    step = make_train_step(
        make_bert_pretraining_loss(BertForPreTraining(BertConfig(**MP_GEOM, **over))), tx,
        mesh, batch_spec=bert_batch_specs(mesh, seq_sharded=kind == "seq",
                                          expert_sharded=kind == "expert_sharded"),
        state_specs=specs)
    batches = _jax_batches(name, mesh)
    metrics = []
    for _ in range(MP_STEPS):
        state, m = step(state, next(batches), jax.random.key(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux") if k in m})
    return metrics, bert_params_from_flax(jax.tree.map(np.asarray, state.params))


def _assert_run(got: dict, metrics: list, params: dict, what: str) -> None:
    for g, w in zip(got["metrics"], metrics, strict=True):
        assert g.keys() == w.keys(), what
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL, err_msg=f"{what} {k}")
    assert got["params"].keys() == params.keys(), what
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), params[k].numpy(), atol=PARAM_TOL,
                                   err_msg=f"{what} {k}")


# The runs that are only references of other layouts (test below).
REFERENCES = ("moe_dp", "dp4_moe", "dp", "moe_seq")


@pytest.mark.parametrize("name", [n for n in MOE_PP_RUNS if n not in REFERENCES])
def test_moe_pp_training_matches_jax(ranks, name):
    """Two Adam steps under each layout of :data:`MOE_PP_RUNS` on four gloo
    ranks: every rank's loss, grad_norm and moe_aux, and the gathered
    global parameters, equal the JAX package's run on the same mesh."""
    _, rs = ranks
    metrics, params = _jax_run(name)
    if "moe_experts" in MOE_PP_RUNS[name][1]:
        assert all(m["moe_aux"] > 0 for m in metrics)
    for r in rs:
        _assert_run(r[name], metrics, params, f"{name} rank")


@pytest.mark.parametrize("layout,reference", [
    ("ep", "moe_dp"), ("tp_moe", "moe_dp"), ("sharded", "dp4_moe"), ("pp", "dp"),
    ("pp_moe", "moe_seq"), ("pp_ring", "pp_tp"), ("pp_ulysses", "pp_tp")])
def test_layouts_equal_their_references(ranks, layout, reference):
    """The port's layouts against the port's own references, as the JAX
    tests pin them: EP and MoE x TP equal all experts local; the sharded
    dispatch on {"data": 2, "expert": 2} equals pure DP over the same four
    row groups; the pipeline (with MoE on tiled batches) equals the
    sequential encoder (a stacked tree is the module list stacked); the
    ring and Ulysses inside the stages equal PP x TP on the whole batch."""
    _, rs = ranks
    ref = rs[0][reference]
    params = ref["params"]
    if layout.startswith("pp") and not reference.startswith(("pp", "moe_seq")):
        params = bert.stack_layer_state(params, MP_GEOM["num_layers"])
    for r in rs:
        _assert_run(r[layout], ref["metrics"], params, f"{layout} vs {reference}")


def test_sharded_dispatch_evaluates_over_the_expert_axis(ranks):
    """An eval step after the ``sharded`` run (``make_eval_step(batch_axes=
    ("expert",))``: the MLM and NSP sums over the data and expert axes)
    equals the same step after pure DP over the same four row groups."""
    _, rs = ranks
    for r in rs:
        got, want = r["sharded"]["eval"], r["dp4_moe"]["eval"]
        assert got.keys() == want.keys() == {"mlm_loss", "mlm_accuracy", "nsp_loss",
                                             "nsp_accuracy"}
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=F32_TOL, err_msg=k)


def test_pp_ep_equals_the_sequential_encoder_on_tiled_batches(ranks):
    """PP x EP ({"pipeline": 2, "expert": 2}) on tiled batches equals the
    sequential stacked MoE encoder with every expert local, trained here in
    one process on the same global batches (grouped per-microbatch routing
    equals the full-batch routing when every microbatch is the same)."""
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    _, rs = ranks
    over = dict(MOE_PP_RUNS["pp_ep"][1])
    for k in ("pipeline_axis", "expert_axis"):
        over.pop(k)
    over["expert_parallel"] = 1
    model = bert.BertForPreTraining(bert.BertConfig(**MP_GEOM, **over), device="cpu", seed=0)
    tx = Transform(lambda p: torch.optim.Adam(list(p.values()), lr=MP_LR), lambda c: MP_LR)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(bert.make_bert_pretraining_loss(model), tx)
    metrics = []
    for i in range(MP_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in tiled_batch(i, 1).items()}
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux")})
    params = {k: v.detach() for k, v in state.params.items()}
    for r in rs:
        _assert_run(r["pp_ep"], metrics, params, "pp_ep vs sequential")


def test_moe_bert_param_structure_and_specs():
    """MoE parameters: the router and the ``experts_*`` stacks in flax's
    layout, no dense FFN; the expert specs shard the 8 stacks (2 layers x
    w1, b1, w2, b2) over "expert" and nothing else, as JAX's do; with TP
    the stacks' hidden dim over "model" too."""
    from distributed_tensorflow_tpu.models.bert import bert_param_specs as jax_specs

    params = _global_params(dict(moe_experts=4))
    h, ff = MP_GEOM["hidden_size"], MP_GEOM["intermediate_size"]
    assert params["bert.layers.0.moe.experts_w1"].shape == (4, h, ff)
    assert params["bert.layers.0.moe.experts_w2"].shape == (4, ff, h)
    assert params["bert.layers.0.moe.router.weight"].shape == (4, h)
    assert not any("intermediate" in k or "output_bias" in k for k in params)
    specs = bert.bert_param_specs(params, None, "expert")
    sharded = sorted(k for k, s in specs.items() if s)
    assert len(sharded) == 8 and all("experts_" in k for k in sharded)
    assert all(s == (("expert", 0),) for s in map(specs.get, sharded))
    both = bert.bert_param_specs(params, "model", "expert")
    assert both["bert.layers.0.moe.experts_w1"] == (("expert", 0), ("model", 2))
    assert both["bert.layers.0.moe.experts_w2"] == (("expert", 0), ("model", 1))
    assert both["bert.layers.0.moe.experts_b2"] == (("expert", 0),)
    assert both["bert.layers.0.moe.router.weight"] is None
    flax = bert_params_to_flax(params, HEADS)
    jspecs = jax_specs(flax, model_axis="model", expert_axis="expert")
    jw1 = jspecs["bert"]["layer_0"]["moe"]["experts_w1"]
    assert tuple(jw1) == ("expert", None, "model")


def test_pp_param_specs_shard_only_the_encoder_and_compose_with_tp():
    """Stacked encoder leaves shard their leading dim over "pipeline" and
    nothing else does; with TP a Q kernel shards over both axes (the model
    dim one further in), a LayerNorm over the pipeline alone; the same
    leaves the JAX specs name."""
    from distributed_tensorflow_tpu.models.bert import bert_param_specs as jax_specs

    params = _global_params(dict(pipeline_parallel=2))
    specs = bert.bert_param_specs(params, None, None, "pipeline")
    for k, s in specs.items():
        assert (s == (("pipeline", 0),)) == ("encoder" in k), (k, s)
    both = bert.bert_param_specs(params, "model", None, "pipeline")
    assert both["bert.encoder.layer.attention.query.weight"] == (("pipeline", 0), ("model", 1))
    assert both["bert.encoder.layer.attention.out.weight"] == (("pipeline", 0), ("model", 2))
    assert both["bert.encoder.layer.ln.weight"] == (("pipeline", 0),)
    jspecs = jax_specs(bert_params_to_flax(params, HEADS), model_axis="model",
                       pipeline_axis="pipeline")
    q = jspecs["bert"]["encoder"]["layer"]["attention"]["query"]["kernel"]
    assert q[0] == "pipeline" and "model" in tuple(q)


def test_shard_params_equals_the_jax_pp_ep_placement():
    """``shard_params`` of the global stacked MoE tree for each rank of a
    {"pipeline": 2, "expert": 2} mesh equals each JAX device's shard of the
    same tree placed under ``bert_param_specs``, leaf for leaf (a leaf
    sharded over two axes)."""
    from distributed_tensorflow_tpu.models.bert import bert_param_specs as jax_specs
    from distributed_tensorflow_tpu_torch.interop import shard_params
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh

    full = _global_params(dict(moe_experts=4, pipeline_parallel=2))
    flax = bert_params_to_flax(full, HEADS)
    mesh = jax_build_mesh({"pipeline": 2, "expert": 2}, devices=jax.devices()[:4])
    placed = jax.tree.map(lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec)),
                          flax, jax_specs(flax, model_axis=None, expert_axis="expert",
                                          pipeline_axis="pipeline"),
                          is_leaf=lambda x: isinstance(x, P))
    specs = bert.bert_param_specs(full, None, "expert", "pipeline")
    for r, device in enumerate(mesh.devices.flat):
        local = jax.tree.map(lambda x, d=device: np.asarray(
            next(sh.data for sh in x.addressable_shards if sh.device == d)), placed)
        want = bert_params_from_flax(local)
        got = shard_params(full, specs, build_mesh({"pipeline": 2, "expert": 2},
                                                   world_size=4, rank=r))
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), (r, k)


@pytest.mark.parametrize("over", [dict(moe_experts=4, moe_topk=2),
                                  dict(moe_experts=4, pipeline_parallel=2)],
                         ids=["moe", "stacked"])
def test_interop_round_trip_and_forward_match_jax(over):
    """A MoE tree and a stacked (``nn.scan``) MoE tree: port -> flax ->
    port is exact, and the port's forward and mean aux equal the JAX
    model's on the converted tree within 1e-5."""
    from distributed_tensorflow_tpu.models import bert as jbert

    params = _global_params(over)
    flax = bert_params_to_flax(params, HEADS)
    back = bert_params_from_flax(flax)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)
    cfg = bert.BertConfig(**MP_GEOM, **over)
    model = bert.BertForPreTraining(cfg, device="cpu")
    model.load_state_dict(back)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, MP_GEOM["vocab_size"], (4, 32))
    mask = np.ones((4, 32), bool)
    mask[1, 20:] = False
    types = np.zeros_like(ids)
    (jl, jn), mods = jbert.BertForPreTraining(jbert.BertConfig(**MP_GEOM, **over)).apply(
        {"params": jax.tree.map(jnp.asarray, flax)}, ids, mask, types,
        mutable=["intermediates"])
    auxes = jax.tree.leaves(mods["intermediates"])
    jaux = sum(jnp.mean(a) for a in auxes) / len(auxes)
    with torch.no_grad():
        logits, nsp, aux = model.forward_with_aux(*map(torch.from_numpy, (ids, mask, types)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=F32_TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(jn), atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=F32_TOL)


def test_sharded_dispatch_splits_rows_over_the_expert_axis():
    """``process_rows`` with the expert axis as a row axis (the loaders'
    ``expert_sharded``): on {"data": 2, "expert": 2} the four ranks hold the
    four 4-row groups in JAX's device order (data, expert); without it the
    ranks of an expert line share their data shard's rows."""
    from distributed_tensorflow_tpu.data.text import bert_batch_specs
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh, process_rows

    jmesh = jax_build_mesh({"data": 2, "expert": 2}, devices=jax.devices()[:4])
    assert all("expert" in tuple(s[0]) for s in bert_batch_specs(
        jmesh, expert_sharded=True).values())
    rows = np.arange(16)
    placed = jax.device_put(rows, NamedSharding(jmesh, P(("data", "expert"))))
    for r, device in enumerate(jmesh.devices.flat):
        mesh = build_mesh({"data": 2, "expert": 2}, world_size=4, rank=r)
        start, stop = process_rows(16, mesh, ("expert",))
        want = next(np.asarray(sh.data) for sh in placed.addressable_shards if sh.device == device)
        np.testing.assert_array_equal(rows[start:stop], want)
        assert process_rows(16, mesh) == (r // 2 * 8, r // 2 * 8 + 8)


def test_routing_matches_jax_layer_by_layer(ranks):
    """Step 1 of the ``ep`` run: each layer's expert assignments and kept
    tokens on rank 0's rows (its data shard, replicated over the expert
    axis) equal JAX's routing of the same rows with the same global
    parameters, layer by layer, so a mismatch shows where it starts."""
    from distributed_tensorflow_tpu.models import bert as jbert
    from distributed_tensorflow_tpu.parallel import moe as jmoe
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )

    _, rs = ranks
    over = MOE_PP_RUNS["ep"][1]
    batch = next(mlm_device_batches(SyntheticMLM(SyntheticMLMConfig(
        vocab_size=MP_GEOM["vocab_size"], seq_len=32, seed=0)), MP_BATCH, device="cpu", seed=3))
    rows = {k: v[:MP_BATCH // 2].numpy() for k, v in batch.items()}
    flax = jax.tree.map(jnp.asarray, bert_params_to_flax(
        _global_params(dict(moe_experts=over["moe_experts"])), HEADS))
    seen = []
    route = jmoe._route

    def recording(*args):
        out = route(*args)
        seen.append((np.asarray(out[0]), np.asarray(out[3])))
        return out

    jmoe._route = recording
    try:
        jbert.BertForPreTraining(jbert.BertConfig(**MP_GEOM, moe_experts=4)).apply(
            {"params": flax}, rows["input_ids"], rows["attention_mask"],
            rows["token_type_ids"], mutable=["intermediates"])
    finally:
        jmoe._route = route
    got = rs[0]["ep"]["routing"]
    assert len(got) == len(seen) == MP_GEOM["num_layers"]
    for layer, (g, (assign, kept)) in enumerate(zip(got, seen)):
        np.testing.assert_array_equal(g["kept"].numpy(), kept, err_msg=f"layer {layer}")
        np.testing.assert_array_equal(g["assign"].numpy()[kept], assign[kept],
                                      err_msg=f"layer {layer}")


def test_pp_ep_checkpoint_serves_at_one_process(ranks):
    """The PP x EP run's checkpoint holds the global tree (every expert, the
    whole layer stack); restored at one process it is served by
    ``BertInferenceEngine`` with the stacked encoder run sequentially, and
    its predictions equal the argmax of the JAX model's logits on the same
    tree and input."""
    from distributed_tensorflow_tpu.models import bert as jbert
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    d, rs = ranks
    params, _, step = restore_serving_state(d / "ppep_ckpt")
    assert step == MP_STEPS
    for k, p in rs[0]["pp_ep"]["params"].items():
        assert torch.equal(params[k], p), k
    over = dict(MOE_PP_RUNS["pp_ep"][1])
    for k in ("pipeline_axis", "expert_axis", "pipeline_microbatches"):
        over.pop(k)
    over["expert_parallel"] = 1
    cfg = bert.BertConfig(**MP_GEOM, **over)
    engine = BertInferenceEngine(bert.BertForPreTraining(cfg, device="cpu"), params, "cpu",
                                 buckets=(32,), max_batch=1, batch_tiers=(1,))
    ids = np.random.default_rng(8).integers(5, MP_GEOM["vocab_size"], size=20)
    out = engine.run_batch([{"input_ids": ids}])[0]
    pad = np.zeros((1, 32), np.int64)
    pad[0, :20] = ids
    mask = pad != 0
    mask[0, :20] = True
    logits, _ = jbert.BertForPreTraining(jbert.BertConfig(**MP_GEOM, **over)).apply(
        {"params": jax.tree.map(jnp.asarray, bert_params_to_flax(params, HEADS))},
        pad, mask, np.zeros_like(pad), mutable=["intermediates"])[0]
    np.testing.assert_array_equal(np.asarray(out["pred_ids"]),
                                  np.asarray(logits)[0, :20].argmax(-1))


def test_cli_moe_pipeline_matches_the_jax_recipe_and_refuses(ranks):
    """``cli.train --config bert_base --moe-experts 4 --expert-parallel 2
    --pipeline-parallel 2`` as four gloo processes (2 layers, hidden 48, the
    preset's 12 heads and 128 positions, bf16, dropout off, a constant 1e-3
    with the preset's AdamW, decay mask and clipping; M = 8, the 4 x stages
    default): the log names the layout, and the logged losses equal the
    JAX step's on a {"data": 1, "pipeline": 2, "expert": 2} mesh from the
    CLI's seeded global parameters within 2e-2 (bf16), the moves within
    2e-3. ``--expert-parallel 2`` without experts and a microbatch count
    the per-shard rows do not divide exit 2 with the JAX CLI's reasons."""
    from distributed_tensorflow_tpu.cli.train import PRESETS as JAX_PRESETS
    from distributed_tensorflow_tpu.cli.train import _make_tx as jax_tx
    from distributed_tensorflow_tpu.data.text import SyntheticMLM, SyntheticMLMConfig
    from distributed_tensorflow_tpu.data.text import bert_batch_specs, mlm_device_batches
    from distributed_tensorflow_tpu.models import bert as jbert
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS

    d, rs = ranks
    assert [r["cli_codes"] for r in rs] == [[0, 2, 2]] * 4
    log = (d / "mp_moe_pp_rank0.log").read_text()
    assert "layout=pp2-ep2" in log
    for _, reason in MOE_PP_CLI_REFUSALS:
        assert reason in log
    records = [json.loads(line)
               for line in (d / "moe_pp_cli_0.jsonl").read_text().splitlines()]
    assert not (d / "moe_pp_cli_1.jsonl").exists()
    port_losses = [r["loss"] for r in records]
    assert all(r["moe_aux"] > 0 for r in records)

    width = dict(bert_layers=2, bert_hidden=48, bert_vocab=64, global_batch=8, num_steps=2,
                 lr_schedule="constant", learning_rate=1e-3, moe_experts=4,
                 expert_parallel=2, pipeline_parallel=2)
    pcfg = dataclasses.replace(PRESETS["bert_base"], **width)
    init = pcfg.build(pcfg)("cpu")["params"]  # the global tree (stacked, every expert)
    flax = jax.tree.map(jnp.asarray, bert_params_to_flax(
        {k: v.detach() for k, v in init.items()}, num_heads=12))
    jcfg = dataclasses.replace(JAX_PRESETS["bert_base"], **width)
    tx, _ = jax_tx(jcfg)
    mesh = jax_build_mesh({"data": 1, "pipeline": 2, "expert": 2}, devices=jax.devices()[:4])
    specs = make_state_specs(create_train_state(flax, tx), tx, jbert.bert_param_specs(
        flax, model_axis=None, expert_axis="expert", pipeline_axis="pipeline"))
    state = place_state(create_train_state(flax, tx), mesh, specs)
    cfg = jbert.BertConfig(vocab_size=64, hidden_size=48, num_layers=2, intermediate_size=192,
                           max_position=128, dropout_rate=0.0, dtype=jnp.bfloat16,
                           moe_experts=4, expert_axis="expert", expert_parallel=2,
                           pipeline_axis="pipeline", pipeline_parallel=2,
                           pipeline_microbatches=8)
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
    [(["--moe-experts", "4", "--moe-dispatch", "sharded"],
      "--moe-dispatch=sharded requires --expert-parallel > 1"),
     (["--moe-experts", "2", "--moe-topk", "3"], "--moe-topk=3 must be in [1, --moe-experts=2]"),
     (["--moe-topk", "0"], "--moe-topk must be >= 1")],
    ids=["sharded-without-ep", "topk-range", "topk-zero"],
)
def test_cli_refuses_moe_requests_with_exit_2(argv, message, capsys):
    from distributed_tensorflow_tpu_torch.cli.train import main

    with pytest.raises(SystemExit) as e:
        main(["--config", "bert_base", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_serve_cli_refuses_serving_layouts_naming_6c(tmp_path, capsys, caplog):
    """The serve CLI's mesh and MoE flags, refused until Queue A item 6c,
    are ported with it: they pass the argument checks, a layout that does
    not fit this one process falls back with the warning, and the run goes
    on to the (empty) checkpoint directory."""
    import logging

    from distributed_tensorflow_tpu_torch.cli.serve import main

    for flags in (["--ep", "2"], ["--pp", "2"], ["--moe-experts", "4"], ["--mesh", "data=2"]):
        caplog.clear()
        with caplog.at_level(logging.WARNING), pytest.raises(FileNotFoundError,
                                                            match="no checkpoint"):
            main(["--config", "bert_base", "--ckpt-dir", str(tmp_path), "--device", "cpu",
                  *flags])
        assert "Queue A item 6c" not in capsys.readouterr().err
        assert ("falling back" in caplog.text) == (flags[0] in ("--ep", "--pp", "--mesh"))
