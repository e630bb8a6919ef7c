"""Port parity at width 4: every model-parallel layout on one axis of 4.

At width 2 (the other model-parallel tests) a shift by +1 and by -1 is the
same permutation and an all-to-all has two chunk positions, so a wrong
hop sign in the ring or the pipeline's hand-off, or a wrong chunk order in
Ulysses or the MoE dispatch, cannot show. Here each layout runs on a mesh
whose one axis of 4 spans the job, so the axis's group is the world group
(``parallel/mesh.py``'s whole-job branch), as four gloo ranks of
``tests/_torch_mp_worker.py`` in two launches:

- ``axis4_train``: one Adam step of the 2-layer ``MP_GEOM`` BERT (4 heads,
  an FFN of 128; 4 layers under the pipeline, one a stage) from the seeded
  global parameters under TP 4, Ulysses 4, the ring over 4 with its einsum
  and its flash inner (the kernel's plain version here, the Pallas kernel
  in interpret mode on the JAX side), EP 4 with 8 experts under the
  replicated, all-to-all, sharded and sharded top-2 dispatches, and PP 4 at
  M = 4; against the JAX package's step under ``shard_map`` on a 4-device
  CPU mesh (``jax.devices()[:4]``) from the same parameters, dropout off.
  Tolerances: ``tests/test_torch_model_parallel.py``'s and
  ``tests/test_torch_bert_moe_pp.py``'s, loss, grad_norm and ``moe_aux``
  within 1e-5 relative (f32), parameters within 2e-5;
- ``axis4_serve``: the ``SERVE_BERT_GEOM`` BERT served over a group under
  TP 4, EP 4 (8 experts, replicated dispatch) and PP 4, against the port's
  one-process engine and the JAX engine on the same mesh at
  ``tests/test_torch_serve_mesh.py``'s tolerances (``_assert_parity``);
  then a 4-head causal LM's mixed requests over a ``{"model": 4}`` serving
  group, whose greedy fp32 streams must equal the one-process engine's, the
  port's full forward's and the JAX model's full forward's exactly
  (``tests/test_torch_causal_tp.py``'s check at TP 2).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import causal_lm as jcausal
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu.serve import BertInferenceEngine as JaxEngine
from distributed_tensorflow_tpu_torch.interop import (
    bert_params_from_flax,
    bert_params_to_flax,
    causal_lm_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import bert
from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine, CausalLMEngine

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    AXIS4_RUNS,
    AXIS4_SERVE,
    AXIS4_STEPS,
    CAUSAL4_GEOM,
    CAUSAL_TP_KW,
    MP_BATCH,
    MP_GEOM,
    MP_LR,
    SERVE_BERT_GEOM,
    SERVE_ENGINE_KW,
    causal4_params,
    greedy_reference,
    mixed_requests,
    serve_bert,
    serve_payloads,
)
from test_torch_multiprocess import _launch  # noqa: E402
from test_torch_serve_mesh import _assert_parity  # noqa: E402

F32_TOL = 1e-5  # loss, grad_norm, moe_aux: relative
PARAM_TOL = 2e-5  # parameters after the step: absolute


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("axis4_train"), "axis4_train", world=4)


@pytest.fixture(scope="module")
def serve_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("axis4_serve"), "axis4_serve", world=4)


def _mesh(spec: dict):
    return jax_build_mesh(spec, devices=jax.devices()[:4])


def _jax_batches(kind: str, mesh):
    from distributed_tensorflow_tpu.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )

    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=MP_GEOM["vocab_size"], seq_len=32,
                                           seed=0))
    return mlm_device_batches(data, mesh, MP_BATCH, seq_sharded=kind == "seq",
                              expert_sharded=kind == "expert_sharded", seed=3)


def _jax_run(name: str):
    """The layout's step in the JAX package, on the same mesh of 4 CPU
    devices from the port's seeded global parameters."""
    from distributed_tensorflow_tpu.data.text import bert_batch_specs
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state

    spec, over, kind = AXIS4_RUNS[name]
    geom = {**MP_GEOM, **over}
    global_cfg = bert._global_config(bert.BertConfig(**geom))
    init = {k: v.detach() for k, v in
            bert.BertForPreTraining(global_cfg, device="cpu", seed=0).state_dict().items()}
    params = jax.tree.map(jnp.asarray, bert_params_to_flax(init, MP_GEOM["num_heads"]))
    mesh = _mesh(spec)
    tx = optax.adam(MP_LR)
    axes = {a: a if f"{a}_axis" in over else None for a in ("model", "expert", "pipeline")}
    specs = None
    if any(axes.values()):
        specs = make_state_specs(create_train_state(params, tx), tx, jbert.bert_param_specs(
            params, model_axis=axes["model"], expert_axis=axes["expert"],
            pipeline_axis=axes["pipeline"]))
    state = place_state(create_train_state(params, tx), mesh, specs)
    step = make_train_step(
        jbert.make_bert_pretraining_loss(jbert.BertForPreTraining(jbert.BertConfig(**geom))),
        tx, mesh, batch_spec=bert_batch_specs(mesh, seq_sharded=kind == "seq",
                                              expert_sharded=kind == "expert_sharded"),
        state_specs=specs)
    batches = _jax_batches(kind, mesh)
    metrics = []
    for _ in range(AXIS4_STEPS):
        state, m = step(state, next(batches), jax.random.key(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "moe_aux") if k in m})
    return metrics, bert_params_from_flax(jax.tree.map(np.asarray, state.params))


@pytest.mark.parametrize("name", list(AXIS4_RUNS))
def test_width4_training_layout_matches_jax(train_ranks, name):
    """One Adam step on an axis of 4 (the world group): every rank's loss,
    grad_norm (and ``moe_aux``) and its gathered parameters equal the JAX
    package's step on the same 4-device mesh."""
    metrics, params = _jax_run(name)
    for r, out in enumerate(train_ranks):
        got = out[name]
        assert got["world_group"], f"rank {r}: the axis's group is not the world group"
        for g, w in zip(got["metrics"], metrics, strict=True):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL, err_msg=f"rank {r} {k}")
        assert got["params"].keys() == params.keys()
        for k, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), params[k].numpy(), atol=PARAM_TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", list(AXIS4_SERVE))
def test_width4_serving_group_matches_single_process_and_jax(serve_ranks, name):
    """A serving group of 4 under TP 4, EP 4 and PP 4: a lone request (tier
    1) and a full tier (4) against the port's one-process engine and the
    JAX engine on the same mesh."""
    got = serve_ranks[0][name]
    spec, over, wd = AXIS4_SERVE[name]
    label = f"{name}4"
    assert got["layout"] == label
    assert got["mesh_info"] == {"layout": label, "mesh_shape": spec, "devices_per_engine": 4,
                                "platform": "cpu"}
    if name == "ep":
        assert got["moe_dispatch"] == "replicated"
    model, params = serve_bert(over)
    single = BertInferenceEngine(model, params, "cpu", weight_dtype=wd, **SERVE_ENGINE_KW)
    flax = jax.tree.map(jnp.asarray, bert_params_to_flax(params, SERVE_BERT_GEOM["num_heads"]))
    jeng = JaxEngine(jbert.BertForPreTraining(jbert.BertConfig(**{**SERVE_BERT_GEOM, **over})),
                     flax, _mesh(spec), weight_dtype=wd, **SERVE_ENGINE_KW)
    assert jeng.layout == label
    payloads = serve_payloads()
    for n in (1, 4):
        _assert_parity(single.run_batch(payloads[:n]), got["results"][n])
        _assert_parity(jeng.run_batch(payloads[:n]), got["results"][n])


def _jax_greedy(requests: list) -> list:
    """Each request's greedy tokens from the JAX causal LM's full forward on
    the same parameters, the prompt padded to the model's length (causal:
    the padding after it changes nothing before it)."""
    cfg = jcausal.CausalLMConfig(**CAUSAL4_GEOM)
    model = jcausal.CausalLM(cfg)
    flax = jax.tree.map(jnp.asarray, causal_lm_params_to_flax(causal4_params(),
                                                             CAUSAL4_GEOM["num_heads"]))
    length = CAUSAL4_GEOM["max_position"]
    forward = jax.jit(lambda p, ids, mask: model.apply({"params": p}, ids, mask))
    streams = []
    for r in requests:
        toks = [int(t) for t in r["input_ids"]]
        out = []
        for _ in range(r["max_new_tokens"]):
            ids = np.zeros((1, length), np.int32)
            ids[0, :len(toks)] = toks
            mask = np.arange(length)[None, :] < len(toks)
            logits = forward(flax, ids, mask)
            out.append(int(np.argmax(np.asarray(logits[0, len(toks) - 1]))))
            toks.append(out[-1])
        streams.append(out)
    return streams


def test_width4_causal_tp_streams_match_one_process_and_jax(serve_ranks):
    """7 mixed requests through 3 slots of a ``{"model": 4}`` serving group
    (one head a rank): every greedy fp32 stream equals the one-process
    engine's, the port's full forward's and the JAX model's."""
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher

    got = serve_ranks[0]["causal"]
    assert got["layout"] == "tp4"
    assert got["mesh_info"]["devices_per_engine"] == 4
    reqs = mixed_requests()
    params = causal4_params()
    engine = CausalLMEngine(CausalLM(CausalLMConfig(**CAUSAL4_GEOM), device="cpu"), params,
                            "cpu", **CAUSAL_TP_KW)
    with ContinuousBatcher(engine, BatcherConfig(max_batch=2, max_queue=32)) as b:
        single = [f.result(timeout=120)["tokens"] for f in [b.submit(dict(r)) for r in reqs]]
    assert got["streams"] == single
    plain = CausalLM(CausalLMConfig(**CAUSAL4_GEOM), device="cpu")
    plain.load_state_dict(params)
    assert got["streams"] == [greedy_reference(plain, r["input_ids"], r["max_new_tokens"])
                              for r in reqs]
    assert got["streams"] == _jax_greedy(reqs)


def test_width4_layouts_name_one_axis_of_the_whole_job():
    """Every layout here is one axis of 4 (the job's world), so a wrong
    shift sign or chunk order cannot hide behind a width-2 symmetry."""
    assert all(list(spec.values()) == [4] for spec, _, _ in AXIS4_RUNS.values())
    assert all(list(spec.values()) == [4] for spec, _, _ in AXIS4_SERVE.values())
