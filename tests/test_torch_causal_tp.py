"""Port parity: the causal LM's tensor parallelism, for training and for
decode serving over a serving group, mirroring the JAX package's TP cases
(``tests/test_serve_decode.py``'s ``tp_decode_engine``/``tp_prefix_engine``
tests, ``tests/test_quant.py::test_int8_agreement_tp_mesh``, the causal
LM's TP train step).

The port's side is one gloo job of ``tests/_torch_mp_worker.py``
(``causal_tp``, two ranks on a ``{"data": 1, "model": 2}`` mesh) from one
seeded global parameter tree: 2 SGD steps under TP; the decode engine
(the JAX tests' 7 mixed requests mid-flight), the prefix-cache engine (a
shared 12-token head, replayed) and the int8 weights + KV engine
(teacher-forced agreement against the fp32 full forward) over a serving
group; ``cli.train --config lm_base --tensor-parallel 2`` and ``cli.serve
--tp 2`` on its checkpoint; and a group whose follower dies. Here: the TP
steps against the one-process port step and JAX's under ``shard_map`` on
the same mesh (the BERT TP tests' tolerances: loss and grad_norm 1e-5
relative, parameters 2e-5 absolute, f32); the group's greedy fp32 streams equal the
one-process engine's and the full forward's; int8 agreement >= 0.95; the
TP checkpoint restored and served at TP 1; ``_serve_config``'s refusals
with the JAX messages.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu.serve import CausalLMEngine as JaxEngine
from distributed_tensorflow_tpu_torch.interop import (
    causal_lm_params_from_flax,
    causal_lm_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import causal_lm as P
from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    CAUSAL_PREFIX_KW,
    CAUSAL_TP_GEOM,
    CAUSAL_TP_KW,
    CAUSAL_TP_LR,
    CAUSAL_TP_STEPS,
    LM_TP_CLI_ARGS,
    causal_tp_params,
    greedy_reference,
    lm_batch,
    mixed_requests,
    shared_prefix_requests,
)
from test_torch_multiprocess import _launch  # noqa: E402

F32_TOL, PARAM_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("causal_tp")
    return d, _launch(d, "causal_tp", n_groups=4, world=2, codes=(0, 3))


def _plain():
    model = P.CausalLM(P.CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu")
    model.load_state_dict(causal_tp_params())
    return model


def _single_engine(**kw):
    return CausalLMEngine(P.CausalLM(P.CausalLMConfig(**CAUSAL_TP_GEOM), device="cpu"),
                          causal_tp_params(), "cpu", **CAUSAL_TP_KW, **kw)


def test_config_and_specs():
    """TP validation, and the specs: BERT's suffix rules, nothing else."""
    with pytest.raises(ValueError, match="must divide num_heads"):
        P.CausalLMConfig(**{**CAUSAL_TP_GEOM, "model_parallel": 4}, model_axis="model")
    with pytest.raises(ValueError, match="needs a model_axis"):
        P.CausalLMConfig(**CAUSAL_TP_GEOM, model_parallel=2)
    specs = P.causal_param_specs(causal_tp_params())
    sharded = {k: v for k, v in specs.items() if v is not None}
    assert sharded == {f"layers.{i}.{leaf}": (("model", dim),) for i in range(2)
                       for leaf, dim in (("attention.query.weight", 0),
                                         ("attention.query.bias", 0),
                                         ("attention.key.weight", 0), ("attention.key.bias", 0),
                                         ("attention.value.weight", 0),
                                         ("attention.value.bias", 0),
                                         ("attention.out.weight", 1),
                                         ("intermediate.weight", 0), ("intermediate.bias", 0),
                                         ("output.weight", 1))}
    # The JAX spec tree marks the same leaves (through interop's names).
    flax = causal_lm_params_to_flax(causal_tp_params(), CAUSAL_TP_GEOM["num_heads"])
    jspecs = J.causal_param_specs(flax)
    n_jax = sum(1 for s in jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)) if "model" in tuple(s))
    assert n_jax == len(sharded)


def _jax_train():
    from distributed_tensorflow_tpu.data.text import lm_batch_specs
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    mesh = jax_build_mesh({"data": 1, "model": 2}, devices=jax.devices()[:2])
    flax = jax.tree.map(jnp.asarray, causal_lm_params_to_flax(causal_tp_params(),
                                                              CAUSAL_TP_GEOM["num_heads"]))
    tx = optax.sgd(CAUSAL_TP_LR)
    specs = make_state_specs(create_train_state(flax, tx), tx, J.causal_param_specs(flax))
    state = place_state(create_train_state(flax, tx), mesh, specs)
    cfg = J.CausalLMConfig(**CAUSAL_TP_GEOM, model_axis="model", model_parallel=2)
    step = make_train_step(J.make_causal_lm_loss(J.CausalLM(cfg)), tx, mesh,
                           batch_spec=lm_batch_specs(mesh), state_specs=specs)
    metrics = []
    for i in range(CAUSAL_TP_STEPS):
        batch = {k: jax.device_put(v, NamedSharding(mesh, PS("data", None)))
                 for k, v in lm_batch(i).items()}
        state, m = step(state, batch, jax.random.key(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, causal_lm_params_from_flax(jax.tree.map(np.asarray, state.params))


def _port_single_train():
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    model = _plain()
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=CAUSAL_TP_LR),
                   lambda c: CAUSAL_TP_LR)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(P.make_causal_lm_loss(model), tx)
    metrics = []
    for i in range(CAUSAL_TP_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(i).items()}
        state, m = step(state, batch, torch.Generator().manual_seed(1))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, {k: v.detach() for k, v in state.params.items()}


def test_tp_train_steps_match_single_process_and_jax(ranks):
    _, outs = ranks
    got = outs[0]["train"]
    for what, (metrics, params) in (("one process", _port_single_train()),
                                    ("JAX", _jax_train())):
        for g, w in zip(got["metrics"], metrics, strict=True):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL, err_msg=f"{what} {k}")
        assert got["params"].keys() == params.keys()
        for k, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), params[k].numpy(), atol=PARAM_TOL,
                                       err_msg=f"{what} {k}")


def _single_streams(requests, warm_first=False, **kw):
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher

    with ContinuousBatcher(_single_engine(**kw), BatcherConfig(max_batch=2, max_queue=32)) as b:
        if warm_first:
            b.submit(dict(requests[0])).result(timeout=120)
        return [f.result(timeout=120)["tokens"] for f in [b.submit(dict(r)) for r in requests]]


def test_greedy_parity_mid_flight_tp_mesh(ranks):
    """7 requests through 3 slots: every stream of the TP group equals the
    one-process engine's and the full-forward reference (fp32)."""
    _, outs = ranks
    got = outs[0]["decode"]
    assert got["layout"] == "tp2"
    assert got["mesh_info"]["devices_per_engine"] == 2
    reqs = mixed_requests()
    assert got["streams"] == _single_streams(reqs)
    plain = _plain()
    for stream, r in zip(got["streams"], reqs):
        assert stream == greedy_reference(plain, r["input_ids"], r["max_new_tokens"])


def test_prefix_cache_greedy_parity_tp_mesh(ranks):
    """Pool pages and slot caches split by head: the replayed shared-head
    requests hit the pool and still stream the cold path's tokens."""
    _, outs = ranks
    got = outs[0]["prefix"]
    reqs = shared_prefix_requests(13)
    assert got["prefix_hits"] >= 3
    plain = _plain()
    refs = [greedy_reference(plain, r["input_ids"], r["max_new_tokens"]) for r in reqs]
    assert got["first"] == refs[0]
    assert got["streams"] == refs == _single_streams(reqs, warm_first=True,
                                                     **CAUSAL_PREFIX_KW)


def test_page_cells_carry_whole_heads_over_the_group(ranks):
    """The prefix-page and slot-page export/import cells of a TP group:
    stages carry every head (gathered onto the leader, cut to each rank's
    heads on import), and a round trip through them is exact."""
    _, outs = ranks
    got = outs[0]["prefix"]
    heads = CAUSAL_TP_GEOM["num_heads"]
    assert got["page_heads"] == got["stream_heads"] == heads
    assert got["stage_shape"][-2] == got["slot_shape"][-2] == heads
    assert got["pool_round_trip"] and got["slot_round_trip"]


def test_int8_agreement_tp_mesh(ranks):
    _, outs = ranks
    got = outs[0]["int8"]
    assert got["weight_dtype"] == got["kv_dtype"] == "int8"
    assert got["total"] >= 30
    assert got["ratio"] >= 0.95


def test_serve_config_refuses_expert_and_pipeline_axes():
    """The decode engine serves TP only: the JAX engine's refusals, message
    for message; ``_plan_prefix_cache`` refuses heads the axis cannot split."""
    cfg, jcfg = P.CausalLMConfig(**CAUSAL_TP_GEOM), J.CausalLMConfig(**CAUSAL_TP_GEOM)
    for tp, ep, pp in ((1, 2, 1), (1, 1, 2), (4, 1, 1)):
        with pytest.raises(ValueError) as want:
            JaxEngine._serve_config(jcfg, tp, ep, pp)
        with pytest.raises(ValueError) as got:
            CausalLMEngine._serve_config(cfg, tp, ep, pp)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JaxEngine._plan_prefix_cache(jcfg, tp=4, prefix_cache_mb=1.0)
    with pytest.raises(ValueError) as got:
        CausalLMEngine._plan_prefix_cache(cfg, tp=4, prefix_cache_mb=1.0)
    assert str(got.value) == str(want.value)
    assert CausalLMEngine._plan_spec(cfg, tp=2, spec_tokens=2, max_new_tokens=8) == 2
    assert CausalLMEngine._plan_quant(cfg, tp=2, weight_dtype="int8", kv_dtype="int8") == (
        "int8", "int8")


def test_cli_trains_at_tp2_and_restores_at_tp1(ranks):
    """``cli.train --config lm_base --tensor-parallel 2`` as two ranks: its
    checkpoint holds the global tree, restores at TP 1 and serves there;
    ``cli.serve --tp 2`` serves it as a leader with a follower."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state

    d, outs = ranks
    assert [o["train_rc"] for o in outs[:1]] == [0] and outs[0]["serve_rc"] == 0
    log = (d / "causal_tp_rank0.log").read_text()
    assert "layout=tp2" in log and "(layout tp2)" in log and "selftest ok: 4 requests" in log
    assert "serving group rank 1: stop after" in (d / "causal_tp_rank1.log").read_text()
    params, _, step = restore_serving_state(d / "lm_tp_ckpt")
    assert step == 2
    cfg = P.CausalLMConfig(vocab_size=64, hidden_size=48, num_layers=1, intermediate_size=192,
                           max_position=128, dtype=torch.bfloat16)
    model = P.CausalLM(cfg, device="cpu")
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    engine = CausalLMEngine(model, params, "cpu", buckets=(16,), slots=2, max_batch=1,
                            max_new_tokens=4)
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, ContinuousBatcher

    with ContinuousBatcher(engine, BatcherConfig(max_batch=1)) as b:
        out = b.submit({"input_ids": np.arange(5, 15), "max_new_tokens": 4}).result(timeout=60)
    assert len(out["tokens"]) == 4
    assert LM_TP_CLI_ARGS[LM_TP_CLI_ARGS.index("--tensor-parallel") + 1] == "2"


def test_a_dead_follower_fails_the_leader(ranks):
    """No fallback: the follower exits after warm-up, the leader's next
    cell raises, and every later one raises naming the broken group."""
    _, outs = ranks
    first, second = outs[0]["dead_follower"]
    assert first is not None
    assert second is not None and "serving group broken" in second
    assert outs[1] is None  # the follower exited with code 3


def test_a_follower_that_takes_no_cell_fails_the_leader_within_the_timeout(tmp_path):
    """The leader's broadcast waits at most the job's collective timeout:
    a follower that lives but never takes the next cell (over NCCL, one
    SIGKILLed mid-decode left the leader waiting in the control channel
    for good) makes the cell raise within it, and the next one at once."""
    out = _launch(tmp_path, "stuck_follower", world=2, codes=(0, 3))[0]
    first, second = out["errors"]
    assert first is not None and "timed out" in first.lower()
    assert out["seconds"][0] < 15
    assert second is not None and "serving group broken" in second
    assert out["seconds"][1] < 1
