"""Port parity: mixture-of-experts routing and dispatch
(``parallel/moe.py``) on the CPU, mirroring the JAX package's
``tests/test_moe.py``.

Routing (``switch_route``, ``switch_route_topk``) runs in this process
beside the JAX functions on the same seeded logits: assignments, slots and
kept masks equal exactly, gates and the aux within 1e-6. The expert-parallel
cases run as one gloo job of ``tests/_torch_mp_worker.py`` (``mp_moe``, two
ranks on an ``{"expert": 2}`` mesh) against the JAX package under
``shard_map`` on the same mesh of conftest's CPU devices and against the
single-shard stack: ``moe_apply`` top-1 and top-2 and ``moe_apply_a2a``
top-2 values within 1e-5, and 3 SGD steps of the toy classifier (loss,
grad_norm and the gathered parameters within 1e-5).
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
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel import moe as jmoe
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh
from distributed_tensorflow_tpu_torch.parallel import moe

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    MOE_E,
    moe_toy_batches,
    moe_toy_expert,
    moe_toy_params,
    moe_toy_tokens,
)
from test_torch_multiprocess import _launch  # noqa: E402

TOL = 1e-5
ROUTE_TOL = 1e-6


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("mp_moe"), "mp_moe")


def _jax_expert(p, tokens):
    return jnp.tanh(tokens @ p["w1"]) @ p["w2"]


def _routed(fn, *args, **kw):
    out = fn(*args, **kw)
    return [np.asarray(o.detach() if isinstance(o, torch.Tensor) else o) for o in out]


@pytest.mark.parametrize("valid", [False, True], ids=["all", "padded"])
def test_switch_route_matches_jax_capacity_and_slots(valid):
    """Top-1 routing of 64 tokens over 8 experts at capacity 5: the port's
    assignments, slots and kept tokens equal JAX's, gates and aux within
    1e-6; no expert over capacity, slots unique, pads never kept."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, MOE_E)).astype(np.float32)
    mask = rng.random(64) > 0.3 if valid else None
    got = _routed(moe.switch_route, torch.from_numpy(logits), 5,
                  None if mask is None else torch.from_numpy(mask))
    want = _routed(jmoe.switch_route, jnp.asarray(logits), 5,
                   None if mask is None else jnp.asarray(mask))
    assign, gate, slot, kept, aux = got
    for name, g, w in zip(("assign", "gate", "slot", "kept", "aux"), got, want):
        if name in ("gate", "aux"):
            np.testing.assert_allclose(g, w, atol=ROUTE_TOL, err_msg=name)
        elif name == "slot":
            np.testing.assert_array_equal(g[kept], w[kept])
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    for e in range(MOE_E):
        mine = kept & (assign == e)
        assert mine.sum() <= 5 and len(set(slot[mine].tolist())) == mine.sum()
    if mask is not None:
        assert not kept[~mask].any()
    assert float(aux) > 0


def test_switch_route_pads_consume_no_capacity():
    """JAX's interleaved-pads case: pads (huge logits toward expert 0) are
    never kept, real tokens keep the slots of a pad-free call, the aux
    equals the pad-free one; and equal to JAX's routing of the same."""
    rng = np.random.default_rng(3)
    n, cap = 48, 3
    real = rng.normal(size=(n, MOE_E)).astype(np.float32)
    pads = np.full((n, MOE_E), -1.0, np.float32)
    pads[:, 0] = 10.0
    inter = np.stack([real, pads], 1).reshape(2 * n, MOE_E)
    valid = np.stack([np.ones(n, bool), np.zeros(n, bool)], 1).reshape(2 * n)
    a_ref, _, s_ref, k_ref, aux_ref = _routed(moe.switch_route, torch.from_numpy(real), cap)
    a, _, s, k, aux = _routed(moe.switch_route, torch.from_numpy(inter), cap,
                              torch.from_numpy(valid))
    assert not k[1::2].any()
    np.testing.assert_array_equal(k[0::2], k_ref)
    np.testing.assert_array_equal(s[0::2][k_ref], s_ref[k_ref])
    np.testing.assert_allclose(aux, aux_ref, atol=ROUTE_TOL)
    want = _routed(jmoe.switch_route, jnp.asarray(inter), cap, jnp.asarray(valid))
    np.testing.assert_array_equal(k, want[3])
    np.testing.assert_allclose(aux, want[4], atol=ROUTE_TOL)


def test_moe_apply_pads_emit_zero_and_match_jax():
    """``moe_apply`` on a padded batch (one shard): pads emit exactly 0, real
    tokens equal a pad-free call at the matching capacity, and the outputs
    and aux equal JAX's within 1e-5."""
    params = moe_toy_params()
    full = {k: torch.from_numpy(v) for k, v in params.items()}
    n_real, n_pad = 24, 8
    x_real = moe_toy_tokens(5, n_real)
    x = np.concatenate([x_real, np.zeros((n_pad, x_real.shape[1]), np.float32)])
    valid = np.concatenate([np.ones(n_real, bool), np.zeros(n_pad, bool)])
    logits = x @ params["router"]
    experts = {"w1": full["w1"], "w2": full["w2"]}
    y, aux = moe.moe_apply(moe_toy_expert, experts, torch.from_numpy(logits),
                           torch.from_numpy(x), axis_name=None,
                           valid=torch.from_numpy(valid))
    assert y[n_real:].abs().max() == 0.0
    y_ref, aux_ref = moe.moe_apply(moe_toy_expert, experts,
                                   torch.from_numpy(logits[:n_real]), torch.from_numpy(x_real),
                                   axis_name=None,
                                   capacity_factor=1.25 * (n_real + n_pad) / n_real)
    np.testing.assert_allclose(y[:n_real].numpy(), y_ref.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(aux_ref), atol=1e-6)
    jy, jaux = jmoe.moe_apply(_jax_expert, {"w1": params["w1"], "w2": params["w2"]},
                              jnp.asarray(logits), jnp.asarray(x), axis_name=None,
                              valid=jnp.asarray(valid))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL)


def test_switch_route_topk_semantics():
    """GShard top-2 on JAX's four-token case: renormalised gates, first
    choices fill queues before any second choice, ties to the lower
    expert; and random logits with ties route as JAX's ``lax.top_k`` does."""
    logits = torch.tensor([[4.0, 3.0, 0.0], [4.0, 3.0, 0.0], [3.0, 4.0, 0.0],
                           [0.0, 0.0, 5.0]])
    assign, gate, slot, kept, aux = moe.switch_route_topk(logits, capacity=2, k=2)
    assert assign.shape == (4, 2)
    assert assign[:, 0].tolist() == [0, 0, 1, 2] and assign[3, 1] == 0
    np.testing.assert_allclose(gate.sum(-1).numpy(), np.ones(4), rtol=1e-6)
    assert kept[:, 0].all() and not kept[2, 1] and not kept[3, 1]
    assert kept[0, 1] and not kept[1, 1]
    assert float(aux) > 0
    rng = np.random.default_rng(9)
    tied = rng.integers(0, 3, size=(40, MOE_E)).astype(np.float32)  # many ties
    got = _routed(moe.switch_route_topk, torch.from_numpy(tied), 7, 2)
    want = _routed(jmoe.switch_route_topk, jnp.asarray(tied), 7, 2)
    for name, g, w in zip(("assign", "gate", "slot", "kept", "aux"), got, want):
        if name in ("gate", "aux"):
            np.testing.assert_allclose(g, w, atol=ROUTE_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _expert_mesh():
    return jax_build_mesh({"expert": 2}, devices=jax.devices()[:2])


def _jax_sharded(fn, experts, logits, x, **kw):
    specs = jmoe.expert_param_specs(experts)
    run = jax.jit(jax.shard_map(
        lambda p, lg, xx: fn(_jax_expert, p, lg, xx, axis_name="expert", **kw),
        mesh=_expert_mesh(), in_specs=(specs, P(), P()), out_specs=(P(), P()),
        check_vma=False))
    return run(experts, logits, x)


def test_moe_apply_matches_single_shard(moe_ranks):
    """``moe_apply`` top-1 at EP 2 (each rank its 4 experts, outputs summed
    over the axis): every rank's output and aux equal the single-shard
    stack's and JAX's at EP 2."""
    params = moe_toy_params()
    x = moe_toy_tokens(1, 32)
    logits = x @ params["router"]
    experts = {"w1": params["w1"], "w2": params["w2"]}
    y_ref, aux_ref = moe.moe_apply(moe_toy_expert, {k: torch.from_numpy(v)
                                                    for k, v in experts.items()},
                                   torch.from_numpy(logits), torch.from_numpy(x),
                                   axis_name=None)
    jy, jaux = _jax_sharded(jmoe.moe_apply, experts, jnp.asarray(logits), jnp.asarray(x))
    for r in moe_ranks:
        y, aux = r["top1"]
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
        np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("name", ["top2", "top2_a2a"])
def test_moe_apply_topk2_matches_single_shard(moe_ranks, name):
    """Top-2 at EP 2 with capacity to spare (factor 16): ``moe_apply`` and
    the all-to-all dispatch equal the single-shard stack and JAX's
    ``moe_apply``/``moe_apply_a2a`` under ``shard_map``."""
    params = moe_toy_params()
    x = moe_toy_tokens(2, 64)
    logits = moe_toy_tokens(3, 64)[:, :MOE_E].copy()
    experts = {"w1": params["w1"], "w2": params["w2"]}
    y_ref, aux_ref = moe.moe_apply(moe_toy_expert, {k: torch.from_numpy(v)
                                                    for k, v in experts.items()},
                                   torch.from_numpy(logits), torch.from_numpy(x),
                                   axis_name=None, capacity_factor=16.0, topk=2)
    assert float(y_ref.abs().sum()) > 0
    fn, kw = ((jmoe.moe_apply, {}) if name == "top2"
              else (jmoe.moe_apply_a2a, {"stats_axes": ("expert",)}))
    jy, jaux = _jax_sharded(fn, experts, jnp.asarray(logits), jnp.asarray(x),
                            capacity_factor=16.0, topk=2, **kw)
    for r in moe_ranks:
        y, aux = r[name]
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
        np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _jax_toy_train():
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state

    params = moe_toy_params()
    tree = {"router": params["router"], "experts": {"w1": params["w1"], "w2": params["w2"]},
            "head": params["head"]}

    def loss_fn(p, model_state, batch, rng):
        x = batch["x"]
        y, aux = jmoe.moe_apply(_jax_expert, p["experts"], x @ p["router"], x,
                                axis_name="expert")
        logits = (x + y) @ p["head"]
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean() + 0.01 * aux
        return loss, (model_state, {"aux": aux})

    tx = optax.sgd(0.1, momentum=0.9)
    mesh = _expert_mesh()
    host = create_train_state(tree, tx)
    specs = make_state_specs(host, tx, {"router": P(), "head": P(),
                                        "experts": jmoe.expert_param_specs(tree["experts"])})
    state = place_state(host, mesh, specs)
    step = make_train_step(loss_fn, tx, mesh, state_specs=specs)
    metrics = []
    for x, y in moe_toy_batches():
        state, m = step(state, {"x": jnp.asarray(x), "label": jnp.asarray(y)},
                        jax.random.key(0))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
    p = jax.device_get(state.params)
    return metrics, {"router": p["router"], "w1": p["experts"]["w1"],
                     "w2": p["experts"]["w2"], "head": p["head"]}


def test_moe_training_matches_jax_and_single_shard(moe_ranks):
    """3 SGD-momentum steps of the toy classifier (router, 8 experts over an
    {"expert": 2} mesh, head; CE + 0.01 aux): every rank's loss, grad_norm
    (the global norm) and aux, and the gathered parameters, equal JAX's run
    on the same mesh within 1e-5; and the single-shard port run's."""
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu_torch.train.state import Transform
    from _torch_mp_worker import moe_toy_loss

    ref_metrics, ref_params = _jax_toy_train()
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in moe_toy_params().items()}
    tx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1, momentum=0.9),
                   lambda c: 0.1)
    state = create_train_state(params, tx)
    step = make_train_step(moe_toy_loss(None), tx)
    for x, y in moe_toy_batches():
        state, _ = step(state, {"x": torch.from_numpy(x), "label": torch.from_numpy(y)},
                        torch.Generator().manual_seed(0))
    for r in moe_ranks:
        got = r["train"]
        for g, w in zip(got["metrics"], ref_metrics):
            for k in ("loss", "grad_norm", "aux"):
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, err_msg=k)
        for k, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), np.asarray(ref_params[k]), atol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(p.numpy(), state.params[k].detach().numpy(), atol=TOL,
                                       err_msg=k)
