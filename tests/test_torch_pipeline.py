"""Port parity: GPipe pipeline parallelism (``parallel/pipeline.py``) on the
CPU, mirroring the JAX package's ``tests/test_pipeline.py``.

The torch side is one gloo job of ``tests/_torch_mp_worker.py``
(``mp_pipe``, four ranks: S = 4 stages, under ``_launch``'s deadline, so a
schedule whose backward hangs fails in seconds) against the JAX package
under ``shard_map`` on the same meshes of conftest's CPU devices and
against the sequential stack: the forward of an 8-layer residual stack at
M = 4 (1e-5), 3 SGD steps of the toy classifier (loss and grad_norm within
1e-5 relative, the gathered parameters within 1e-5), a bad microbatch
split and ``mask_bubble="off"`` raising, and the masked and unmasked
schedules bitwise equal, also with a layer that runs a ring over
``"seq"`` inside each stage (``{"pipeline": 2, "seq": 2}``).
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
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distributed_tensorflow_tpu.parallel import pipeline as jpipe
from distributed_tensorflow_tpu.parallel.mesh import build_mesh as jax_build_mesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mp_worker import (  # noqa: E402
    PIPE_D,
    pipe_batches,
    pipe_params,
    pipe_ring_inputs,
)
from test_torch_multiprocess import _launch  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def pipe_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("mp_pipe"), "mp_pipe", world=4)


def _jax_layer(p, h):
    return h + jnp.tanh(h @ p["w"] + p["b"])


def _stack(params):
    return {"w": params["w"], "b": params["b"]}


def _sequential(stack, h):
    return lax.scan(lambda h, p: (_jax_layer(p, h), None), h, stack)[0]


def test_pipeline_forward_matches_sequential(pipe_ranks):
    """S = 4 stages, M = 4: every rank's output equals the sequential stack
    and JAX's ``pipeline_apply`` on a {"pipeline": 4} mesh; the masked
    ("auto", True) and unmasked schedules are bitwise equal."""
    params = pipe_params()
    x = np.random.default_rng(0).standard_normal((16, PIPE_D)).astype(np.float32)
    ref = np.asarray(_sequential(_stack(params), jnp.asarray(x)))
    mesh = jax_build_mesh({"pipeline": 4}, devices=jax.devices()[:4])
    specs = jpipe.pipeline_param_specs(_stack(params))
    run = jax.jit(jax.shard_map(
        lambda p, x: jpipe.pipeline_apply(_jax_layer, p, x, n_microbatches=4, mask_bubble=False),
        mesh=mesh, in_specs=(specs, P()), out_specs=P(), check_vma=False))
    want = np.asarray(run(_stack(params), jnp.asarray(x)))
    for r in pipe_ranks:
        fwd = r["forward"]
        np.testing.assert_allclose(fwd["False"].numpy(), ref, atol=TOL)
        np.testing.assert_allclose(fwd["False"].numpy(), want, atol=TOL)
        assert torch.equal(fwd["auto"], fwd["False"]) and torch.equal(fwd["True"], fwd["False"])


def test_pipeline_training_matches_sequential(pipe_ranks):
    """3 SGD-momentum steps of the toy classifier with its 8-layer stack
    stage-sharded over S = 4: every rank's loss and grad_norm and the
    gathered parameters equal JAX's run on the same mesh and the port's
    sequential run; so the hand-offs' backward ran on every rank."""
    from distributed_tensorflow_tpu.train import create_train_state, make_train_step
    from distributed_tensorflow_tpu.train.step import make_state_specs, place_state
    from distributed_tensorflow_tpu_torch.train import create_train_state as t_state
    from distributed_tensorflow_tpu_torch.train import make_train_step as t_step
    from distributed_tensorflow_tpu_torch.train.state import Transform

    params = pipe_params()
    tree = {"stack": _stack(params), "head": {"w": params["head_w"], "b": params["head_b"]}}

    def loss_fn(p, model_state, batch, rng):
        h = jpipe.pipeline_apply(_jax_layer, p["stack"], batch["x"], n_microbatches=4)
        logits = h @ p["head"]["w"] + p["head"]["b"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["label"]).mean(), (model_state, {})

    tx = optax.sgd(0.1, momentum=0.9)
    mesh = jax_build_mesh({"pipeline": 4}, devices=jax.devices()[:4])
    host = create_train_state(tree, tx)
    specs = make_state_specs(host, tx, {"stack": jpipe.pipeline_param_specs(tree["stack"]),
                                        "head": {"w": P(), "b": P()}})
    state = place_state(host, mesh, specs)
    step = make_train_step(loss_fn, tx, mesh, state_specs=specs)
    ref_metrics = []
    for x, y in pipe_batches():
        state, m = step(state, {"x": jnp.asarray(x), "label": jnp.asarray(y)},
                        jax.random.key(0))
        ref_metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    got_ref = jax.device_get(state.params)
    ref_params = {"w": got_ref["stack"]["w"], "b": got_ref["stack"]["b"],
                  "head_w": got_ref["head"]["w"], "head_b": got_ref["head"]["b"]}

    def seq_loss(p, model_state, batch, generator):
        h = batch["x"]
        for i in range(p["w"].shape[0]):
            h = h + torch.tanh(h @ p["w"][i] + p["b"][i])
        logits = h @ p["head_w"] + p["head_b"]
        return torch.nn.functional.cross_entropy(logits, batch["label"]), (model_state, {})

    tparams = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    ttx = Transform(lambda p: torch.optim.SGD(list(p.values()), lr=0.1, momentum=0.9),
                    lambda c: 0.1)
    tstate = t_state(tparams, ttx)
    tstep = t_step(seq_loss, ttx)
    for x, y in pipe_batches():
        tstate, _ = tstep(tstate, {"x": torch.from_numpy(x), "label": torch.from_numpy(y)},
                          torch.Generator().manual_seed(0))
    for r in pipe_ranks:
        got = r["train"]
        for g, w in zip(got["metrics"], ref_metrics):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=TOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=TOL)
        for k, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), np.asarray(ref_params[k]), atol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(p.numpy(), tstate.params[k].detach().numpy(),
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("key,message",
                         [("bad_split", "batch 16 not divisible by n_microbatches 5"),
                          ("bad_mask", "mask_bubble must be True, False, or 'auto'")],
                         ids=["microbatch-split", "mask-off"])
def test_pipeline_rejects_bad_arguments(pipe_ranks, key, message):
    for r in pipe_ranks:
        assert message in r[key]


def test_bubble_mask_with_a_seq_ring_in_the_stage(pipe_ranks):
    """A layer whose stage runs a ``ppermute`` ring over "seq" (JAX's
    ``ring_layer``) on a {"pipeline": 2, "seq": 2} mesh: the masked
    schedule ("auto", whose skipped ticks are skipped by both ranks of each
    seq group) is bitwise the unmasked one, and both equal JAX's unmasked
    schedule under ``shard_map``."""
    w, x = pipe_ring_inputs()

    def ring_layer(p, h):
        ring = lax.axis_size("seq")
        perm = [(i, (i + 1) % ring) for i in range(ring)]

        def body(carry, _):
            acc, kv = carry
            acc = acc + h * kv.sum(axis=1, keepdims=True)
            return (acc, lax.ppermute(kv, "seq", perm)), None

        (acc, _), _ = lax.scan(body, (jnp.zeros_like(h), h @ p["w"]), None, length=ring)
        return jnp.tanh(acc)

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pipeline", "seq"))
    run = jax.jit(jax.shard_map(
        lambda p, x: jpipe.pipeline_apply(ring_layer, p, x, n_microbatches=4,
                                          mask_bubble=False),
        mesh=mesh, in_specs=(P("pipeline"), P(None, "seq")), out_specs=P(None, "seq"),
        check_vma=False))
    want = np.asarray(run({"w": w}, jnp.asarray(x)))
    width = x.shape[1] // 2
    for rank, r in enumerate(pipe_ranks):
        ring = r["ring"]
        assert torch.equal(ring["auto"], ring["False"])
        cols = slice((rank % 2) * width, (rank % 2 + 1) * width)
        np.testing.assert_allclose(ring["False"].numpy(), want[:, cols], atol=TOL)
