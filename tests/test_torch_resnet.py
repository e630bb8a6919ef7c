"""Port parity: the image models against the JAX package.

Params cross through :mod:`distributed_tensorflow_tpu_torch.interop`; inputs
come from numpy. f32 on the CPU. The slice as a whole is two tiny
bottleneck ResNets, each run through the port's three 1x1 backends
(``conv``, ``pallas``, ``fused``; their plain paths on CPU tensors) and held
to the JAX package's ``conv`` backend: new batch_stats, the loss and every
gradient, eval-mode logits on the running averages, and
one SGD-momentum step through ``make_train_step``. (The JAX package pins its
own ``fused`` backend to its ``conv`` backend in
``tests/test_fused_conv_bn.py``.) Tolerances: 1e-5 on the loss, 1e-4
elsewhere (convolutions and BatchNorm sums over the batch in another
order, through eight layers).
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import resnet as jresnet
from distributed_tensorflow_tpu.models.lenet import LeNet5 as JLeNet5
from distributed_tensorflow_tpu.train import objectives as jobj
from distributed_tensorflow_tpu_torch.interop import (
    resnet_params_from_flax,
    resnet_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import LeNet5, ResNet20, ResNet50
from distributed_tensorflow_tpu_torch.models.resnet import (
    BottleneckBlock,
    ResNet,
    SpaceToDepthStem,
    conv2d_nhwc,
)
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
from distributed_tensorflow_tpu_torch.ops import pointwise_conv as pc
from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss

TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def _random_variables(init, rng):
    """A flax variable tree of ``init``'s shapes (``jax.eval_shape``: no
    compile) filled from ``rng``: He-scaled kernels, BN scales, biases and
    running averages away from their init, so every leaf has a gradient and
    eval mode reads real statistics."""

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1])))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(rng.standard_normal(s.shape))
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, s: fill(path, s).astype(np.float32), jax.eval_shape(init))


def test_interop_round_trips_resnet20_and_lenet():
    x = jnp.zeros((1, 8, 8, 3))
    rng = np.random.default_rng(0)
    variables = _random_variables(
        lambda: jresnet.ResNet20().init(jax.random.key(0), x, train=False), rng)
    sd, stats = resnet_params_from_flax(variables["params"], variables["batch_stats"])
    model = ResNet20(device="cpu")
    model.load_state_dict(sd)  # strict: same names, same shapes
    assert stats.keys() == model.init_batch_stats().keys()
    params, back_stats = resnet_params_to_flax(model.state_dict(), stats)
    _assert_trees_equal(params, variables["params"])
    _assert_trees_equal(back_stats, variables["batch_stats"])

    img = rng.standard_normal((2, 28, 28, 1)).astype(np.float32)
    jnet = JLeNet5()
    lp = _random_variables(lambda: jnet.init(jax.random.key(1), img), rng)["params"]
    lenet = LeNet5(device="cpu")
    lenet.load_state_dict(resnet_params_from_flax(lp)[0])
    with torch.no_grad():
        got = lenet(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply({"params": lp}, img)), atol=1e-5)
    _assert_trees_equal(resnet_params_to_flax(lenet.state_dict())[0], lp)
    with pytest.raises(NotImplementedError, match="int8"):
        resnet_params_from_flax({"head": {"kernel": {"_q8": np.zeros(2, np.int8)}}})


def test_interop_maps_resnet50_shapes(monkeypatch):
    import distributed_tensorflow_tpu_torch.models.resnet as port_resnet

    # Shapes only: no values drawn on either side (the params do not
    # depend on the input size, so a 32x32 trace does).
    shapes = jax.eval_shape(
        lambda: jresnet.ResNet50().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                        train=False))
    empty = jax.tree.map(lambda s: np.empty(s.shape, np.float32), shapes)
    sd, stats = resnet_params_from_flax(empty["params"], empty["batch_stats"])
    monkeypatch.setattr(port_resnet, "truncated_normal_", lambda t, *args: t)
    model = ResNet50(device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sd["stem_conv.weight"].shape == (64, 3, 7, 7)
    assert stats.keys() == model.init_batch_stats().keys()
    assert sum(v.numel() for v in sd.values()) == 25_557_032


def test_space_to_depth_stem_equals_plain_stem():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    stem = SpaceToDepthStem(3, 8)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(rng.standard_normal((8, 3, 7, 7)).astype(np.float32)))
        got = stem(x)
        ref = conv2d_nhwc(x, stem.weight, 2, ((3, 3), (3, 3)))
    assert got.shape == (2, 8, 8, 8)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _jax_reference(stage_sizes, filters, x, labels):
    net = jresnet.ResNet(stage_sizes=stage_sizes, block=jresnet.BottleneckBlock,
                         num_filters=filters, num_classes=7, stem="cifar")
    variables = _random_variables(lambda: net.init(jax.random.key(1), x, train=False),
                                  np.random.default_rng(7))
    params, stats = variables["params"], variables["batch_stats"]

    @jax.jit
    def run(params, stats, x, labels):
        loss_fn = jobj.make_classification_loss(net)
        (loss, (new_state, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, {"batch_stats": stats}, {"image": x, "label": labels}, jax.random.key(0))
        eval_logits = net.apply({"params": params, **new_state}, x, train=False)
        tx = optax.sgd(0.1, momentum=0.9)
        updates, _ = tx.update(grads, tx.init(params), params)
        return {"new_stats": new_state["batch_stats"], "loss": loss,
                "grads": grads, "eval_logits": eval_logits,
                "stepped": optax.apply_updates(params, updates)}

    out = _np_tree(run(params, stats, x, labels))
    return {"params": params, "stats": stats, **out, "loss": float(out["loss"])}


# (stage_sizes, num_filters, units routed to the dgrad kernel, to the N=64
# dgrad, to the fused backward): 128 filters engage all three fused
# flavours (Conv_0 with ReLU, the zero-BN Conv_2, the strided proj); 64
# filters engage the N = 64 route (stage 1, block 2, Conv_0 256 -> 64).
GEOMETRIES = [((1, 1), 128, 6, 0, 6), ((2, 1), 64, 3, 1, 3)]


@pytest.fixture(scope="module", params=GEOMETRIES, ids=["filters128", "filters64"])
def reference(request):
    stage_sizes, filters, *routes = request.param
    rng = np.random.default_rng(11)
    x = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 7, 8).astype(np.int32)
    return stage_sizes, filters, routes, x, labels, _jax_reference(stage_sizes, filters, x, labels)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("backend", ["conv", "pallas", "fused"])
def test_tiny_resnet_matches_jax(reference, backend, monkeypatch):
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step

    stage_sizes, filters, (n_dgrad, n_n64, n_fused), x, labels, ref = reference
    calls = collections.Counter()
    dgrad, bn_bwd = pc._dgrad, fcb._bn_bwd
    monkeypatch.setattr(pc, "_dgrad",
                        lambda g, w, route: calls.update([route]) or dgrad(g, w, route))
    monkeypatch.setattr(fcb, "_bn_bwd", lambda *a: calls.update(["fused"]) or bn_bwd(*a))

    model = ResNet(stage_sizes, BottleneckBlock, num_filters=filters, num_classes=7,
                   stem="cifar", pw_backend=backend, device="cpu")
    sd, stats = resnet_params_from_flax(ref["params"], ref["stats"])
    model.load_state_dict(sd)
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels)
    with torch.no_grad():
        _, new_stats = model(xt, stats, train=True)
    _, ref_new = resnet_params_from_flax({}, ref["new_stats"])
    assert new_stats.keys() == ref_new.keys()
    for k in ref_new:
        _close(new_stats[k], ref_new[k])
    with torch.no_grad():
        eval_logits, same = model(xt, ref_new, train=False)
    assert same is ref_new
    _close(eval_logits, ref["eval_logits"])

    recipe = dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                                 learning_rate=0.1, momentum=0.9, optimizer="sgd")
    tx, _ = _make_tx(recipe)
    params = dict(model.named_parameters())
    loss_fn = make_classification_loss(model)
    batch = {"image": xt, "label": yt}
    loss, _ = loss_fn(params, {"batch_stats": stats}, batch, None)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(loss.item() - ref["loss"]) <= 1e-5
    ref_grads, _ = resnet_params_from_flax(ref["grads"])
    for name, g in grads.items():
        _close(g, ref_grads[name])
    expected = {"pw_dgrad": n_dgrad, "pw_dgrad_n64": n_n64} if backend == "pallas" else (
        {"fused": n_fused} if backend == "fused" else {})
    expected = {k: v for k, v in expected.items() if v}
    assert {k: v for k, v in calls.items() if v} == expected

    state = create_train_state(params, tx, {"batch_stats": stats})
    state, metrics = make_train_step(loss_fn, tx)(state, batch, torch.Generator())
    assert abs(metrics["loss"].item() - ref["loss"]) <= 1e-5
    stepped, _ = resnet_params_from_flax(ref["stepped"])
    for name, p in state.params.items():
        _close(p.detach(), stepped[name])
    for k in ref_new:
        _close(state.model_state["batch_stats"][k], ref_new[k])


def test_train_flops_count_every_conv_and_dense():
    """``train_flops_per_image`` against the formula it documents, summed
    by hand from each conv's output grid: 3 x (2 x H_out x W_out x kh x kw
    x C_in x C_out per conv, 2 x in x out for the head)."""
    from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image
    from distributed_tensorflow_tpu_torch.models.resnet import Conv

    model = ResNet20(device="cpu")
    grids = []
    hooks = [m.register_forward_hook(lambda m, i, out: grids.append((m, out.shape)))
             for m in model.modules() if isinstance(m, Conv)]
    flops = train_flops_per_image(model, (8, 8, 3))
    for h in hooks:
        h.remove()
    forward = sum(2 * s[1] * s[2] * m.weight.numel() for m, s in grids)
    forward += 2 * model.head.weight.numel()
    assert len(grids) == 21 and flops == 3 * forward
