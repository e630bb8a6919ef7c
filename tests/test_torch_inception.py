"""Port parity: Inception-v3 against the JAX package, block by block.

Params cross through :mod:`distributed_tensorflow_tpu_torch.interop`; inputs
and cotangents come from numpy. f32 on the CPU, at small spatial sizes with
the blocks' true channel widths. Each block (``BasicConv`` with a 1x7 and a
7x1 kernel, A-E, the aux head at its 17x17 grid) is held to flax in train
mode (output, new batch_stats and every parameter's gradient of
``sum(out * cot)``) and in eval mode (output on the running averages);
``InceptionC`` and ``InceptionE`` also with ``fused=True`` at M = 400,
against the JAX fused backward in Pallas interpret mode; then the whole
model's eval forward at 75x75 and the interop round trip of the full 299x299
tree with the aux head. Tolerances: 1e-4 absolute and relative (f32
convolutions and BatchNorm sums over the batch in another order, through
up to five layers), scaled by a gradient leaf's largest entry where that
exceeds 1; the interop round trip is exact. The JAX references
are jitted and the flax trees built with ``jax.eval_shape`` plus numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import inception as jinc
from distributed_tensorflow_tpu_torch.interop import (
    image_params_from_flax,
    image_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import inception as inc
from distributed_tensorflow_tpu_torch.models import resnet as port_resnet
from distributed_tensorflow_tpu_torch.models.resnet import BatchNorm, BatchStats
from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

TOL = 1e-4


def _random_variables(init, rng):
    """A flax variable tree of ``init``'s shapes (``jax.eval_shape``: no
    compile) filled from ``rng``: He-scaled kernels, BN scales, biases and
    running averages away from their init."""

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(rng.standard_normal(s.shape))
        return 0.1 * rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda path, s: fill(path, s).astype(np.float32), jax.eval_shape(init))


def _close(got, ref, tol=TOL, scale=1.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol * scale, rtol=tol)


# name -> (flax module, port module factory, input shape [B, H, W, C]).
BLOCKS = {
    "basic_1x7": (lambda f: jinc.BasicConv(160, (1, 7), fused=f),
                  lambda f: inc.BasicConv(128, 160, (1, 7), fused=f), (2, 5, 7, 128)),
    "basic_7x1": (lambda f: jinc.BasicConv(192, (7, 1), fused=f),
                  lambda f: inc.BasicConv(160, 192, (7, 1), fused=f), (2, 7, 5, 160)),
    "A": (lambda f: jinc.InceptionA(32, fused=f),
          lambda f: inc.InceptionA(192, 32, fused=f), (2, 5, 5, 192)),
    "B": (lambda f: jinc.InceptionB(fused=f),
          lambda f: inc.InceptionB(288, fused=f), (2, 7, 7, 288)),
    "C": (lambda f: jinc.InceptionC(128, fused=f),
          lambda f: inc.InceptionC(768, 128, fused=f), (2, 5, 5, 768)),
    "D": (lambda f: jinc.InceptionD(fused=f),
          lambda f: inc.InceptionD(768, fused=f), (2, 7, 7, 768)),
    "E": (lambda f: jinc.InceptionE(fused=f),
          lambda f: inc.InceptionE(1280, fused=f), (2, 3, 3, 1280)),
    "aux": (lambda f: jinc.InceptionAux(10, fused=f),
            lambda f: inc.InceptionAux(768, 10, fused=f), (8, 17, 17, 768)),
}


def _port_block(factory, fused, variables):
    block = factory(fused)
    for name, mod in block.named_modules():
        if isinstance(mod, BatchNorm):
            mod.key = name
    sd, stats = image_params_from_flax(variables["params"], variables["batch_stats"])
    block.load_state_dict(sd)  # strict: same names, same shapes
    return block, stats


def _check_block(name, fused, batch=None, monkeypatch=None):
    """The port's block against flax's; returns how many times the fused
    backward ran."""
    jmodule, factory, shape = BLOCKS[name]
    if batch is not None:
        shape = (batch, *shape[1:])
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.standard_normal(shape).astype(np.float32)
    variables = _random_variables(
        lambda: jmodule(False).init(jax.random.key(0), x, train=False), rng)
    jm = jmodule(fused)
    out_shape = jax.eval_shape(lambda: jm.apply(variables, x, train=False)).shape
    cot = rng.standard_normal(out_shape).astype(np.float32)
    out, new, grads, eval_out = _jax_reference(jm, variables, x, cot)

    block, stats = _port_block(factory, fused, variables)
    calls = []
    if monkeypatch is not None:
        bn_bwd = fcb._bn_bwd
        monkeypatch.setattr(fcb, "_bn_bwd", lambda *a: calls.append(1) or bn_bwd(*a))
    bs = BatchStats(stats, train=True)
    got = block(torch.from_numpy(x), bs)
    params = dict(block.named_parameters())
    g = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), list(params.values()))
    _close(got, out)
    _, ref_new = image_params_from_flax({}, new)
    assert bs.new.keys() == ref_new.keys()
    for k in ref_new:
        _close(bs.new[k], ref_new[k])
    ref_grads, _ = image_params_from_flax(grads)
    assert params.keys() == ref_grads.keys()
    for k, gk in zip(params, g):
        # f32 sums over B*H*W terms: the error scales with the leaf's size.
        _close(gk, ref_grads[k], scale=max(1.0, ref_grads[k].abs().max().item()))
    with torch.no_grad():
        _close(block(torch.from_numpy(x), BatchStats(stats, train=False)), eval_out)
    return len(calls)


def _run_jitted(fn, *args):
    """``jax.jit(fn)(*args)`` as numpy, compiled at XLA's lowest backend
    optimisation level: the references run once, and that halves their
    compile time on the CPU (the convolutions are library calls either
    way)."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jax.tree.map(np.asarray, compiled(*args))


def _jax_reference(module, variables, x, cot):
    """Train-mode output, new batch_stats and parameter gradients of
    ``sum(out * cot)``, and the eval-mode output, from one jitted call."""

    def run(params, stats, x, cot):
        def loss(params):
            out, new = module.apply({"params": params, "batch_stats": stats}, x, train=True,
                                    mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, new["batch_stats"])

        (_, (out, new)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        eval_out = module.apply({"params": params, "batch_stats": stats}, x, train=False)
        return out, new, grads, eval_out

    return _run_jitted(run, variables["params"], variables["batch_stats"], x, cot)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    _check_block(name, fused=False)


@pytest.mark.parametrize("name,units", [("C", 4), ("E", 4)])
def test_fused_block_matches_jax_fused(name, units, monkeypatch):
    """``fused=True`` at batch 16 on a 5x5 grid (M = 400, which the fused
    predicate takes): the 1x1 units run the fused backward's plain version
    here and the Pallas kernels in interpret mode on the JAX side."""
    assert fcb.fused_supported(16 * 5 * 5, BLOCKS[name][2][-1], 192)
    assert _check_block(name, fused=True, batch=16, monkeypatch=monkeypatch) == units


def test_inception_v3_forward_at_75(monkeypatch):
    """The whole model without aux at 75x75 (the smallest input it takes):
    eval logits on the running averages within 1e-4. (Train mode is held
    block by block above: through 94 train-mode BatchNorms over 2 images on
    1x1 grids, f32 rounding in another order grows past any useful bound.)
    A train-mode forward collects every layer's new statistics, and with
    dropout on it needs a generator."""
    rng = np.random.default_rng(75)
    x = rng.standard_normal((2, 75, 75, 3)).astype(np.float32)
    jnet = jinc.InceptionV3(num_classes=10, aux_logits=False)
    variables = _random_variables(lambda: jnet.init(jax.random.key(0), x, train=False), rng)
    eval_out = _run_jitted(lambda v, x: jnet.apply(v, x, train=False), variables, x)
    monkeypatch.setattr(port_resnet, "truncated_normal_", lambda t, *args: t)
    monkeypatch.setattr(inc, "truncated_normal_", lambda t, *args: t)
    model = inc.InceptionV3(num_classes=10, aux_logits=False, device="cpu")
    sd, stats = image_params_from_flax(variables["params"], variables["batch_stats"])
    model.load_state_dict(sd)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        eval_logits, same = model(xt, stats, train=False)
        logits, new_stats = model(xt, stats, train=True, generator=torch.Generator())
        with pytest.raises(ValueError, match="torch.Generator"):
            model(xt, stats, train=True)
    _close(eval_logits, eval_out)
    assert same is stats
    assert new_stats.keys() == stats.keys() == model.init_batch_stats().keys()
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


def _rel_l2(got: dict, ref: dict) -> float:
    """Relative L2 error of a dict of arrays against a reference, over the
    whole dict."""
    diff = sum(float(np.sum((np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64))**2))
               for k in ref)
    return (diff / sum(float(np.sum(np.asarray(r, np.float64)**2)) for r in ref.values()))**0.5


def test_bf16_gradient_gap_is_the_references(monkeypatch):
    """How far bf16 moves the whole model's gradient is the reference's own
    property, not the port's: at 75x75, 8 images, train-mode BatchNorm and
    the classification loss on one set of weights, the JAX package's bf16
    gradient sits as far from its fp32 gradient as the port's bf16 sits
    from the port's fp32 (measured 1.48 and 1.44 relative L2), while the two
    fp32 gradients agree to f32 rounding in another order amplified through
    94 BatchNorms (0.067). Holds the port's gap to at most 1.25 times the
    reference's, the reference's gap to at least 0.5 (the sensitivity the
    card's bf16-versus-fp32 readings rest on) and the fp32 pair to 0.25.
    Prints the three numbers."""
    import torch.nn.functional as F

    b, hw, classes = 8, 75, 10
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, hw, hw, 3)).astype(np.float32)
    onehot = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, b)]
    jnet = jinc.InceptionV3(num_classes=classes, aux_logits=False, dropout_rate=0.0)
    variables = _random_variables(lambda: jnet.init(jax.random.key(0), x, train=False), rng)

    def jax_grads(dtype):
        net = jinc.InceptionV3(num_classes=classes, aux_logits=False, dropout_rate=0.0,
                               dtype=dtype)

        def run(params, stats, x):
            def loss(p):
                out, _ = net.apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])
                return -(onehot * jax.nn.log_softmax(out.astype(jnp.float32))).sum(-1).mean()

            return jax.grad(loss)(params)

        return image_params_from_flax(
            _run_jitted(run, variables["params"], variables["batch_stats"], x))[0]

    monkeypatch.setattr(port_resnet, "truncated_normal_", lambda t, *args: t)
    monkeypatch.setattr(inc, "truncated_normal_", lambda t, *args: t)
    sd, stats = image_params_from_flax(variables["params"], variables["batch_stats"])

    def port_grads(dtype):
        model = inc.InceptionV3(num_classes=classes, aux_logits=False, dropout_rate=0.0,
                                dtype=dtype, device="cpu")
        model.load_state_dict(sd)
        out, _ = model(torch.from_numpy(x), stats, train=True, generator=torch.Generator())
        loss = -(torch.from_numpy(onehot) * F.log_softmax(out.float(), -1)).sum(-1).mean()
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        return {n: g.float().numpy() for n, g in zip(params, grads)}

    ref32, ref16 = jax_grads(jnp.float32), jax_grads(jnp.bfloat16)
    got32, got16 = port_grads(torch.float32), port_grads(torch.bfloat16)
    assert got32.keys() == ref32.keys()
    ref_gap, port_gap = _rel_l2(ref16, ref32), _rel_l2(got16, got32)
    fp32_pair = _rel_l2(got32, ref32)
    print(f"bf16 vs fp32 gradient, relative L2: JAX package {ref_gap}, port {port_gap}; "
          f"port fp32 vs JAX fp32 {fp32_pair}")
    assert fp32_pair <= 0.25
    assert ref_gap >= 0.5
    assert port_gap <= 1.25 * ref_gap


def test_interop_round_trips_inception_v3_with_aux(monkeypatch):
    """The full 299x299 tree with the aux head (27,161,264 params, as
    torchvision's inception_v3 with aux): exact both ways."""
    shapes = jax.eval_shape(lambda: jinc.InceptionV3().init(
        jax.random.key(0), jnp.zeros((1, 299, 299, 3)), train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape, np.float32), shapes)
    sd, stats = image_params_from_flax(variables["params"], variables["batch_stats"])
    monkeypatch.setattr(port_resnet, "truncated_normal_", lambda t, *args: t)
    monkeypatch.setattr(inc, "truncated_normal_", lambda t, *args: t)
    model = inc.InceptionV3(device="cpu")
    model.load_state_dict(sd)  # strict: same names, same shapes
    assert sum(v.numel() for v in sd.values()) == 27_161_264
    assert stats.keys() == model.init_batch_stats().keys()
    assert model.aux.BasicConv_1.Conv_0.weight.shape == (768, 128, 5, 5)
    params, back_stats = image_params_to_flax(model.state_dict(), stats)
    flat = jax.tree_util.tree_flatten_with_path
    for tree, ref in ((params, variables["params"]), (back_stats, variables["batch_stats"])):
        got, ref_leaves = flat(tree)[0], flat(ref)[0]
        assert [p for p, _ in got] == [p for p, _ in ref_leaves]
        for (_, a), (_, b) in zip(got, ref_leaves):
            np.testing.assert_array_equal(a, b)
