"""Port parity: BERT pretraining loss, gradients and train steps against JAX.

The JAX side runs on a 1-device mesh (``tests/conftest.py`` makes 8 CPU
devices; an 8-way JAX step would average per-shard MLM ratios, which a
one-process port does not). Params come from one seeded init, handed to
the JAX side as its flax tree by ``interop``; batches are ``SyntheticMLM`` numpy batches fed to
both. Dropout is off in every comparison (the two frameworks cannot draw
the same bits); its own test checks the rate and the scaling.

Tolerances, fp32: loss 1e-5 absolute; gradients 2e-5 absolute (sums over
a few hundred tokens of order-1 terms in another order); after AdamW steps
params 2e-5 (the update is lr-sized, about 1e-3, and Adam's
m / sqrt(v) is insensitive to the gradients' last bits except where a
gradient is near zero, which the decay-free embedding rows of unseen tokens
are exactly, in both). bf16: loss 2e-2 and gradients 5e-3 + 5% of each
leaf's largest gradient, because the two frameworks round activations and
logits to bf16 at different places.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForPreTraining as JaxBert,
    make_bert_pretraining_loss as jax_loss,
)
from distributed_tensorflow_tpu_torch.data.text import SyntheticMLM, SyntheticMLMConfig
from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax, bert_params_to_flax
from distributed_tensorflow_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    dropout,
    make_bert_pretraining_loss,
)
from distributed_tensorflow_tpu_torch.train import create_train_state, make_train_step

GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64, dropout_rate=0.0)
# The train-step comparisons run one layer: they test the step, not depth.
STEP_GEOM = dict(GEOM, num_layers=1)
L = 32


def _params(geom):
    """Seeded params as the flax tree (numpy leaves), made by the port and
    converted by ``interop`` (whose round trip is exact)."""
    model = BertForPreTraining(BertConfig(**geom), device="cpu", seed=0)
    return bert_params_to_flax(model.state_dict(), geom["num_heads"])


@pytest.fixture(scope="module")
def flax_params():
    return _params(GEOM)


@pytest.fixture(scope="module")
def step_params():
    return _params(STEP_GEOM)


@pytest.fixture(scope="module")
def mesh1():
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh

    return build_mesh({"data": 1}, devices=jax.devices()[:1])


def _batches(n, b=8, seed=3):
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=GEOM["vocab_size"], seq_len=L, seed=0))
    out = []
    for i in range(n):
        batch = data.batch(b, seed=(seed, i))
        batch["attention_mask"][0, L - 5:] = False  # a padded row
        out.append(batch)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _torch_model(flax_params, geom=GEOM, **cfg):
    model = BertForPreTraining(BertConfig(**{**geom, **cfg}), device="cpu")
    model.load_state_dict(bert_params_from_flax(flax_params))
    return model


def _assert_tree_close(port_tree, jax_tree, atol, rel=0.0, path=""):
    for key, ref in jax_tree.items():
        if isinstance(ref, dict):
            _assert_tree_close(port_tree[key], ref, atol, rel, f"{path}/{key}")
        else:
            ref = np.asarray(ref, np.float32)
            tol = atol + rel * float(np.abs(ref).max())
            np.testing.assert_allclose(port_tree[key], ref, atol=tol, err_msg=f"{path}/{key}")


@pytest.mark.parametrize(
    "attn_impl,dtype",
    [("flash", "float32"), ("dense", "float32"), ("flash", "bfloat16")],
)
def test_pretraining_loss_and_grads_match_jax(flax_params, attn_impl, dtype):
    batch = _batches(1)[0]
    jm = JaxBert(JaxBertConfig(**GEOM, attn_impl=attn_impl, dtype=getattr(jnp, dtype)))
    grad_fn = jax.jit(jax.value_and_grad(jax_loss(jm), has_aux=True))
    (j_loss, (_, j_metrics)), j_grads = grad_fn(
        flax_params, {}, jax.tree.map(jnp.asarray, batch), jax.random.key(0))

    model = _torch_model(flax_params, attn_impl=attn_impl, dtype=getattr(torch, dtype))
    params = dict(model.named_parameters())
    loss, (_, metrics) = make_bert_pretraining_loss(model)(params, {}, _torch_batch(batch), None)
    grads = torch.autograd.grad(loss, list(params.values()))
    port = bert_params_to_flax(dict(zip(params, grads)), GEOM["num_heads"])

    fp32 = dtype == "float32"
    np.testing.assert_allclose(loss.item(), float(j_loss), atol=1e-5 if fp32 else 2e-2)
    np.testing.assert_allclose(metrics["mlm_accuracy"].item(),
                               float(j_metrics["mlm_accuracy"]), atol=1e-6 if fp32 else 0.05)
    _assert_tree_close(port, jax.tree.map(np.asarray, j_grads),
                       atol=2e-5 if fp32 else 5e-3, rel=0.0 if fp32 else 0.05)


def _jax_run(flax_params, mesh, cfg, batches, *, mode="sync", staleness=0, grad_accum=1):
    from distributed_tensorflow_tpu.cli.train import _make_tx
    from distributed_tensorflow_tpu.train import create_train_state as j_create
    from distributed_tensorflow_tpu.train import make_train_step as j_step
    from distributed_tensorflow_tpu.train.step import place_state

    tx, _ = _make_tx(cfg)
    state = place_state(
        j_create(jax.tree.map(jnp.asarray, flax_params), tx, staleness=staleness), mesh)
    step = j_step(jax_loss(JaxBert(JaxBertConfig(**STEP_GEOM, attn_impl="dense"))), tx, mesh,
                  mode=mode, staleness=staleness, clip_norm=cfg.clip_norm,
                  grad_accum=grad_accum)
    losses = []
    for batch in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        losses.append(float(metrics["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


def _port_run(flax_params, cfg, batches, *, mode="sync", staleness=0, grad_accum=1,
              after_each=None):
    from distributed_tensorflow_tpu_torch.cli.train import _make_tx

    model = _torch_model(flax_params, STEP_GEOM, attn_impl="dense")
    tx, _ = _make_tx(cfg)
    state = create_train_state(dict(model.named_parameters()), tx, staleness=staleness)
    step = make_train_step(make_bert_pretraining_loss(model), tx, mode=mode,
                           staleness=staleness, clip_norm=cfg.clip_norm, grad_accum=grad_accum)
    generator = torch.Generator().manual_seed(0)
    losses = []
    for batch in batches:
        state, metrics = step(state, _torch_batch(batch), generator)
        losses.append(metrics["loss"].item())
        if after_each is not None:
            after_each(state)
    return losses, bert_params_to_flax(state.params, STEP_GEOM["num_heads"])


def _recipes():
    from distributed_tensorflow_tpu.cli.train import PRESETS as JAX_PRESETS
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS

    # bert_base's recipe (AdamW, decay mask, clip 1.0, warmup_cosine) on a
    # 3-step run with a 1-step warmup, so every update is visible.
    over = dict(num_steps=3, warmup_steps=1, learning_rate=1e-3)
    return (dataclasses.replace(JAX_PRESETS["bert_base"], **over),
            dataclasses.replace(PRESETS["bert_base"], **over))


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["sync", "grad-accum-2"])
def test_bert_base_recipe_steps_match_jax(step_params, mesh1, grad_accum):
    """Three steps of the bert_base recipe: loss trajectory and params."""
    jcfg, pcfg = _recipes()
    batches = _batches(3)
    j_losses, j_params = _jax_run(step_params, mesh1, jcfg, batches, grad_accum=grad_accum)
    p_losses, p_params = _port_run(step_params, pcfg, batches, grad_accum=grad_accum)
    np.testing.assert_allclose(p_losses, j_losses, atol=1e-5)
    _assert_tree_close(p_params, j_params, atol=2e-5)


def test_stale_mode_matches_jax_and_first_updates_are_zero(step_params, mesh1):
    """mode='stale' with K=2 (constant lr, no decay): the first two applied
    gradients are the ring's zeros, so the params do not move; the third
    step applies step 1's gradient, as in the JAX step."""
    jcfg, pcfg = _recipes()
    over = dict(lr_schedule="constant", weight_decay=0.0)
    jcfg, pcfg = dataclasses.replace(jcfg, **over), dataclasses.replace(pcfg, **over)
    batches = _batches(3)
    start = bert_params_from_flax(step_params)
    moved = []
    _, p_params = _port_run(
        step_params, pcfg, batches, mode="stale", staleness=2,
        after_each=lambda s: moved.append(
            any(not torch.equal(p, start[k]) for k, p in s.params.items())))
    assert moved == [False, False, True]
    _, j_params = _jax_run(step_params, mesh1, jcfg, batches, mode="stale", staleness=2)
    _assert_tree_close(p_params, j_params, atol=2e-5)


def test_schedule_and_decay_mask_match_jax():
    """warmup_cosine/piecewise learning rates at optax's pre-increment count
    (update 0 runs at lr 0), and the decay mask leaf by leaf."""
    from distributed_tensorflow_tpu.cli.train import _decay_mask as jax_mask
    from distributed_tensorflow_tpu.cli.train import make_lr_schedule as jax_sched
    from distributed_tensorflow_tpu_torch.cli.train import _decay_mask, make_lr_schedule

    jcfg, pcfg = _recipes()
    for over in ({"num_steps": 40, "warmup_steps": 5}, {"lr_schedule": "piecewise"},
                 {"lr_schedule": "constant"}):
        js, ps = (make_lr_schedule(dataclasses.replace(pcfg, **over)),
                  jax_sched(dataclasses.replace(jcfg, **over)))
        got = [ps(c) for c in range(45)]
        # optax evaluates in f32, the port in double: rtol 1e-5.
        np.testing.assert_allclose(got, [float(js(c)) for c in range(45)], rtol=1e-5, atol=1e-12)
    assert make_lr_schedule(pcfg)(0) == 0.0
    model = BertForPreTraining(BertConfig(**GEOM), device="cpu")
    mask = _decay_mask(dict(model.named_parameters()))
    flax_tree = bert_params_to_flax(model.state_dict(), GEOM["num_heads"])
    filled = {k: torch.full_like(p, float(mask[k])) for k, p in model.named_parameters()}
    _assert_tree_close(bert_params_to_flax(filled, GEOM["num_heads"]),
                       jax.tree.map(np.float32, jax_mask(flax_tree)), atol=0)


def test_dropout_rate_scaling_and_remat():
    """Dropout keeps 1 - p of the elements, scaled by 1 / (1 - p), from the
    generator it is given; remat recomputes the same masks, so the loss and
    gradients equal the plain pass's."""
    x = torch.ones(200_000)
    y = dropout(x, 0.1, True, torch.Generator().manual_seed(1))
    assert abs((y == 0).float().mean().item() - 0.1) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, False, None), x)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        dropout(x, 0.1, True, None)

    batch = _torch_batch(_batches(1)[0])
    results = []
    for remat in (False, True):
        model = BertForPreTraining(BertConfig(**{**GEOM, "dropout_rate": 0.1}, remat=remat),
                                   device="cpu")
        params = dict(model.named_parameters())
        loss, _ = make_bert_pretraining_loss(model)(
            params, {}, batch, torch.Generator().manual_seed(5))
        results.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
