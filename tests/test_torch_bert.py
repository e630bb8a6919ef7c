"""Port parity: tiny BERT ``serve_outputs`` in PyTorch against the JAX model.

Params come from one flax init and are converted by ``interop``; inputs are
numpy arrays from a seed. fp32: logits, NSP logits and the pooled output
within atol 1e-4 (same math, different summation orders). The dense branch
runs at L=32 and the flash branch (plain path on CPU, Pallas interpret mode
on the JAX side) at L=64.
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
)
from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax
from distributed_tensorflow_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
)

GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)


@pytest.fixture(scope="module")
def flax_params():
    model = JaxBert(JaxBertConfig(**GEOM))
    variables = jax.jit(model.init)(
        jax.random.key(0),
        jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool),
        jnp.zeros((1, 8), jnp.int32),
    )
    return jax.tree.map(np.asarray, variables["params"])


def _inputs(seed: int, b: int, l: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GEOM["vocab_size"], size=(b, l)).astype(np.int32)
    types = rng.integers(0, 2, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), bool)
    mask[0, l // 2:] = False  # padded tail
    return ids, mask, types


def _run_both(flax_params, attn_impl, l, jax_dtype, torch_dtype):
    ids, mask, types = _inputs(l, 2, l)
    jm = JaxBert(JaxBertConfig(**GEOM, attn_impl=attn_impl, dtype=jax_dtype))
    serve = jax.jit(
        lambda p, a, m, t: jm.apply({"params": p}, a, m, t, method="serve_outputs")
    )
    j_logits, j_nsp, j_pooled = serve(
        flax_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types)
    )
    tm = BertForPreTraining(
        BertConfig(**GEOM, attn_impl=attn_impl, dtype=torch_dtype), device="cpu"
    )
    tm.load_state_dict(bert_params_from_flax(flax_params))
    with torch.inference_mode():
        t_logits, t_nsp, t_pooled = tm.serve_outputs(
            torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types)
        )
    as_np = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return (
        (t_logits, as_np(j_logits)),
        (t_nsp, as_np(j_nsp)),
        (t_pooled, as_np(j_pooled)),
    )


@pytest.mark.parametrize("attn_impl,l", [("dense", 32), ("flash", 64)])
def test_serve_outputs_match_jax_fp32(flax_params, attn_impl, l):
    pairs = _run_both(flax_params, attn_impl, l, jnp.float32, torch.float32)
    (t_logits, _), (t_nsp, _), (t_pooled, _) = pairs
    assert t_logits.dtype == torch.float32 and t_logits.shape == (2, l, 128)
    assert t_nsp.dtype == torch.float32 and t_pooled.shape == (2, 64)
    for (t, j), name in zip(pairs, ("mlm_logits", "nsp_logits", "pooled")):
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4, err_msg=name)


def test_serve_outputs_match_jax_bf16(flax_params):
    """bf16 compute: the two frameworks round at different places (fused vs
    separate bias adds, per-op GELU), so hold logits to 0.1 — about six bf16
    ulps at |logit| ~ 2 — and the f32 NSP head and the pooled output to 0.05."""
    pairs = _run_both(flax_params, "flash", 64, jnp.bfloat16, torch.bfloat16)
    (t_logits, _), (t_nsp, _), (t_pooled, _) = pairs
    assert t_logits.dtype == torch.bfloat16 and t_nsp.dtype == torch.float32
    for (t, j), name, tol in zip(pairs, ("mlm_logits", "nsp_logits", "pooled"),
                                 (0.1, 0.05, 0.05)):
        np.testing.assert_allclose(t.float().numpy(), j, atol=tol, err_msg=name)


def test_layernorm_matches_flax_in_bf16():
    """flax LayerNorm(dtype=bf16) normalises in f32 with the fast variance;
    the port's LayerNorm gives the same bf16 output on inputs with a large
    mean, where bf16 statistics would lose the variance."""
    from flax import linen as fnn

    from distributed_tensorflow_tpu_torch.models.bert import LayerNorm

    rng = np.random.default_rng(3)
    x = (200.0 + rng.standard_normal((4, 64))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = fnn.LayerNorm(epsilon=1e-12, dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, xb
    )
    ln = LayerNorm(64, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        out = ln(torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref, np.float32), atol=1e-2
    )


def test_unported_parallel_fields_raise():
    # The mixture-of-experts and pipeline fields are ported: they are
    # accepted, and the combinations the JAX package refuses raise.
    assert BertConfig(moe_experts=4, moe_topk=2).moe_topk == 2
    assert BertConfig(moe_experts=4, expert_axis="expert", expert_parallel=2,
                      moe_dispatch="sharded").expert_parallel == 2
    assert BertConfig(pipeline_parallel=2).stacked
    for fields, message in ((dict(moe_dispatch="bogus"), "unknown moe_dispatch"),
                            (dict(moe_experts=4, moe_dispatch="sharded"),
                             "requires expert_parallel > 1"),
                            (dict(num_layers=3, pipeline_parallel=2),
                             "not divisible by pipeline_parallel 2")):
        with pytest.raises(ValueError, match=message):
            BertConfig(**fields)
    # Tensor and sequence parallelism are ported: their fields are accepted.
    assert BertConfig(model_axis="model", model_parallel=2).model_parallel == 2
    assert BertConfig(seq_axis="seq", sp_impl="ulysses").sp_impl == "ulysses"
    assert dataclasses.replace(BertConfig(), remat=True).remat
