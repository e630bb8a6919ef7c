"""flax <-> torch parameter conversion for BERT: exact round trip, float
and int8-packed.

The tree has the flax model's own structure and shapes (``jax.eval_shape``
of its init) with values drawn from a numpy seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_tensorflow_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForPreTraining as JaxBert,
)
from distributed_tensorflow_tpu.models.quant import quantize_params
from distributed_tensorflow_tpu_torch.interop import (
    bert_params_from_flax,
    bert_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining

GEOM = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)


@pytest.fixture(scope="module")
def flax_tree():
    shapes = jax.eval_shape(
        JaxBert(JaxBertConfig(**GEOM)).init,
        jax.random.key(0),
        jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool),
        jnp.zeros((1, 8), jnp.int32),
    )["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_round_trip_is_exact(flax_tree):
    sd = bert_params_from_flax(flax_tree)
    back = bert_params_to_flax(sd, num_heads=GEOM["num_heads"])
    assert jax.tree.structure(back) == jax.tree.structure(flax_tree)
    for (path, a), (_, b) in zip(_leaves(flax_tree), _leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_state_dict_loads_strictly_with_torch_layouts(flax_tree):
    sd = bert_params_from_flax(flax_tree)
    model = BertForPreTraining(BertConfig(**GEOM), device="cpu")
    model.load_state_dict(sd, strict=True)
    att = flax_tree["bert"]["layer_1"]["attention"]
    q = sd["bert.layers.1.attention.query.weight"].numpy()
    # DenseGeneral [H, heads, d] -> Linear [heads*d, H]: row h*d+j is head h, lane j.
    np.testing.assert_array_equal(q[2 * 16 + 5], att["query"]["kernel"][:, 2, 5])
    out = sd["bert.layers.1.attention.out.weight"].numpy()
    np.testing.assert_array_equal(out[:, 3 * 16 + 7], att["out"]["kernel"][3, 7])
    np.testing.assert_array_equal(
        sd["nsp_head.weight"].numpy(), flax_tree["nsp_head"]["kernel"].T
    )


def test_bf16_leaves_and_quantized_leaves(flax_tree):
    import ml_dtypes
    import torch

    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), flax_tree)
    sd = bert_params_from_flax(tree)
    assert sd["mlm_bias"].dtype == torch.bfloat16
    back = bert_params_to_flax(sd, num_heads=GEOM["num_heads"])
    for (path, a), (_, b) in zip(_leaves(tree), _leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b, err_msg=str(path))
    # A tree the JAX package packed to int8 carries over exactly, both ways:
    # _q8 moves like the kernel it replaced, the scale keeps its flax shape.
    packed = quantize_params(flax_tree)
    sd = bert_params_from_flax(jax.tree.map(np.asarray, packed))
    q = sd["bert.layers.0.attention.query.weight"]
    assert q["_q8"].dtype == torch.int8 and q["_q8"].shape == (64, 64)
    assert q["_q8_scale"].shape == (16,)  # [d], shared across the 4 heads
    assert sd["bert.embeddings.word.weight"].dtype == torch.float32  # never packed
    back = bert_params_to_flax(sd, num_heads=GEOM["num_heads"])
    for (path, a), (_, b) in zip(_leaves(packed), _leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_causal_lm_tree_round_trips_float_and_packed():
    """The decoder's tree (BERT's leaf names plus ``embed_ln``/``lm_ln``/
    ``lm_bias``) loads strictly into the port's ``CausalLM`` and comes back
    exactly, as floats and packed by the JAX package's int8 quantizer."""
    from distributed_tensorflow_tpu.models.causal_lm import CausalLM as JaxLM
    from distributed_tensorflow_tpu.models.causal_lm import CausalLMConfig as JaxLMConfig
    from distributed_tensorflow_tpu_torch.interop import (
        causal_lm_params_from_flax,
        causal_lm_params_to_flax,
    )
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig

    geom = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position=16)
    shapes = jax.eval_shape(JaxLM(JaxLMConfig(**geom)).init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool))["params"]
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = causal_lm_params_from_flax(tree)
    CausalLM(CausalLMConfig(**geom), device="cpu").load_state_dict(sd, strict=True)
    for src in (tree, jax.tree.map(np.asarray, quantize_params(tree))):
        back = causal_lm_params_to_flax(causal_lm_params_from_flax(src), geom["num_heads"])
        assert jax.tree.structure(back) == jax.tree.structure(src)
        for (path, a), (_, b) in zip(_leaves(src), _leaves(back)):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))
