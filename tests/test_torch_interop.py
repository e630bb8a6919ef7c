"""flax <-> torch parameter conversion for BERT: exact round trip.

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
    q8 = {"bert": {"pooler": {"kernel": {"_q8": np.zeros((4, 4), np.int8),
                                         "_q8_scale": np.ones(4, np.float32)}}}}
    with pytest.raises(NotImplementedError, match="int8"):
        bert_params_from_flax(q8)
