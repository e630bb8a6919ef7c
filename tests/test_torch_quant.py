"""int8 weights and KV of the port (``models/quant.py``) against the JAX
package's, bit for bit, plus the restore-time packing.

The packed kernels come from the same parameters: the JAX side packs the
flax tree, the port packs its state dict, and ``interop`` carries one to
the other's layout for an exact comparison (``_q8`` as the kernel it
replaced, ``_q8_scale`` unchanged: one scale per flax last-axis channel,
``[d]`` shared across heads for the q/k/v kernels). The KV packing is
compared on the same f32 and bf16 activations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu.models import quant as JQ
from distributed_tensorflow_tpu_torch import ckpt
from distributed_tensorflow_tpu_torch.interop import (
    bert_params_to_flax,
    causal_lm_params_from_flax,
)
from distributed_tensorflow_tpu_torch.models import quant as Q
from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
from distributed_tensorflow_tpu_torch.obs.memory import MemoryRegistry

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=48)


@pytest.fixture(scope="module")
def flax_params():
    model = J.CausalLM(J.CausalLMConfig(**GEOM))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool))["params"]
    rng = np.random.default_rng(0)
    # A spread of magnitudes per channel, and one all-zero kernel column
    # (the _EPS floor).
    tree = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * rng.uniform(0.01, 0.2, s.shape[-1:]))
        .astype(np.float32), shapes)
    tree["lm_transform"]["kernel"][:, 3] = 0.0
    return tree


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and not JQ.is_quantized_leaf(v):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_weight_packing_is_the_jax_packing_bit_for_bit(flax_params):
    jq = JQ.quantize_params(flax_params)
    sd = causal_lm_params_from_flax(flax_params)
    pq = Q.quantize_params(sd, num_heads=GEOM["num_heads"])
    # The port's packed tree in the flax layout, against the JAX packing.
    mapped = dict(_flat(bert_params_to_flax(pq, GEOM["num_heads"])))
    packed = 0
    for path, ref in _flat(jax.tree.map(np.asarray, jq)):
        got = mapped[path]
        if JQ.is_quantized_leaf(ref):
            packed += 1
            assert Q.is_quantized_leaf(got), path
            np.testing.assert_array_equal(got["_q8"], np.asarray(ref["_q8"]), err_msg=str(path))
            np.testing.assert_array_equal(got["_q8_scale"], np.asarray(ref["_q8_scale"]),
                                          err_msg=str(path))
        else:
            np.testing.assert_array_equal(got, np.asarray(ref), err_msg=str(path))
    # 4 kernels of attention + 2 of FFN a layer, and lm_transform.
    assert packed == 6 * GEOM["num_layers"] + 1
    q = pq["layers.0.attention.query.weight"]
    assert q["_q8"].shape == (32, 32) and q["_q8_scale"].shape == (16,)
    assert pq["lm_transform.weight"]["_q8_scale"][3].item() == pytest.approx(1e-8)
    # Dequantization is JAX's, bit for bit (f32 q * scale).
    jd = JQ.dequantize_params(jq)
    pd = bert_params_to_flax(Q.dequantize_params(pq), GEOM["num_heads"])
    for (path, ref), (_, got) in zip(_flat(jax.tree.map(np.asarray, jd)), _flat(pd)):
        np.testing.assert_array_equal(got, ref, err_msg=str(path))


def test_eligibility_identity_and_idempotence(flax_params):
    sd = causal_lm_params_from_flax(flax_params)
    pq = Q.quantize_params(sd, num_heads=2)
    assert Q.is_quantized_tree(pq) and not Q.is_quantized_tree(sd)
    for name in ("word.weight", "position.weight", "lm_bias", "embed_ln.weight",
                 "layers.0.attention.query.bias", "layers.1.output_bias"):
        assert pq[name] is sd[name], name  # shared, not copied
    again = Q.quantize_params(pq)  # no num_heads needed: nothing left to pack
    assert all(again[k] is v for k, v in pq.items())
    with pytest.raises(ValueError, match="num_heads"):
        Q.quantize_params(sd)
    cast = Q.cast_params(pq, "bfloat16")
    assert cast["word.weight"].dtype == torch.bfloat16
    assert cast["lm_transform.weight"] is pq["lm_transform.weight"]
    assert Q.fp32_equiv_nbytes(pq) == Q.fp32_equiv_nbytes(sd)
    assert sum(t.numel() * 4 for t in sd.values()) == Q.fp32_equiv_nbytes(sd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_packing_is_the_jax_packing_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero position: epsilon-floored scale, q == 0
    jx = jnp.asarray(x, dtype)
    jqv, jsv = JQ.quantize_kv(jx)
    px = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    pqv, psv = Q.quantize_kv(px)
    np.testing.assert_array_equal(pqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(psv.numpy(), np.asarray(jsv))
    assert pqv.dtype == torch.int8 and psv.shape == (3, 5) and float(psv[1, 2]) > 0
    np.testing.assert_array_equal(Q.dequantize_kv(pqv, psv).numpy(),
                                  np.asarray(JQ.dequantize_kv(jqv, jsv)))


def test_normalize_quant_dtype_contract():
    assert Q.normalize_quant_dtype(None) is None
    assert Q.normalize_quant_dtype("bf16") == "bfloat16"
    assert Q.normalize_quant_dtype("fp32") == "float32"
    assert Q.normalize_quant_dtype("int8") == "int8"
    assert Q.normalize_quant_dtype(torch.bfloat16) == "bfloat16"
    assert Q.normalize_quant_dtype(np.dtype("float32")) == "float32"
    with pytest.raises(ValueError, match="fp8"):
        Q.normalize_quant_dtype("fp8", "weight_dtype")


def test_restore_quantizes_and_releases(tmp_path):
    """restore_serving_state(weight_dtype="int8"): the file keeps f32, the
    restored dict comes back packed, the replaced f32 kernels are freed into
    the released ledger, and an engine built on it detects the packing and
    serves."""
    from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

    model = CausalLM(CausalLMConfig(**GEOM), device="cpu")
    ckpt.save(tmp_path / "ck", 1, model.state_dict())
    registry = MemoryRegistry()
    params, state, step = ckpt.restore_serving_state(
        tmp_path / "ck", weight_dtype="int8", num_heads=2, memory=registry)
    assert step == 1 and state == {} and Q.is_quantized_tree(params)
    released = registry.snapshot()["released"]
    kernels = sum(t.numel() * 4 for k, t in model.state_dict().items()
                  if Q._kernel_kind(k, t) is not None)
    assert released["weight_quantization"] == kernels
    on_disk = torch.load(tmp_path / "ck" / "step_00000001.pt", weights_only=True)
    assert on_disk["params"]["lm_transform.weight"].dtype == torch.float32
    engine = CausalLMEngine(CausalLM(CausalLMConfig(**GEOM), device="cpu"), params, "cpu",
                            buckets=(8,), slots=2, max_batch=1, max_new_tokens=4,
                            memory=registry)
    assert engine.weight_dtype == "int8"  # detected from the dict
    tok = engine.fetch_step(engine.prefill([{"slot": 0, "input_ids": np.arange(4, 9)}]))
    assert 0 <= int(tok[0]) < GEOM["vocab_size"]
    comp = registry.snapshot()
    assert "lm_params" in str(comp)


def test_bert_engine_int8_matches_the_jax_engine():
    """``BertInferenceEngine(weight_dtype="int8")`` against the JAX engine's
    on the same f32 params: the same packing, so the same pred_ids, and the
    MLM score within 1e-4 (f32 compute)."""
    from distributed_tensorflow_tpu.models.bert import BertConfig as JaxBertConfig
    from distributed_tensorflow_tpu.models.bert import BertForPreTraining as JaxBert
    from distributed_tensorflow_tpu.parallel.mesh import build_mesh
    from distributed_tensorflow_tpu.serve import BertInferenceEngine as JaxBertEngine
    from distributed_tensorflow_tpu_torch.interop import bert_params_from_flax
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    geom = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
                intermediate_size=64, max_position=16, dropout_rate=0.0)
    jm = JaxBert(JaxBertConfig(**geom))
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                            jnp.ones((1, 8), bool), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32),
                        shapes)
    kw = dict(buckets=(16,), max_batch=1, batch_tiers=(1,), weight_dtype="int8")
    jeng = JaxBertEngine(jm, tree, build_mesh({"data": 1}, devices=jax.devices()[:1]), **kw)
    peng = BertInferenceEngine(BertForPreTraining(BertConfig(**geom), device="cpu"),
                               bert_params_from_flax(tree), "cpu", **kw)
    assert peng.weight_dtype == "int8"
    assert peng.model.bert.layers[0].attention.query.weight is None  # packed, not dense
    ids = rng.integers(4, 64, 12)
    payload = {"input_ids": ids, "mlm_targets": ids}
    ref, got = jeng.run_batch([payload])[0], peng.run_batch([payload])[0]
    np.testing.assert_array_equal(got["pred_ids"], np.asarray(ref["pred_ids"]))
    np.testing.assert_allclose(got["score"], ref["score"], atol=1e-4)
    np.testing.assert_allclose(got["embedding"], np.asarray(ref["embedding"]), atol=1e-4)
