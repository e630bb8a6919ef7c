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


# ----------------------------------------------------- wire format v3/v4


def _int8_side(rng, shape, scale_shape):
    return {"q": rng.integers(-127, 128, shape, dtype=np.int8),
            "s": rng.random(scale_shape, dtype=np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def test_wire_int8_chain_roundtrip_and_version_tamper():
    """The int8 chain (v3) round trip, byte for byte the JAX package's
    buffer, and its refusals: a bare int8 array at serialize, an int8
    buffer re-tagged v1 and an fp32 one re-tagged v3 (fail closed both
    ways, with JAX's messages), a flipped scale byte (the CRC covers the
    scales)."""
    from distributed_tensorflow_tpu.serve import disagg as JD
    from distributed_tensorflow_tpu_torch.serve.disagg import (
        _PREFIX,
        WIRE_VERSION,
        WIRE_VERSION_QUANT,
        WireError,
        deserialize_chain,
        serialize_chain,
    )

    meta = {"num_layers": 2, "block_tokens": 4, "heads": 2, "head_dim": 3, "dtype": "int8"}
    rng = np.random.default_rng(5)
    shape = (2, 3, 4, 2, 3)  # 3 blocks
    pk, pv = _int8_side(rng, shape, shape[:3]), _int8_side(rng, shape, shape[:3])
    ids = [int(x) for x in rng.integers(5, 64, size=12)]
    buf = serialize_chain(ids, _torch_tree(pk), _torch_tree(pv), meta)
    assert buf == JD.serialize_chain(ids, pk, pv, meta)
    assert _PREFIX.unpack_from(buf)[1] == WIRE_VERSION_QUANT
    tids, k2, v2, header = deserialize_chain(buf)
    assert tids == ids and header["page_meta"]["dtype"] == "int8"
    for got, sent in ((k2, pk), (v2, pv)):
        assert got["q"].numpy().tobytes() == sent["q"].tobytes()
        assert got["s"].numpy().tobytes() == sent["s"].tobytes()
    with pytest.raises(ValueError, match="scale tree"):
        serialize_chain(ids, torch.from_numpy(pk["q"]), torch.from_numpy(pv["q"]), meta)
    magic, _, hlen = _PREFIX.unpack_from(buf)
    fbuf = serialize_chain(ids, torch.rand(shape), torch.rand(shape),
                           {**meta, "dtype": "float32"})
    magic, fver, fhlen = _PREFIX.unpack_from(fbuf)
    assert fver == WIRE_VERSION
    corrupt = bytearray(buf)
    corrupt[-3] ^= 0xFF
    for bad, match in ((_PREFIX.pack(magic, WIRE_VERSION, hlen) + buf[_PREFIX.size:],
                        "inconsistent"),
                       (_PREFIX.pack(magic, WIRE_VERSION_QUANT, fhlen) + fbuf[_PREFIX.size:],
                        "inconsistent"),
                       (bytes(corrupt), "CRC")):
        with pytest.raises(WireError, match=match) as pe:
            deserialize_chain(bad)
        with pytest.raises(JD.WireError) as je:
            JD.deserialize_chain(bad)
        assert str(pe.value) == str(je.value)


def test_wire_int8_stream_roundtrip():
    """The int8 stream (v4): exactly the settled positions, q and s
    together, byte for byte the JAX package's buffer; page-less streams are
    always v2, and a v4 tag with no pages refuses."""
    from distributed_tensorflow_tpu.serve import batcher as JB
    from distributed_tensorflow_tpu.serve import disagg as JD
    from distributed_tensorflow_tpu_torch.serve.batcher import StreamState
    from distributed_tensorflow_tpu_torch.serve.disagg import (
        _PREFIX,
        WIRE_VERSION_STREAM,
        WIRE_VERSION_STREAM_QUANT,
        WireError,
        deserialize_stream,
        serialize_stream,
    )

    meta = {"num_layers": 2, "cache_len": 24, "heads": 2, "head_dim": 3, "dtype": "int8"}
    rng = np.random.default_rng(9)
    fields = dict(request_id="q-mig-1",
                  input_ids=[int(t) for t in rng.integers(5, 60, size=8)],
                  tokens=[int(t) for t in rng.integers(5, 60, size=4)],
                  max_new_tokens=8, length=11)
    st = StreamState(**fields)
    shape = (2, 24, 2, 3)
    pk, pv = _int8_side(rng, shape, shape[:2]), _int8_side(rng, shape, shape[:2])
    buf = serialize_stream(st, _torch_tree(pk), _torch_tree(pv), meta)
    assert buf == JD.serialize_stream(JB.StreamState(**fields), pk, pv, meta)
    assert _PREFIX.unpack_from(buf)[1] == WIRE_VERSION_STREAM_QUANT
    sd, k2, v2, header = deserialize_stream(buf)
    assert sd == st.to_dict() and header["n_tokens"] == 11
    for got, sent in ((k2, pk), (v2, pv)):
        assert got["q"].numpy().tobytes() == np.ascontiguousarray(sent["q"][:, :11]).tobytes()
        assert got["s"].numpy().tobytes() == np.ascontiguousarray(sent["s"][:, :11]).tobytes()
    pl = serialize_stream(st)
    magic, ver, hlen = _PREFIX.unpack_from(pl)
    assert ver == WIRE_VERSION_STREAM
    with pytest.raises(WireError, match="carry pages"):
        deserialize_stream(_PREFIX.pack(magic, WIRE_VERSION_STREAM_QUANT, hlen)
                           + pl[_PREFIX.size:])


def _chain_buf(engine, seed):
    """A 1-block chain serialized against ``engine``'s page geometry."""
    from distributed_tensorflow_tpu_torch.serve.disagg import serialize_chain

    meta = engine.page_meta()
    rng = np.random.default_rng(seed)
    bt = meta["block_tokens"]
    shape = (meta["num_layers"], 1, bt, meta["heads"], meta["head_dim"])

    def side():
        if meta["dtype"] == "int8":
            return _torch_tree(_int8_side(rng, shape, shape[:3]))
        return torch.from_numpy(rng.random(shape, dtype=np.float32))

    ids = [int(x) for x in rng.integers(5, 64, size=bt)]
    return serialize_chain(ids, side(), side(),
                           {k: v for k, v in meta.items() if k != "max_chain"})


def test_wire_cross_dtype_refusal_both_directions():
    """A real receiver (batcher + engine, the /v1/kv_transfer handler)
    refuses a chain of the other arm's dtype in both directions and still
    adopts its own: cross-dtype KV adoption fails closed, never
    reinterprets bytes."""
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        CausalLMEngine,
        ContinuousBatcher,
    )
    from distributed_tensorflow_tpu_torch.serve.disagg import WireError, make_kv_receiver

    engines = {
        name: CausalLMEngine(CausalLM(CausalLMConfig(**GEOM), device="cpu"),
                             CausalLM(CausalLMConfig(**GEOM), device="cpu").state_dict(),
                             "cpu", buckets=(8,), slots=2, max_batch=1, max_new_tokens=4,
                             prefix_cache_mb=0.05, block_tokens=4, prefill_chunk=8,
                             kv_transfer=True, **kw)
        for name, kw in (("int8", dict(weight_dtype="int8", kv_dtype="int8")),
                         ("fp32", {}))
    }
    batchers = {n: ContinuousBatcher(e, BatcherConfig(max_batch=1)) for n, e in engines.items()}
    try:
        receivers = {n: make_kv_receiver(batchers[n], engines[n], timeout_s=5.0)
                     for n in engines}
        for src, dst in (("int8", "fp32"), ("fp32", "int8")):
            with pytest.raises(WireError, match="dtype"):
                receivers[dst](_chain_buf(engines[src], seed=5))
        for name in engines:
            assert receivers[name](_chain_buf(engines[name], seed=6))["adopted_blocks"] >= 1
    finally:
        for b in batchers.values():
            b.close()
