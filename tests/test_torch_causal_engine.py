"""The port's ``CausalLMEngine`` against the JAX package's, cell by cell.

Both engines get the same parameters (numpy, mapped by ``interop``) and the
same admissions at the JAX tests' tiny size (vocab 64, H 32, 1 layer, 2
heads, 48 positions, 3 slots, bucket 16); the JAX engine runs on a
one-device mesh. Every comparison is of sampled token ids and must be
exact: both engines compute the same f32 logits up to the order of f32
sums (test_torch_causal_lm.py holds them within 2e-5), and the sampling is
bitwise (the seeds, steps and logits here put no draw within that of a
tie). The int8 engines pack the same kernels bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu.serve import CausalLMEngine as JaxEngine
from distributed_tensorflow_tpu_torch.interop import causal_lm_params_from_flax
from distributed_tensorflow_tpu_torch.models import causal_lm as P
from distributed_tensorflow_tpu_torch.serve import CausalLMEngine, RequestError

# One layer: the engines' cells, not depth (test_torch_causal_lm.py runs 2).
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=48)
# One prefill tier and bucket (every admission here is 1-2 rows of <= 16
# tokens): the JAX engine compiles each cell of its grid at startup.
KW = dict(buckets=(16,), slots=3, max_batch=2, batch_tiers=(2,), max_new_tokens=8)
CHUNKED = dict(prefix_cache_mb=0.05, block_tokens=4, prefill_chunk=8)
TRANSFER = dict(CHUNKED, kv_transfer=True, stream_migrate=True)


def _flax_params(seed: int = 0) -> dict:
    model = J.CausalLM(J.CausalLMConfig(**GEOM))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.3 * rng.standard_normal(s.shape) if len(s.shape) < 2
                else 0.15 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


PARAMS = _flax_params()
MESH = build_mesh({"data": 1}, devices=jax.devices()[:1])


def _port(**kw):
    return CausalLMEngine(P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu"),
                          causal_lm_params_from_flax(PARAMS), "cpu", **{**KW, **kw})


def _pair(**kw):
    return JaxEngine(J.CausalLM(J.CausalLMConfig(**GEOM)), PARAMS, MESH, **KW, **kw), _port(**kw)


@pytest.fixture(scope="module")
def plain():
    return _pair(spec_tokens=2)


@pytest.fixture(scope="module")
def int8():
    return _pair(weight_dtype="int8", kv_dtype="int8")


@pytest.fixture(scope="module")
def chunked():
    return _pair(**CHUNKED)


PROMPTS = [np.array([5, 9, 2, 44, 17]), np.array([7, 3, 61, 12, 30, 8, 41, 22, 19, 4, 33])]
SAMPLING = [(0.0, 0), (0.8, 7)]  # (temperature, seed): one greedy, one sampled row


def _decode_loop(engine, slots, lengths, temps, seeds, n_steps):
    S = engine.slots
    ln = np.zeros(S, np.int32)
    act = np.zeros(S, bool)
    tt = np.zeros(S, np.float32)
    ss = np.zeros(S, np.int32)
    for s, n, t, sd in zip(slots, lengths, temps, seeds):
        ln[s], act[s], tt[s], ss[s] = n, True, t, sd
    out = []
    for _ in range(n_steps):
        tok = engine.fetch_step(engine.decode(ln, act, tt, ss))
        out.append(tok[act].tolist())
        ln[act] += 1
    return out, ln, act, tt, ss


def _monolithic(engine, slots=(0, 2)):
    adm = [{"slot": s, "input_ids": p, "temperature": t, "seed": sd}
           for s, p, (t, sd) in zip(slots, PROMPTS, SAMPLING)]
    first = engine.fetch_step(engine.prefill(adm))[:2].tolist()
    steps, ln, act, tt, ss = _decode_loop(engine, slots, [len(p) for p in PROMPTS],
                                          *zip(*SAMPLING), n_steps=4)
    return [first, *steps], (ln, act, tt, ss)


@pytest.mark.parametrize("mode", ["plain", "int8"])
def test_prefill_and_decode_tokens_match_jax(mode, request):
    jeng, peng = request.getfixturevalue(mode)
    if mode == "int8":
        assert peng.weight_dtype == jeng.weight_dtype == "int8"
        assert peng.kv_dtype == jeng.kv_dtype == "int8"
        assert peng.kv_bytes_per_token() == jeng.kv_bytes_per_token()
    ref, _ = _monolithic(jeng)
    got, _ = _monolithic(peng)
    assert got == ref


def test_verify_matches_jax_and_decode(plain):
    """Verify columns and the on-device accept: the token matrix equals the
    JAX engine's, and the greedy column 0 is the token decode gives."""
    mats = []
    for eng in plain:
        _, (ln, act, tt, ss) = _monolithic(eng)
        drafts = np.array([[3, 9], [0, 0], [11, 40]], np.int32)
        n_input = np.where(act, 3, 0).astype(np.int32)
        mats.append(eng.fetch_step(eng.verify(drafts, ln, n_input, tt, ss)))
        nxt = eng.fetch_step(eng.decode(ln, act, tt, ss))
        mats.append(nxt)
    np.testing.assert_array_equal(mats[2], mats[0])
    np.testing.assert_array_equal(mats[3], mats[1])


def _chunked_run(engine, chain_blocks):
    """Request A cold into slot 0 in two chunks, its 8-token head published
    to the pool, then request B (A's head + its own tail) into slot 1 with
    the head gathered from the pool and only the tail prefilled; decode."""
    a = np.concatenate([PROMPTS[1], [6, 6]])  # 13 tokens
    b = np.concatenate([a[:8], [50, 51, 52]])
    first_a = []
    for s0, n in ((0, 8), (8, 5)):
        first_a = engine.fetch_step(engine.prefill_chunks([
            {"slot": 0, "input_ids": a, "start": s0, "n_tokens": n, "length": len(a),
             "temperature": 0.0, "seed": 0}]))[:1].tolist()
    engine.insert_prefix(0, [(blk, i) for i, blk in enumerate(chain_blocks)])
    first_b = engine.fetch_step(engine.prefill_chunks([
        {"slot": 1, "input_ids": b, "start": 8, "n_tokens": 3, "length": len(b),
         "chain": list(chain_blocks), "temperature": 0.8, "seed": 3}]))[:1].tolist()
    steps, *_ = _decode_loop(engine, (0, 1), (len(a), len(b)), (0.0, 0.8), (0, 3), 3)
    return [first_a, first_b, *steps]


def test_chunked_prefill_with_a_handed_in_prefix_matches_jax(chunked):
    jeng, peng = chunked
    ref = _chunked_run(jeng, [2, 5])
    got = _chunked_run(peng, [2, 5])
    assert got == ref
    # The chunked stream of B equals B admitted cold through one chunk.
    peng2 = _port(prefill_chunk=16)
    b = np.concatenate([PROMPTS[1], [6, 6]])[:8]
    b = np.concatenate([b, [50, 51, 52]])
    cold = peng2.fetch_step(peng2.prefill_chunks([
        {"slot": 1, "input_ids": b, "start": 0, "n_tokens": len(b), "length": len(b),
         "temperature": 0.8, "seed": 3}]))[:1].tolist()
    assert cold == got[1]


def test_page_and_slot_export_import_round_trip():
    peng = _port(**TRANSFER)
    _chunked_run(peng, [2, 5])
    k, v = peng.export_prefix_pages([2, 5])
    peng.import_prefix_pages([(7, 0), (8, 1)], k, v)
    k2, v2 = peng.export_prefix_pages([7, 8])
    assert torch.equal(k2, k) and torch.equal(v2, v)
    meta = peng.page_meta()
    assert meta == {"num_layers": 1, "block_tokens": 4, "heads": 2, "head_dim": 16,
                    "dtype": "float32", "max_chain": 4}
    sk, sv = peng.export_slot_pages(0)
    assert sk.shape == (1, peng.cache_len, 2, 16)
    peng.import_slot_pages(2, sk, sv, last_token=9)
    sk2, sv2 = peng.export_slot_pages(2)
    assert torch.equal(sk2, sk) and torch.equal(sv2, sv)
    assert int(peng._last_token[2]) == 9
    assert peng.stream_page_meta()["cache_len"] == peng.cache_len


def test_int8_pages_round_trip_with_their_scales():
    peng = _port(kv_dtype="int8", **TRANSFER)
    _chunked_run(peng, [1, 3])
    k, v = peng.export_prefix_pages([1, 3])
    assert set(k) == {"q", "s"} and k["q"].dtype == torch.int8
    peng.import_prefix_pages([(4, 0), (6, 1)], k, v)
    k2, _ = peng.export_prefix_pages([4, 6])
    assert all(torch.equal(k2[x], k[x]) for x in ("q", "s"))
    assert peng.page_meta()["dtype"] == "int8"


def test_validate_grid_and_device_contract(plain):
    _, peng = plain
    with pytest.raises(RequestError, match="exceeds the largest bucket"):
        peng.validate({"input_ids": np.arange(17)})
    with pytest.raises(RequestError, match="cache pages"):
        peng.validate({"input_ids": np.arange(16), "max_new_tokens": 20})
    with pytest.raises(RequestError, match="non-empty"):
        peng.validate({"input_ids": []})
    peng.validate({"input_ids": np.arange(10), "temperature": 0.5})
    assert peng.request_bucket({"input_ids": np.arange(10)}) == 16
    grid = peng.grid_status()
    # prefill 1 tier x 1 bucket + decode + verify, all warm.
    assert grid["cells_total"] == 3 and grid["warm_fraction"] == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CausalLMEngine(P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu"),
                           causal_lm_params_from_flax(PARAMS), **KW)
