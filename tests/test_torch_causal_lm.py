"""The port's causal LM against the JAX package's on the CPU.

Same inputs (seeded numpy) through ``distributed_tensorflow_tpu.models.
causal_lm`` and ``distributed_tensorflow_tpu_torch.models.causal_lm`` at the
JAX tests' tiny size (vocab 64, H 32, 2 layers, 2 heads, 48 positions),
parameters drawn with numpy and mapped by ``interop``. The port's caches
carry one spare position past ``Lc``; the JAX caches' ``Lc`` positions are
compared with the port's first ``Lc``.

Tolerances: fp32 forwards within 2e-5 (f32 sums in another order); bf16
within 2e-2 on logits and K/V (one bf16 rounding step of values of order 1,
taken at other points of the two graphs); int8 KV pages bitwise in fp32,
and within two quantization steps in bf16 (a K/V value one bf16 rounding
step off moves ``q`` by up to 127 x 2^-8, and its row's absmax scale with
it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu_torch.interop import (
    causal_lm_params_from_flax,
    causal_lm_params_to_flax,
)
from distributed_tensorflow_tpu_torch.models import causal_lm as P

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=48)
NL, H, D = GEOM["num_layers"], GEOM["num_heads"], GEOM["hidden_size"] // GEOM["num_heads"]


def _flax_params(seed: int = 0) -> dict:
    """A CausalLM param tree from numpy: normal(0.02) kernels/embeddings,
    biases and LayerNorm affine terms nonzero so every leaf matters."""
    model = J.CausalLM(J.CausalLMConfig(**GEOM))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), bool))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "bias" in name:
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


PARAMS = _flax_params()


def _models(dtype: str):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = J.CausalLM(J.CausalLMConfig(**GEOM, dtype=jdt))
    pm = P.CausalLM(P.CausalLMConfig(**GEOM, dtype=tdt), device="cpu")
    pm.load_state_dict(causal_lm_params_from_flax(PARAMS))
    return jm, pm.eval()


def _jit(fn):
    """``jax.jit(fn)``, compiled at XLA's lowest backend optimisation level
    (each reference runs once; that cuts its compile time on the CPU)."""

    def run(*args):
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0})(*args)

    return run


def _apply(jm, method):
    return _jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _tol(dtype):
    return {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}[dtype]


def _prompt(b=3, l=12, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, GEOM["vocab_size"], (b, l)).astype(np.int32)
    lengths = np.array([l, l - 3, 5][:b])
    mask = np.arange(l)[None, :] < lengths[:, None]
    return ids, mask


def test_param_tree_round_trips_and_keeps_bert_names():
    sd = causal_lm_params_from_flax(PARAMS)
    model = P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu")
    assert set(sd) == set(model.state_dict())
    back = causal_lm_params_to_flax(sd, num_heads=H)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(PARAMS),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_and_prefill_match_jax(dtype):
    jm, pm = _models(dtype)
    ids, mask = _prompt()
    jl, (jp, jk, jv) = _jit(lambda p, i, m: (jm.apply({"params": p}, i, m),
                                             jm.apply({"params": p}, i, m, method="prefill"))
                            )(PARAMS, ids, mask)
    with torch.no_grad():
        pl = pm(torch.from_numpy(ids), torch.from_numpy(mask))
        pp, pk, pv = pm.prefill(torch.from_numpy(ids), torch.from_numpy(mask))
    assert pl.dtype == pm.cfg.dtype and pk.shape == (NL, 3, 12, H, D)
    for got, ref in ((pl, jl), (pp, jp), (pk, jk), (pv, jv)):
        np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))
    torch.testing.assert_close(pl, pp, rtol=0, atol=0)


def _caches(s, lc, kv: str, seed=2, dtype=np.float32):
    """Random caches in the JAX layout and the port's (one spare position)."""
    rng = np.random.default_rng(seed)
    if kv == "int8":
        q = rng.integers(-127, 128, (2, NL, s, lc, H, D)).astype(np.int8)
        sc = (0.01 + 0.02 * rng.random((2, NL, s, lc))).astype(np.float32)
        jc = [{"q": jnp.asarray(q[i]), "s": jnp.asarray(sc[i])} for i in range(2)]
        pc = [{"q": torch.from_numpy(np.pad(q[i], [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])),
               "s": torch.from_numpy(np.pad(sc[i], [(0, 0), (0, 0), (0, 1)]))}
              for i in range(2)]
        return jc, pc
    a = rng.standard_normal((2, NL, s, lc, H, D)).astype(np.float32)
    jc = [jnp.asarray(a[i], dtype) for i in range(2)]
    pc = [torch.from_numpy(np.pad(np.asarray(jc[i], np.float32),
                                  [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)]))
          .to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32) for i in range(2)]
    return jc, pc


def _strip(c, lc):
    if isinstance(c, dict):
        return {"q": c["q"][:, :, :lc], "s": c["s"][:, :, :lc]}
    return c[:, :, :lc]


def _assert_cache(got, ref, lc, dtype):
    got = _strip(got, lc)
    if isinstance(ref, dict):
        dq = np.abs(got["q"].numpy().astype(np.int32) - np.asarray(ref["q"], np.int32))
        assert dq.max() <= (0 if dtype == "fp32" else 2)
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(ref["s"]), **_tol(dtype))
    else:
        np.testing.assert_allclose(_np(got), _np(ref), **_tol(dtype))


CASES = [("fp32", "plain"), ("bf16", "plain"), ("fp32", "int8"), ("bf16", "int8")]


@pytest.mark.parametrize("dtype,kv", CASES, ids=["-".join(c) for c in CASES])
def test_decode_step_matches_jax(dtype, kv):
    jm, pm = _models(dtype)
    s, lc = 4, 20
    jc, pc = _caches(s, lc, kv, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    token = np.array([5, 9, 33, 60], np.int32)
    position = np.array([0, 7, lc - 1, lc], np.int32)  # last lane idle: its write drops
    jl, jk, jv = _apply(jm, "decode_step")(PARAMS, token, position, jc[0], jc[1])
    with torch.no_grad():
        pl, pk, pv = pm.decode_step(torch.from_numpy(token), torch.from_numpy(position),
                                    pc[0], pc[1])
    assert pk is pc[0] and pv is pc[1]  # written in place
    np.testing.assert_allclose(_np(pl[:3]), _np(jl[:3]), **_tol(dtype))
    _assert_cache(pk, jk, lc, dtype)
    _assert_cache(pv, jv, lc, dtype)


@pytest.mark.parametrize("dtype,kv", CASES, ids=["-".join(c) for c in CASES])
def test_prefill_chunk_and_verify_match_jax(dtype, kv):
    jm, pm = _models(dtype)
    b, c, lc = 3, 5, 24
    jc, pc = _caches(b, lc, kv, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 64, (b, c)).astype(np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [9, 10, 11, lc, lc], [lc - 2, lc - 1, lc, lc, lc]],
                   np.int32)
    # The JAX verify_step is its prefill_chunk (it delegates): both of the
    # port's forwards are held to that one reference.
    jl, jk, jv = _apply(jm, "prefill_chunk")(PARAMS, ids, pos, jc[0], jc[1])
    for method in ("prefill_chunk", "verify_step"):
        pcc = [{k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()
               for x in pc]
        with torch.no_grad():
            pl, pk, pv = getattr(pm, method)(torch.from_numpy(ids), torch.from_numpy(pos),
                                             pcc[0], pcc[1])
        live = pos < lc
        np.testing.assert_allclose(_np(pl)[live], _np(jl)[live], **_tol(dtype))
        _assert_cache(pk, jk, lc, dtype)
        _assert_cache(pv, jv, lc, dtype)


@pytest.mark.parametrize("kv", ["plain", "int8"])
def test_sentinel_lanes_never_touch_a_real_write_at_the_last_position(kv):
    """One row: a real write at ``Lc - 1`` beside three sentinel lanes
    (``Lc``). The caches' ``Lc`` positions come out as from the real lane
    alone (so the real K/V stands: a sentinel lane's would be other values
    altogether), every earlier position keeps its old value bit for bit,
    and the sentinel writes reach the spare position only."""
    _, pm = _models("fp32")
    lc = 10
    _, pc = _caches(1, lc, kv)
    alone = [{k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()
             for x in pc]
    before = [{k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone()
              for x in pc]
    with torch.no_grad():
        pl, pk, pv = pm.prefill_chunk(torch.tensor([[7, 8, 9, 10]]),
                                      torch.tensor([[lc - 1, lc, lc, lc]]), pc[0], pc[1])
        ref, rk, rv = pm.prefill_chunk(torch.tensor([[7]]), torch.tensor([[lc - 1]]),
                                       alone[0], alone[1])
    for got, want, old in ((pk, rk, before[0]), (pv, rv, before[1])):
        got, want, old = (x["q"] if kv == "int8" else x for x in (got, want, old))
        # Layer 1's K/V ride on layer 0's output for a 4-lane vs a 1-lane
        # product: f32 sums in another order (int8: one step at most).
        torch.testing.assert_close(got[:, :, :lc].float(), want[:, :, :lc].float(),
                                   rtol=0, atol=1 if kv == "int8" else 1e-5)
        assert torch.equal(got[:, :, : lc - 1], old[:, :, : lc - 1])
        assert not torch.equal(got[:, :, lc - 1], old[:, :, lc - 1])
        assert not torch.equal(got[:, :, lc], old[:, :, lc])  # the spare took them
    torch.testing.assert_close(pl[0, 0], ref[0, 0], rtol=1e-5, atol=1e-5)


def _jax_loss_and_grads(batch):
    jm = J.CausalLM(J.CausalLMConfig(**GEOM))
    loss_fn = J.make_causal_lm_loss(jm)
    metric_fn = J.make_causal_lm_eval_metrics(jm)

    def f(p):
        loss, (_, m) = loss_fn(p, {}, batch, None)
        return loss, m

    def both(p):
        (loss, m), g = jax.value_and_grad(f, has_aux=True)(p)
        return loss, m, g, metric_fn(p, {}, batch)

    return _jit(both)(PARAMS)


def test_loss_metrics_and_gradients_match_jax():
    from distributed_tensorflow_tpu_torch.data.text import SyntheticLM, SyntheticMLMConfig

    batch = SyntheticLM(SyntheticMLMConfig(vocab_size=64, seq_len=16, seed=0)).batch(4, seed=1)
    jloss, jm_, jgrads, jmetrics = _jax_loss_and_grads(batch)
    pm = P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu")
    pm.load_state_dict(causal_lm_params_from_flax(PARAMS))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, (_, metrics) = P.make_causal_lm_loss(pm)(None, {}, tb, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(metrics["lm_accuracy"].item(), float(jm_["lm_accuracy"]), atol=0)
    grads = causal_lm_params_to_flax({k: p.grad for k, p in pm.named_parameters()}, H)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                 jax.tree_util.tree_leaves_with_path(grads)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=1e-4, err_msg=str(path))
    got = P.make_causal_lm_eval_metrics(pm)(None, {}, tb)
    for k, (num, den) in got.items():
        np.testing.assert_allclose([num.item(), den.item()],
                                   [float(jmetrics[k][0]), float(jmetrics[k][1])], rtol=1e-5)


# -------------------------------------------------------------- sampling

SEEDS = np.array([0, 1, 7, 123, 2**31 - 1, -1, -5, 99991], np.int32)
STEPS = np.array([0, 1, 5, 31, 48, 1000, 2**20 + 3, 2**31 - 1], np.int32)


@pytest.mark.parametrize("vocab", [64, 30522])
def test_random_bits_and_uniforms_are_jax_bit_for_bit(vocab):
    def ref(seed, step):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        bits = jax.random.bits(key, (vocab,), jnp.uint32)
        u = jax.random.uniform(key, (vocab,), jnp.float32,
                               minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
        return bits, u

    jbits, ju = _jit(jax.vmap(ref))(SEEDS, STEPS)
    bits = P.random_bits(torch.from_numpy(SEEDS), torch.from_numpy(STEPS), vocab)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), np.asarray(jbits))
    u = P.uniform_tiny(bits)
    np.testing.assert_array_equal(u.numpy().view(np.uint32), np.asarray(ju).view(np.uint32))


@pytest.mark.parametrize("vocab", [64, 30522])
def test_sample_tokens_match_jax(vocab):
    """A seeded grid: the 8 x 8 (seed, step) pairs, temperatures cycling
    through {0, 0.3, 0.8, 1.5}, over logits of spread 3 (no rows built
    around ties), in f32 and bf16. Greedy rows agree exactly; sampled rows
    on all but at most one draw of the 64 (the port's log may differ from
    XLA's by one ulp, which can flip a near-tie). Measured: 64 of 64."""
    rng = np.random.default_rng(4)
    seeds = np.repeat(SEEDS, 8)
    steps = np.tile(STEPS, 8)
    temps = np.tile(np.array([0.0, 0.3, 0.8, 1.5], np.float32), 16)
    logits = (3.0 * rng.standard_normal((64, vocab))).astype(np.float32)
    sample = _jit(J.sample_tokens)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(sample(jnp.asarray(logits, jdt), temps, seeds, steps))
        got = P.sample_tokens(torch.from_numpy(logits).to(tdt), torch.from_numpy(temps),
                              torch.from_numpy(seeds), torch.from_numpy(steps)).numpy()
        greedy = temps == 0
        np.testing.assert_array_equal(got[greedy], ref[greedy])
        agree = int((got == ref).sum())
        assert agree >= 63, f"{agree}/64 draws agree ({jdt.__name__})"


# ----------------------------------------------- the port's own greedy parity


@pytest.mark.parametrize("kv", ["plain", "int8"])
def test_greedy_decode_equals_the_full_forward(kv):
    """Prefill a prompt into slot 1 of a 3-slot cache, decode 10 tokens
    greedily, and hold every token to the full forward's argmax over the
    prompt plus the tokens before it (fp32: exactly; int8 KV: the decode
    path against itself, chunked prefill of the same prompt)."""
    _, pm = _models("fp32")
    cfg = pm.cfg
    lc = 32
    prompt = np.array([5, 9, 2, 44, 17, 30, 8], np.int64)

    def run(chunk):
        shape = (NL, 3, lc + 1, H, D)
        if kv == "int8":
            ck = {"q": torch.zeros(shape, dtype=torch.int8), "s": torch.zeros(shape[:3])}
            cv = {"q": torch.zeros(shape, dtype=torch.int8), "s": torch.zeros(shape[:3])}
        else:
            ck, cv = torch.zeros(shape), torch.zeros(shape)
        toks = []
        with torch.no_grad():
            n = len(prompt)
            rows = torch.tensor([1])
            logits = None
            for s0 in range(0, n, chunk):
                ids = torch.from_numpy(prompt[s0:s0 + chunk])[None]
                pos = torch.arange(s0, s0 + ids.shape[1])[None]
                logits, _, _ = pm.prefill_chunk(ids, pos, ck, cv, rows=rows)
            tok = int(logits[0, -1].argmax())
            toks.append(tok)
            for t in range(9):
                token = torch.tensor([0, tok, 0])
                position = torch.tensor([lc, n + t, lc])
                logits, _, _ = pm.decode_step(token, position, ck, cv)
                tok = int(logits[1].argmax())
                toks.append(tok)
        return toks

    streams = [run(c) for c in (7, 3)]
    assert streams[0] == streams[1]
    if kv == "plain":
        seq = np.concatenate([prompt, streams[0]])
        with torch.no_grad():
            full = pm(torch.from_numpy(seq)[None], torch.ones((1, len(seq)), dtype=torch.bool))
        ref = full[0, len(prompt) - 1:-1].argmax(-1).tolist()
        assert streams[0] == ref
    assert cfg.vocab_size == 64
