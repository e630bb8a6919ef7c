"""Shared pieces of the decode-serving parity tests
(``tests/test_torch_serve_{decode,spec}.py``, ``tests/test_torch_sched.py``):
the tiny causal LM of ``tests/test_torch_causal_engine.py`` (vocab 64, H 32,
1 layer, 2 heads, 48 positions, 3 slots, bucket 16), one seeded parameter
tree for both packages, the engine builders (the JAX engine on a one-device
mesh) and the port's full-forward greedy reference."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu.serve import CausalLMEngine as JaxEngine
from distributed_tensorflow_tpu_torch.interop import causal_lm_params_from_flax
from distributed_tensorflow_tpu_torch.models import causal_lm as P
from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, max_position=48)
# One prefill tier and bucket: the JAX engine compiles every cell of its
# grid at startup. 16 + 8 new tokens = 24-position slot pages.
KW = dict(buckets=(16,), slots=3, max_batch=2, batch_tiers=(2,), max_new_tokens=8)
CHUNKED = dict(prefix_cache_mb=0.05, block_tokens=4, prefill_chunk=8)


def _flax_params(seed: int = 0, geom: dict = GEOM) -> dict:
    model = J.CausalLM(J.CausalLMConfig(**geom))
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


def jax_engine(**kw):
    return JaxEngine(J.CausalLM(J.CausalLMConfig(**GEOM)), PARAMS, MESH, **{**KW, **kw})


def port_engine(**kw):
    return CausalLMEngine(P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu"),
                          causal_lm_params_from_flax(PARAMS), "cpu", **{**KW, **kw})


_REF_MODEL = None


def ref_greedy(prompt, n: int) -> list[int]:
    """n greedy tokens by re-running the port's FULL causal forward after
    each appended token: no cache, no batchmates, no speculation."""
    global _REF_MODEL
    if _REF_MODEL is None:
        _REF_MODEL = port_engine().model
    toks = [int(t) for t in prompt]
    out = []
    with torch.inference_mode():
        for _ in range(n):
            ids = torch.tensor([toks])
            logits = _REF_MODEL(ids, torch.ones_like(ids, dtype=torch.bool))
            nxt = int(logits[0, -1].argmax())
            out.append(nxt)
            toks.append(nxt)
    return out


def predictive_prompt(seed: int, n_new: int = 6):
    """A prompt the n-gram drafter can predict (the JAX
    ``tests/test_serve_spec.py`` construction): the model's own greedy
    continuation embedded after a marker token ``t``, the prompt ending in
    ``t`` again, iterated to a fixed point. Returns ``(prompt, continuation)``."""
    rng = np.random.default_rng(seed)
    t = int(rng.integers(5, 64))
    c = ref_greedy(rng.integers(5, 64, size=12), n_new)
    for _ in range(6):
        p = [int(rng.integers(5, 64)), t] + c + [
            int(x) for x in rng.integers(5, 64, size=12 - 3 - len(c))] + [t]
        c2 = ref_greedy(p, n_new)
        if c2 == c:
            break
        c = c2
    return np.array(p, np.int32), c


def run_batcher(batcher_cls, engine, config, requests, timeout: float = 120.0, **kw):
    """Submit ``requests`` in order to a fresh batcher over ``engine``;
    returns the token streams and the batcher's final status."""
    with batcher_cls(engine, config, **kw) as b:
        futs = [b.submit(dict(r)) for r in requests]
        streams = [f.result(timeout=timeout)["tokens"] for f in futs]
        status = b.status()
    return streams, status
