"""Shared pieces of the fleet-serving parity tests
(``tests/test_torch_{disagg,migrate}.py``): the tiny causal LM of the JAX
package's ``tests/test_disagg.py`` (vocab 64, H 32, 2 layers, 2 heads, 48
positions), one seeded parameter tree for both packages, the engine
builders (the JAX engines on a one-device mesh with one prefill tier and
bucket, built once a process) and the port's full-forward greedy
reference; the decode pacer that holds a stream mid-generation for an
export comes from ``tests/_torch_mp_worker.py`` (its ``migrate_tp`` job
uses it too).
"""

from __future__ import annotations

import functools

import jax
import torch
from _torch_mp_worker import Pacer, export_live, wait_active  # noqa: F401
from _torch_serve_common import _flax_params

from distributed_tensorflow_tpu.models import causal_lm as J
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu.serve import BatcherConfig as JaxBatcherConfig
from distributed_tensorflow_tpu.serve import CausalLMEngine as JaxEngine
from distributed_tensorflow_tpu.serve import Client as JaxClient
from distributed_tensorflow_tpu_torch.interop import causal_lm_params_from_flax
from distributed_tensorflow_tpu_torch.models import causal_lm as P
from distributed_tensorflow_tpu_torch.serve import BatcherConfig, CausalLMEngine, Client

GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=48)
MAX_NEW = 12
# One prefill tier and bucket: the JAX engine warms every cell of its grid
# at startup. 16 + 12 new tokens = 28-position slot pages.
KW = dict(buckets=(16,), slots=3, max_batch=2, batch_tiers=(2,), max_new_tokens=MAX_NEW,
          prefix_cache_mb=0.25, block_tokens=4, prefill_chunk=8)
FLEET = dict(kv_transfer=True, stream_migrate=True)
BATCH = dict(max_batch=2, max_queue=32, max_in_flight=2)

PARAMS = _flax_params(geom=GEOM)
PORT_PARAMS = causal_lm_params_from_flax(PARAMS)
MESH = build_mesh({"data": 1}, devices=jax.devices()[:1])


def port_engine(**kw):
    return CausalLMEngine(P.CausalLM(P.CausalLMConfig(**GEOM), device="cpu"), PORT_PARAMS,
                          "cpu", **{**KW, **kw})


def port_client(recorder=None, **kw):
    return Client(port_engine(**kw), BatcherConfig(**BATCH), recorder=recorder)


@functools.cache
def jax_client(role: str):
    """A JAX engine with the fleet cells behind a client, one per ``role``
    a process (each role's pool is its own)."""
    engine = JaxEngine(J.CausalLM(J.CausalLMConfig(**GEOM)), PARAMS, MESH, **KW, **FLEET)
    return JaxClient(engine, JaxBatcherConfig(**BATCH))


_REF_MODEL = None


def ref_greedy(prompt, n: int) -> list[int]:
    """n greedy tokens by re-running the port's FULL causal forward after
    each appended token: no cache, no batchmates, no transfer."""
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
