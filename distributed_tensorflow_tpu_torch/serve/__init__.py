"""Serving: dynamic-batching and continuous-batching inference over saved
checkpoints.

- ``engine.py``  — the BERT engine over a warmed batch-tier x sequence-bucket
  grid, with a non-blocking ``dispatch``/``fetch`` split over pooled
  (pinned) staging buffers; the image classifier engine; and the causal-LM
  decode engine (slot-addressed KV cache, prefill/chunk/decode/verify
  cells, the prefix-cache page pool).
- ``batcher.py`` — dynamic micro-batcher (flush on max-batch-size or
  max-delay, bounded queue with explicit backpressure, optional per-bucket
  queues, up to ``max_in_flight`` overlapped batches) and the continuous
  batcher of the decode engines (slot table, prefix-cache admission,
  chunked prefill, speculation, EDF admission and slot preemption).
- ``kvpool.py``  — prefix-cache bookkeeping for the decode path: a radix
  trie over prompt-token blocks mapping shared heads to refcounted,
  LRU-evicted chains of device KV pages (the engine owns the pages, this
  owns what they mean).
- ``spec.py``    — speculative decoding for the decode path: host-side
  n-gram drafting over each slot's own history, exact-match acceptance
  against one batched verify forward, and per-slot adaptive backoff
  (output stays bit-identical to plain decode).
- ``disagg.py``  — fleet serving: disaggregated prefill/decode roles
  (KV-page chain transfer in process or over ``POST /v1/kv_transfer``, the
  transfer budget) and live stream migration (``/v1/stream_migrate``,
  ``/v1/stream_wait``, ``/migratez``), over the JAX package's wire format
  v1-v4 byte for byte.
- ``server.py``  — in-process :class:`Client` plus a stdlib-HTTP front end.
- ``router.py``  — the fleet front door over N ``cli.serve`` replicas:
  health-polled supervision with restart and quarantine, prefix-affinity
  and power-of-two routing, failover, the collection of migrated streams,
  and the rolling hot swap whose drain deadline migrates live streams
  (``python -m distributed_tensorflow_tpu_torch.cli.router``).

Entry point: ``python -m distributed_tensorflow_tpu_torch.cli.serve``.
"""

from distributed_tensorflow_tpu_torch.serve.batcher import (  # noqa: F401
    Backpressure,
    BatcherConfig,
    ContinuousBatcher,
    DynamicBatcher,
    drain_retry_after_s,
)
from distributed_tensorflow_tpu_torch.serve.disagg import (  # noqa: F401
    DisaggServingPair,
    TransferBudget,
    WireError,
    deserialize_chain,
    make_kv_receiver,
    post_kv_transfer,
    serialize_chain,
)
from distributed_tensorflow_tpu_torch.serve.engine import (  # noqa: F401
    BertInferenceEngine,
    CausalLMEngine,
    CompileRecord,
    ImageClassifierEngine,
    InFlightBatch,
    RequestError,
    plan_serve_mesh,
)
from distributed_tensorflow_tpu_torch.serve.kvpool import (  # noqa: F401
    KVBlockPool,
    PrefixMatch,
)
from distributed_tensorflow_tpu_torch.serve.router import (  # noqa: F401
    Replica,
    Router,
    RouterConfig,
    build_router_server,
    pick_power_of_two,
    prefix_affinity_key,
    rendezvous_pick,
    replica_load,
    replica_specs,
)
from distributed_tensorflow_tpu_torch.serve.server import (  # noqa: F401
    Client,
    Draining,
    build_http_server,
)
from distributed_tensorflow_tpu_torch.serve.spec import (  # noqa: F401
    Drafter,
    NGramDrafter,
    SlotSpec,
    SpecConfig,
)
