"""Serving: dynamic-batching inference over saved checkpoints.

- ``engine.py``  — the BERT engine over a warmed batch-tier x sequence-bucket
  grid, with a non-blocking ``dispatch``/``fetch`` split over pooled
  (pinned) staging buffers; the image classifier engine; and the causal-LM
  decode engine (slot-addressed KV cache, prefill/chunk/decode/verify
  cells; its continuous batcher comes with a later slice).
- ``batcher.py`` — dynamic micro-batcher: flush on max-batch-size or
  max-delay, bounded queue with explicit backpressure, optional
  per-bucket queues, and up to ``max_in_flight`` overlapped batches.
- ``server.py``  — in-process :class:`Client` plus a stdlib-HTTP front end.

Entry point: ``python -m distributed_tensorflow_tpu_torch.cli.serve``.
"""

from distributed_tensorflow_tpu_torch.serve.batcher import (  # noqa: F401
    Backpressure,
    BatcherConfig,
    DynamicBatcher,
    drain_retry_after_s,
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
from distributed_tensorflow_tpu_torch.serve.server import (  # noqa: F401
    Client,
    Draining,
    build_http_server,
)
