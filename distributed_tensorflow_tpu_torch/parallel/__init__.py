"""Attention across devices; this slice ports only the single-device one."""

from distributed_tensorflow_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention,
)
