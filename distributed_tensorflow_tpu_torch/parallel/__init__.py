"""Attention and collectives across devices; this slice ports the
single-device attention and the data-parallel collectives."""

from distributed_tensorflow_tpu_torch.parallel.collectives import (  # noqa: F401
    global_norm,
    pmean_tree,
    psum_tree,
)
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention,
)
