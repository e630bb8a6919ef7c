"""Mesh, runtime bootstrap and collectives across processes, and the
single-device attention."""

from distributed_tensorflow_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather_tree,
    axis_index,
    axis_size,
    global_norm,
    pmean_tree,
    ppermute_ring,
    psum_tree,
    reduce_scatter_mean_tree,
    replicate,
    shard_batch,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshSpec,
    build_mesh,
    data_axes,
    initialize_runtime,
    layout_label,
    local_batch_size,
    shutdown_runtime,
)
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention,
)
