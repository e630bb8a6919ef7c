"""Mesh, runtime bootstrap and collectives across processes, the attention
of one device and across the sequence axis (ring, Ulysses), GPipe
pipelines and mixture-of-experts dispatch."""

from distributed_tensorflow_tpu_torch.parallel.collectives import (  # noqa: F401
    all_gather,
    all_gather_tree,
    all_to_all,
    axis_index,
    axis_size,
    global_norm,
    pmean_tree,
    ppermute,
    ppermute_ring,
    psum,
    psum_tree,
    reduce_scatter_mean_tree,
    replicate,
    shard_batch,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshSpec,
    active_mesh,
    axis_group,
    build_mesh,
    data_axes,
    initialize_runtime,
    layout_label,
    local_batch_size,
    shutdown_runtime,
)
from distributed_tensorflow_tpu_torch.parallel.moe import (  # noqa: F401
    expert_param_specs,
    moe_apply,
    moe_apply_a2a,
    stack_expert_params,
    switch_route,
    switch_route_topk,
)
from distributed_tensorflow_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_param_specs,
    stack_layer_params,
)
from distributed_tensorflow_tpu_torch.parallel.ring_attention import (  # noqa: F401
    dense_attention,
    ring_attention,
)
from distributed_tensorflow_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
