"""Collectives across the mesh's processes (port of ``parallel/collectives.py``).

The JAX package averages gradients with ``lax.pmean`` over the mesh's data
axes inside ``shard_map``, and XLA's combiner merges the per-leaf
reductions into one AllReduce. Here each mesh axis line is a
``torch.distributed`` subgroup (:func:`.mesh.axis_group`) of the active
mesh (:func:`.mesh.active_mesh`), and the merge is explicit:
:func:`psum_tree` and :func:`pmean_tree` pack every leaf of one dtype into
one flat buffer, reduce it with a single ``all_reduce`` over the axes
(default the data axes) and hand back views of it in the tree's
structure. Over axes of size 1 they are the identity. Trees are dicts,
lists or tuples of tensors; results have the same structure.

The model-parallel collectives are differentiable, with the transposes
JAX uses under ``shard_map(check_vma=False)``:

- :func:`psum` (``lax.psum``): all-reduce forward, **all-reduce backward**
  ("psum transposes to psum"). The train step's per-leaf contract
  (:mod:`..train.step`) removes the factor of the axis size this puts on
  every gradient, exactly as the JAX step does, so the final gradients
  are JAX's;
- :func:`ppermute` (``lax.ppermute`` by a shift along the axis): backward
  is the inverse shift;
- :func:`all_to_all` (``lax.all_to_all(..., tiled=True)``): backward is the
  reverse all-to-all;
- :func:`all_gather` (``lax.all_gather(..., tiled=True)``): backward sums
  the cotangent over the axis and keeps this rank's slice
  (``psum_scatter``).

Under the gloo backend a CUDA tensor that gloo cannot take is staged
through pinned host memory by the collective itself, for the ops named in
:data:`GLOO_HOST_STAGED` and for gloo only; NCCL always gets the device
tensor.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib

AxisName = str | Sequence[str]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bucketed(tree, collective):
    """Run ``collective(flat)`` (in place) once per (dtype, device) bucket
    of ``tree``'s leaves and return the tree of the results, each a view of
    its bucket."""
    leaves = list(_leaves(tree))
    buckets: dict[tuple, list[int]] = {}
    for i, x in enumerate(leaves):
        buckets.setdefault((x.dtype, x.device), []).append(i)
    out: list = [None] * len(leaves)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    it = iter(out)
    return _map(lambda _: next(it), tree)


#: Collectives whose CUDA tensors go through pinned host memory under the
#: gloo backend, by name: gloo's send/recv hand the tensor's pointer to the
#: socket as host memory (``writev ... Bad address`` on an H100), so
#: ``ppermute``. ``psum``, ``all_gather`` and ``all_to_all`` take CUDA
#: tensors in gloo itself (``chip_smoke.py`` collectives_gloo_cuda tries
#: them raw on the card).
GLOO_HOST_STAGED = frozenset({"ppermute"})


def _staged(op: str, group, x: torch.Tensor) -> bool:
    return op in GLOO_HOST_STAGED and x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


# The pipeline axis while a stage runs a tick that other stages may skip
# (:func:`..parallel.pipeline.pipeline_apply` with ``mask_bubble``): a
# collective over it there would wait for ranks that never call it.
_STAGE_LOCAL: list[str] = []


def _stage_local(axes: tuple[str, ...]) -> tuple[str, ...]:
    if any(a in _STAGE_LOCAL for a in axes):
        raise RuntimeError(
            f"a collective over {axes} inside a pipeline stage's masked tick: the "
            f"stages that skip the tick never join it; run pipeline_apply with "
            "mask_bubble=False")
    return axes


def _resolve(axis: AxisName | None):
    """``(group, size)`` of ``axis`` (None: the data axes) on the active mesh."""
    mesh = mesh_lib.active_mesh()
    axes = mesh_lib.data_axes(mesh) if axis is None else _stage_local(_axes(axis))
    return mesh_lib.axis_group(mesh, axes), math.prod(mesh.shape[a] for a in axes)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def psum_tree(tree, axis: AxisName | None = None):
    """Sum every leaf over ``axis`` (default the data axes): one all-reduce
    a dtype."""
    group, _ = _resolve(axis)
    if group is None:
        return tree
    return _bucketed(tree, lambda flat: _all_reduce(flat, group))


def pmean_tree(tree, axis: AxisName | None = None):
    """Average every leaf over ``axis`` (default the data axes): over the
    data axes, the whole of the synchronous step's gradient exchange
    (``SyncReplicasOptimizer``'s accumulate-and-average, as one all-reduce
    a dtype)."""
    group, n = _resolve(axis)
    if group is None:
        return tree
    return _bucketed(tree, lambda flat: _all_reduce(flat, group).div_(n))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.detach().clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def psum(x: torch.Tensor, axis: AxisName) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum over the axis line, differentiable;
    its backward is a psum too (JAX's transpose without replication
    tracking). The identity on an axis of size 1."""
    group, _ = _resolve(axis)
    return x if group is None else _Psum.apply(x, group)


def _shift(x: torch.Tensor, ranks: list[int], pos: int, shift: int, group) -> torch.Tensor:
    n = len(ranks)
    dst, src = ranks[(pos + shift) % n], ranks[(pos - shift) % n]
    send = x.contiguous()
    if _staged("ppermute", group, send):
        out = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        ops = [dist.P2POp(dist.isend, _host(send), dst, group),
               dist.P2POp(dist.irecv, out, src, group)]
    else:
        out = torch.empty(send.shape, dtype=send.dtype, device=send.device)
        ops = [dist.P2POp(dist.isend, send, dst, group),
               dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device, non_blocking=True)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, pos, shift, group):
        ctx.args = (ranks, pos, shift, group)
        return _shift(x, ranks, pos, shift, group)

    @staticmethod
    def backward(ctx, g):
        ranks, pos, shift, group = ctx.args
        return _shift(g, ranks, pos, -shift, group), None, None, None, None


def ppermute(x: torch.Tensor, axis: AxisName, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` along the axis line: the rank at position ``i`` receives
    position ``(i - shift) % n``'s tensor (``lax.ppermute`` with the
    permutation ``i -> i + shift``). Differentiable: the backward rotates
    the cotangent by ``-shift``. A clone on an axis of size 1."""
    mesh = mesh_lib.active_mesh()
    axes = _stage_local(_axes(axis))
    ranks = mesh_lib.axis_ranks(mesh, axes)
    if len(ranks) == 1:
        return x.clone()
    group = mesh_lib.axis_group(mesh, axes)
    return _Ppermute.apply(x, ranks, ranks.index(mesh.rank), shift, group)


def _a2a(x: torch.Tensor, group, n: int, split_axis: int, concat_axis: int) -> torch.Tensor:
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dimension {split_axis} of size {x.shape[split_axis]} "
            f"not divisible by the axis size {n}")
    send = torch.stack(x.chunk(n, split_axis)).contiguous()
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _a2a(g, group, n, concat_axis, split_axis), None, None, None, None


def all_to_all(x: torch.Tensor, axis: AxisName, split_axis: int, concat_axis: int):
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` splits into n chunks along ``split_axis``, chunk ``j`` goes to
    the axis line's position ``j``, and the chunks received are
    concatenated along ``concat_axis`` in position order. Differentiable:
    the backward is the reverse all-to-all. The identity on an axis of size 1."""
    group, n = _resolve(axis)
    if group is None:
        return x
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, pos, dim):
        ctx.args = (group, n, pos, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, pos, dim = ctx.args
        total = _all_reduce(g.clone(memory_format=torch.contiguous_format), group)
        return total.chunk(n, dim)[pos].contiguous(), None, None, None, None


def all_gather(x: torch.Tensor, axis: AxisName, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the axis line's
    tensors concatenated along ``dim`` in position order. Differentiable
    (the backward is ``psum_scatter``). The identity on an axis of size 1."""
    mesh = mesh_lib.active_mesh()
    axes = _stage_local(_axes(axis))
    ranks = mesh_lib.axis_ranks(mesh, axes)
    if len(ranks) == 1:
        return x
    group = mesh_lib.axis_group(mesh, axes)
    return _AllGather.apply(x, group, len(ranks), ranks.index(mesh.rank), dim % x.dim())


def all_gather_tree(tree, axis: int = 0, tiled: bool = True):
    """All-gather every leaf across the processes, in rank order:
    concatenated along ``axis`` (``tiled``) or stacked in a new ``axis``."""
    n = mesh_lib.process_count()

    def gather(x):
        if n == 1:
            parts = [x]
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    return _map(gather, tree)


def reduce_scatter_mean_tree(tree, axis: int = 0):
    """Reduce-scatter-mean: leaf dimension ``axis`` splits into one equal
    slice a process, and each process ends with its slice of the mean (the
    building block of a ZeRO-style sharded update)."""
    n = mesh_lib.process_count()
    rank = mesh_lib.process_index()

    def scatter(x):
        if x.shape[axis] % n:
            raise ValueError(f"dimension {axis} of size {x.shape[axis]} not divisible by {n}")
        chunks = [c.contiguous() for c in x.chunk(n, axis)]
        if n == 1:
            return chunks[0].clone()
        out = torch.empty_like(chunks[rank])
        dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM)
        return out.div_(n)

    return _map(scatter, tree)


def ppermute_ring(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the ring of the data axes: position ``i``
    receives position ``(i - shift) % n``'s tensor (:func:`ppermute` over
    the data axes)."""
    return ppermute(x, mesh_lib.data_axes(mesh_lib.active_mesh()), shift)


def _axes(axis_name: AxisName) -> tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_index(axis_name: AxisName = "data") -> int:
    """This process's coordinate along ``axis_name`` (several axes:
    flattened row-major) of the active mesh (``lax.axis_index``)."""
    return mesh_lib.coordinate(mesh_lib.active_mesh(), _axes(axis_name))


def axis_size(axis_name: AxisName = "data") -> int:
    """The number of processes along ``axis_name`` of the active mesh
    (``lax.axis_size``)."""
    shape = mesh_lib.active_mesh().shape
    return math.prod(shape[a] for a in _axes(axis_name))


def replicate(tree):
    """Every process's copy of rank 0's ``tree`` (broadcast, one call a
    dtype): the placement of variables on parameter servers, made a copy
    on every rank."""
    if mesh_lib.process_count() == 1:
        return tree
    return _bucketed(tree, lambda flat: dist.broadcast(flat, src=0))


def shard_batch(tree):
    """This process's contiguous rows (:func:`.mesh.process_rows`) of a
    global batch: every leaf sliced along its leading dimension."""
    rows = next(iter(_leaves(tree))).shape[0]
    start, stop = mesh_lib.process_rows(rows)
    return _map(lambda x: x[start:stop], tree)


def global_norm(tree, axes=None) -> torch.Tensor:
    """L2 norm over every leaf of ``tree``, accumulated in f32 (for grad-norm
    logging and clipping).

    Without ``axes`` it is local arithmetic, as in the JAX package: the
    tree it is given is already reduced and replicated. ``axes`` (a list
    beside ``tree``'s leaves, in their order: the mesh axes each leaf is
    sharded over, a tuple, a single name or None) makes it the norm of the
    global tree on every rank: a leaf's squared norm is summed over every
    axis that shards it (one all-reduce a set of axes), as the JAX step's
    spec-aware norm does (``train/step.py:361-386``)."""
    leaves = list(_leaves(tree))
    if axes is None:
        axes = [None] * len(leaves)
    keys = [() if a is None else _axes(a) for a in axes]
    if not any(keys):
        norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in leaves]
        return torch.linalg.vector_norm(torch.stack(norms))
    sums: dict = {}
    for x, key in zip(leaves, keys, strict=True):
        sq = torch.linalg.vector_norm(x, dtype=torch.float32).square()
        sums[key] = sums[key] + sq if key in sums else sq
    total = sums.pop((), torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    for key, part in sums.items():
        total = total + psum(part, key)
    return total.sqrt()
