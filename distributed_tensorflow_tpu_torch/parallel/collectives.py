"""Collectives of the data-parallel step (port of ``parallel/collectives.py``).

The JAX package averages gradients with ``lax.pmean`` over the mesh's data
axes inside ``shard_map``, and XLA's combiner merges the per-leaf
reductions into one AllReduce. Here the data axis is the default
``torch.distributed`` process group (:mod:`.mesh`), and the merge is
explicit: :func:`psum_tree` and :func:`pmean_tree` pack every leaf of one
dtype into one flat buffer, reduce it with a single ``all_reduce`` and
hand back views of it in the tree's structure. With no group (one
process) or a group of one they are the identity. Trees are dicts, lists
or tuples of tensors; results have the same structure.
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


def psum_tree(tree):
    """Sum every leaf across the data-parallel processes: one all-reduce a
    dtype."""
    if mesh_lib.process_count() == 1:
        return tree
    return _bucketed(tree, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM))


def pmean_tree(tree):
    """Average every leaf across the data-parallel processes: the whole of
    the synchronous step's gradient exchange (``SyncReplicasOptimizer``'s
    accumulate-and-average, as one all-reduce a dtype)."""
    n = mesh_lib.process_count()
    if n == 1:
        return tree

    def mean(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(n)

    return _bucketed(tree, mean)


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
    """Rotate ``x`` around the ring of processes: process ``i`` receives
    process ``(i - shift) % n``'s tensor (the primitive under ring
    attention and ring pipelining)."""
    n = mesh_lib.process_count()
    if n == 1:
        return x.clone()
    rank = mesh_lib.process_index()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), (rank + shift) % n),
           dist.P2POp(dist.irecv, out, (rank - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _axes(axis_name: AxisName) -> tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_index(axis_name: AxisName = "data") -> int:
    """This process's coordinate along ``axis_name`` (several axes:
    flattened row-major) of the data-parallel mesh."""
    return mesh_lib.coordinate(mesh_lib.build_mesh(), _axes(axis_name))


def axis_size(axis_name: AxisName = "data") -> int:
    """The number of processes along ``axis_name`` of the data-parallel mesh."""
    shape = mesh_lib.build_mesh().shape
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


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of ``tree``, accumulated in f32 (for grad-norm
    logging and clipping). Local arithmetic, as in the JAX package: the
    tree it is given is already reduced."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in _leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))
