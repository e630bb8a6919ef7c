"""Collectives of the data-parallel step (port of ``parallel/collectives.py``).

The JAX package averages gradients with ``lax.pmean`` over the mesh's data
axes inside ``shard_map``. Here the data axis is the default
``torch.distributed`` process group: every leaf is all-reduced over it when
a group is initialised, and with no group (one process) or a group of one
the functions are the identity. Trees are dicts, lists or tuples of
tensors; the result has the same structure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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


def psum_tree(tree):
    """Sum every leaf across the data-parallel processes."""
    if _world_size() == 1:
        return tree

    def reduce(x):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x

    return _map(reduce, tree)


def pmean_tree(tree):
    """Average every leaf across the data-parallel processes: the whole of
    the synchronous step's gradient exchange (``SyncReplicasOptimizer``'s
    accumulate-and-average, as one all-reduce per leaf)."""
    n = _world_size()
    if n == 1:
        return tree
    return _map(lambda x: x / n, psum_tree(tree))


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of ``tree``, accumulated in f32 (for grad-norm
    logging and clipping). Local arithmetic, as in the JAX package: the
    tree it is given is already reduced."""
    norms = [torch.linalg.vector_norm(x, dtype=torch.float32) for x in _leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(norms))
