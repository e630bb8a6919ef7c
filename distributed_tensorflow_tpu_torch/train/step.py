"""The train step: sync data parallelism, async-stale emulation, and eval.

Port of ``train/step.py``. ``mode="sync"`` averages gradients over the
data-parallel processes (:mod:`..parallel.collectives`, the identity in one
process); ``mode="stale"`` applies the gradient from K steps ago through a
deterministic K-deep ring, the reproducible image of an asynchronous
parameter server's staleness.

The JAX step is one jitted, buffer-donating function. Here it runs eagerly
and updates the state in place: the optimizer writes the parameters (the
model's own tensors) and its slots where they lie, and the stale ring is
overwritten slot by slot, so no second copy of the parameters or the
optimizer state is ever made.

Randomness: the step is given a ``torch.Generator``; it never draws from
it, but folds ``(initial_seed, step, coordinate)`` (and the micro-slice
index under ``grad_accum``) into a fresh generator on the same device, as
the JAX step folds ``state.step`` and the device's coordinate along the
axes that carry different data: the data axes, ``batch_axes`` (the expert
axis under the token-sharded MoE dispatch) and ``"seq"``
(``train/step.py:205-218``). The coordinate is this rank's, flattened
row-major over those axes of the active mesh (under ``{"data": -1}``, the
rank). So ranks with different rows or sequence slices draw their own
dropout masks, the ranks of one ``"model"``, ``"expert"`` or
``"pipeline"`` group draw the same masks on the activations they all hold,
and a resumed run draws the same masks as an uninterrupted one.

The exchange across ranks: gradients, metrics and ``model_state``
(BatchNorm statistics) go through one bucketed mean over the data axes
(:func:`..parallel.collectives.pmean_tree`, one all-reduce a dtype), the
counterpart of the JAX step's combined AllReduce. On a mesh with a live
``"model"``, ``"pipeline"``, ``"expert"`` or ``"seq"`` axis the JAX step's
grad contract comes first (``train/step.py:292-330``). Its collectives'
backward sums are psums (:func:`..parallel.collectives.psum`), so every
gradient carries one factor of each such axis's size. Axis by axis over
``"model"``, ``"pipeline"`` and ``"expert"``: a leaf sharded over the axis
(``param_specs``) keeps its slice's gradient divided by the axis size, a
replicated leaf is averaged over the axis; then every leaf is averaged
over ``"seq"`` and the data axes. The averages are linear, so the leaves
that average over the same set of axes go through one bucketed all-reduce
over their product. Metrics are averaged over the data axes and
``batch_axes``. ``grad_norm`` (and the clipping scale) is the global
tree's on every rank: a sharded leaf's squared norm is summed over the
axes that shard it.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_lib
from distributed_tensorflow_tpu_torch.train.state import TrainState, Transform

# loss_fn(params, model_state, batch, generator) -> (loss, (model_state, metrics))
LossFn = Callable[[Any, Any, Any, torch.Generator], tuple[torch.Tensor, tuple[Any, dict]]]


def fold_in(seed: int, *data: int) -> int:
    """A 63-bit seed mixed from ``seed`` and ``data`` (non-negative ints)."""
    mixed = np.random.SeedSequence([int(seed), *map(int, data)]).generate_state(1, np.uint64)
    return int(mixed[0] >> np.uint64(1))


def make_rng(seed: int, device="cuda") -> torch.Generator:
    """The run's generator on ``device`` (the card by default), seeded with
    ``seed``: what :func:`make_train_step`'s steps and ``fit`` are given."""
    return torch.Generator(resolve_device(device)).manual_seed(int(seed))


def _step_generator(generator: torch.Generator, *data: int) -> torch.Generator:
    return torch.Generator(generator.device).manual_seed(
        fold_in(generator.initial_seed(), *data))


def _mean_tree(trees: list, inv: float):
    """Leaf-wise mean of same-shaped dicts of float tensors."""
    if isinstance(trees[0], dict):
        return {k: _mean_tree([t[k] for t in trees], inv) for k in trees[0]}
    return sum(trees) * inv


def make_train_step(
    loss_fn: LossFn,
    tx: Transform,
    *,
    mode: str = "sync",
    staleness: int = 0,
    clip_norm: float = 0.0,
    grad_accum: int = 1,
    param_specs: dict | None = None,
    batch_axes: tuple[str, ...] = (),
):
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    Args:
      loss_fn: ``(params, model_state, batch, generator) -> (loss,
        (model_state, metrics))`` on this process's batch rows.
      tx: the :class:`Transform` the state was created with; its optimizer
        lives in ``state.opt_state`` and the step applies it there.
      mode: ``"sync"`` or ``"stale"`` (K-step delayed gradients).
      staleness: K for ``mode="stale"``; the state must be created with the
        same K.
      clip_norm: > 0 clips the gradient by its global norm with the JAX
        package's (and optax's) scale ``clip_norm / max(norm, clip_norm)``
        (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``
        instead).
      grad_accum: > 1 splits the batch rows into that many micro-slices and
        averages their gradients (the mean of per-slice gradients: exact for
        row-mean losses, the mean of per-slice ratios for BERT's MLM), each
        slice with its own dropout generator.
      param_specs: name -> pairs of ``(axis, dim)``, or None
        (:func:`..models.bert.bert_param_specs`): the leaves sharded over
        the model, pipeline and expert axes. None with such an axis in the
        mesh averages every gradient over it, as the JAX step does without
        specs.
      batch_axes: mesh axes besides the data axes that carry batch rows
        (``("expert",)`` under ``moe_dispatch="sharded"``, the JAX step's
        ``_extra_batch_axes``): the dropout generator folds them and the
        metrics are averaged over them.

    The state is updated in place and returned (the counterpart of the JAX
    step's buffer donation: parameters, optimizer slots and the stale ring
    are overwritten, never copied); ``metrics`` are detached 0-d tensors on
    the device (``loss``, ``grad_norm`` and the loss's own), averaged over
    the data-parallel processes.
    """
    del tx  # the optimizer it built is state.opt_state
    if mode not in ("sync", "stale"):
        raise ValueError(f"mode must be 'sync' or 'stale', got {mode!r}")
    if mode == "stale" and staleness < 1:
        raise ValueError("mode='stale' requires staleness >= 1")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(state, batch, generator):
        tensors = list(state.params.values())
        loss, (model_state, metrics) = loss_fn(
            state.params, state.model_state, batch, generator)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]
        metrics = {k: v.detach() for k, v in dict(metrics).items()}
        metrics["loss"] = loss.detach()
        return grads, model_state, metrics

    def train_step(state: TrainState, batch: dict, generator: torch.Generator):
        if mode == "stale":
            if state.grad_buffer is None:
                raise ValueError(
                    "mode='stale' needs a state built with create_train_state"
                    f"(..., staleness={staleness})")
            depth = next(iter(state.grad_buffer.values())).shape[0]
            if depth != staleness:
                raise ValueError(f"state.grad_buffer depth {depth} != staleness {staleness}")
        mesh = mesh_lib.active_mesh()
        coord = mesh_lib.coordinate(mesh, _rng_axes(mesh, batch_axes))
        with torch.enable_grad():
            if grad_accum > 1:
                rows = next(iter(batch.values())).shape[0]
                if rows % grad_accum:
                    raise ValueError(
                        f"batch rows {rows} not divisible by grad_accum {grad_accum}")
                size = rows // grad_accum
                parts = [
                    grads_of(state, {k: v[a * size:(a + 1) * size] for k, v in batch.items()},
                             _step_generator(generator, state.step, coord, a))
                    for a in range(grad_accum)
                ]
                inv = 1.0 / grad_accum
                grads = [sum(gs) * inv for gs in zip(*(p[0] for p in parts))]
                model_state = _mean_tree([p[1] for p in parts], inv)
                metrics = _mean_tree([p[2] for p in parts], inv)
            else:
                grads, model_state, metrics = grads_of(
                    state, batch, _step_generator(generator, state.step, coord))

        # THE sync point: one bucketed all-reduce for the gradients, the
        # metrics and the BatchNorm statistics together. On a mesh with a
        # model, pipeline, expert or seq axis the grad contract averages the
        # gradients over their own groups, and the metrics go alone.
        norm_axes = None
        row_axes = (*mesh_lib.data_axes(mesh), *(a for a in batch_axes if a in mesh.shape))
        if any(_live(mesh, a) for a in (*_SHARD_AXES, "seq")):
            grads, norm_axes = _grad_contract(mesh, grads, state.params, param_specs)
            metrics, model_state = coll.pmean_tree((metrics, model_state), row_axes)
        else:
            grads, metrics, model_state = coll.pmean_tree((grads, metrics, model_state))

        if mode == "stale":
            # Ring: apply the gradient stored K steps ago, keep the fresh one
            # in its slot.
            idx = state.buffer_index
            applied = []
            for buf, g in zip(state.grad_buffer.values(), grads):
                applied.append(buf[idx].clone())
                buf[idx].copy_(g)
            grads = applied
            state.buffer_index = (idx + 1) % staleness
            metrics["staleness"] = torch.tensor(float(staleness), device=grads[0].device)

        grad_norm = coll.global_norm(grads, norm_axes)
        if clip_norm > 0:
            scale = clip_norm / torch.clamp_min(grad_norm, clip_norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        tensors = list(state.params.values())
        for p, g in zip(tensors, grads):
            p.grad = g
        state.opt_state.apply()
        for p in tensors:
            p.grad = None
        metrics["grad_norm"] = grad_norm
        state.model_state = model_state
        state.step += 1
        return state, metrics

    return train_step


def _live(mesh, axis: str) -> bool:
    return mesh.shape.get(axis, 1) > 1


def _rng_axes(mesh, batch_axes=()) -> tuple[str, ...]:
    """The axes whose ranks hold different data: the data axes, the
    row-carrying ``batch_axes`` and "seq"."""
    return (*mesh_lib.data_axes(mesh), *(a for a in batch_axes if a in mesh.axis_names),
            *(("seq",) if "seq" in mesh.axis_names else ()))


# The axes parameters shard over, in the order the JAX step visits them.
_SHARD_AXES = ("model", "pipeline", "expert")


def _grad_contract(mesh, grads: list, params: dict, param_specs):
    """The JAX step's per-leaf contract over ``"model"``, ``"pipeline"`` and
    ``"expert"`` (a leaf sharded over the axis ``g / t``, a replicated one
    averaged over it), then its seq contract and the data-parallel mean:
    one bucketed all-reduce for each set of axes a leaf is averaged over.
    Returns the gradients and each leaf's sharding axes (for the global
    norm)."""
    from distributed_tensorflow_tpu_torch.models.bert import spec_axes

    live = [a for a in _SHARD_AXES if _live(mesh, a)]
    rows = (*(("seq",) if "seq" in mesh.axis_names else ()), *mesh_lib.data_axes(mesh))
    shard_of, groups = [], {}
    for i, (name, g) in enumerate(zip(params, grads)):
        axes = spec_axes(None if param_specs is None else param_specs.get(name))
        sharded = tuple(a for a in live if a in axes)
        t = 1
        for a in sharded:
            t *= mesh.shape[a]
        if t > 1:
            g.div_(t)
        shard_of.append(sharded)
        groups.setdefault((*(a for a in live if a not in sharded), *rows), []).append(i)
    out = list(grads)
    for axes, idx in groups.items():
        for i, g in zip(idx, coll.pmean_tree([grads[i] for i in idx], axes)):
            out[i] = g
    return out, shard_of


def make_eval_step(metric_fn: Callable[[Any, Any, Any], dict], *, return_sums: bool = False,
                   batch_axes: tuple[str, ...] = ()):
    """Build ``eval_step(state, batch) -> metrics``, reduced over the
    data-parallel processes (and ``batch_axes``, as in
    :func:`make_train_step`).

    ``metric_fn(params, model_state, batch) -> dict``. A ``(num, den)``
    value is reduced as a global ratio (both summed, then divided); a
    scalar is averaged. With ``return_sums=True`` every metric comes back as
    a ``(num, den)`` pair of global sums (scalars as ``(value, 1)``), for
    :func:`aggregate_metric_sums` over a whole eval pass.
    """

    def eval_step(state: TrainState, batch: dict) -> dict:
        mesh = mesh_lib.active_mesh()
        rows = (*mesh_lib.data_axes(mesh), *(a for a in batch_axes if a in mesh.shape))
        out = {}
        for k, v in dict(metric_fn(state.params, state.model_state, batch)).items():
            if isinstance(v, tuple):
                num, den = coll.psum_tree(v, rows)
                out[k] = (num, den) if return_sums else num / den.clamp_min(1.0)
            else:
                val = coll.pmean_tree(v, rows)
                out[k] = (val, torch.ones_like(val)) if return_sums else val
        return out

    return eval_step


def aggregate_metric_sums(batch_metrics) -> dict:
    """Reduce an iterable of ``{k: (num, den)}`` dicts to global ratios:
    numerators and denominators add up over the whole pass and divide once,
    so batches with more masked tokens weigh more."""
    nums: dict[str, float] = {}
    dens: dict[str, float] = {}
    for metrics in batch_metrics:
        for k, (num, den) in metrics.items():
            nums[k] = nums.get(k, 0.0) + float(num)
            dens[k] = dens.get(k, 0.0) + float(den)
    return {k: nums[k] / max(dens[k], 1e-12) for k in nums}
