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
it, but folds ``(initial_seed, step)`` (and the micro-slice index under
``grad_accum``) into a fresh generator on the same device, as the JAX step
folds ``state.step`` into its key. A resumed run therefore draws the same
dropout masks as an uninterrupted one.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.parallel import collectives as coll
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
        with torch.enable_grad():
            if grad_accum > 1:
                rows = next(iter(batch.values())).shape[0]
                if rows % grad_accum:
                    raise ValueError(
                        f"batch rows {rows} not divisible by grad_accum {grad_accum}")
                size = rows // grad_accum
                parts = [
                    grads_of(state, {k: v[a * size:(a + 1) * size] for k, v in batch.items()},
                             _step_generator(generator, state.step, a))
                    for a in range(grad_accum)
                ]
                inv = 1.0 / grad_accum
                grads = [sum(gs) * inv for gs in zip(*(p[0] for p in parts))]
                model_state = _mean_tree([p[1] for p in parts], inv)
                metrics = _mean_tree([p[2] for p in parts], inv)
            else:
                grads, model_state, metrics = grads_of(
                    state, batch, _step_generator(generator, state.step))

        grads = coll.pmean_tree(grads)
        metrics = coll.pmean_tree(metrics)
        if model_state:
            model_state = coll.pmean_tree(model_state)

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

        grad_norm = coll.global_norm(grads)
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


def make_eval_step(metric_fn: Callable[[Any, Any, Any], dict], *, return_sums: bool = False):
    """Build ``eval_step(state, batch) -> metrics``, reduced over the
    data-parallel processes.

    ``metric_fn(params, model_state, batch) -> dict``. A ``(num, den)``
    value is reduced as a global ratio (both summed, then divided); a
    scalar is averaged. With ``return_sums=True`` every metric comes back as
    a ``(num, den)`` pair of global sums (scalars as ``(value, 1)``), for
    :func:`aggregate_metric_sums` over a whole eval pass.
    """

    def eval_step(state: TrainState, batch: dict) -> dict:
        out = {}
        for k, v in dict(metric_fn(state.params, state.model_state, batch)).items():
            if isinstance(v, tuple):
                num, den = coll.psum_tree(v)
                out[k] = (num, den) if return_sums else num / den.clamp_min(1.0)
            else:
                val = coll.pmean_tree(v)
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
