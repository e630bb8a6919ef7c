"""GPipe pipeline parallelism over a ``"pipeline"`` mesh axis (port of
``parallel/pipeline.py``).

The layer stack's params carry a leading ``[n_layers]`` dim sharded over
the pipeline axis: stage ``s`` holds layers ``[s*L/S, (s+1)*L/S)``. The
microbatch schedule is written out tick by tick, ``T = M + S - 1`` ticks:
stage 0 ingests microbatch ``t``, every stage runs its layers on what it
holds, and on every tick a :func:`..collectives.ppermute` hands each
stage's output to the next. The last stage's outputs are summed over the
axis (:func:`..collectives.psum`), so every stage returns the same ``[B,
...]``. Autograd differentiates straight through: the backward of the
hand-offs is the backward pipeline.

Every rank builds an autograd graph of one shape, as JAX's one SPMD
program does: stage 0 takes its input through ``torch.where(stage == 0,
inject, buf)``, never by a Python branch, so the buffer it receives stays
in its graph and every hand-off's backward runs on every rank, in one
order (each hand-off's backward needs the next one's); the last tick's
hand-off, which feeds nothing on any rank, is not made. Under
``torch.distributed`` a rank that dropped a hand-off from its graph would
leave its neighbour waiting in that hand-off's backward.

``mask_bubble`` skips the layer math on fill and drain ticks (the stage
holds no real microbatch): the tick passes its input through. The port's
rule for ``"auto"`` (the JAX package reads the layer's jaxpr for
collectives, which has no counterpart here): a skipped tick is safe when
every collective inside the layer runs over a process group whose ranks
all share one pipeline stage, because every rank of such a group skips the
same ticks. :func:`..mesh.build_mesh` makes one group per line of an axis
set, so the ``"model"``, ``"seq"``, ``"expert"`` and data groups qualify
and ``"auto"`` masks; a collective over the pipeline axis inside a masked
tick raises (``collectives._stage_local``) rather than wait for stages
that skipped it. ``mask_bubble=False`` runs every tick and never raises.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable

import torch

from distributed_tensorflow_tpu_torch.parallel import collectives as coll

# layer_fn(layer_params, h) -> h, or with with_context=True
# layer_fn(layer_params, h, ctx) with ctx = {"layer": global layer index,
# "microbatch": microbatch index} (ints); with with_aux=True it returns
# (h, aux scalar).
LayerFn = Callable[..., torch.Tensor]


@contextlib.contextmanager
def _masked_tick(axis_name: str):
    coll._STAGE_LOCAL.append(axis_name)
    try:
        yield
    finally:
        coll._STAGE_LOCAL.pop()


def pipeline_apply(layer_fn: LayerFn, stacked_params: dict, x: torch.Tensor, *,
                   axis_name: str = "pipeline", n_microbatches: int,
                   with_context: bool = False, with_aux: bool = False,
                   mask_bubble: bool | str = "auto"):
    """Run a stage-sharded layer stack over ``x`` with GPipe microbatching.

    ``stacked_params``: this stage's slice of the stacked params (every
    leaf with leading dim ``local_layers``); ``x``: the full local batch
    ``[B, ...]``, the same on every stage, ``B`` divisible by
    ``n_microbatches``. ``with_aux``: ``layer_fn`` also returns a scalar
    auxiliary loss a (layer, microbatch) call; fill and drain ticks'
    values are left out, the real calls' summed over ticks and stages,
    and their mean over the ``n_layers * M`` calls returned.

    Returns ``[B, ...]`` (with ``with_aux``, ``(y, aux_mean)``), the same
    on every stage. Raises when the schedule cannot run: a batch the
    microbatches do not divide, a bad ``mask_bubble``."""
    if mask_bubble not in (True, False, "auto"):
        raise ValueError(f"mask_bubble must be True, False, or 'auto'; got {mask_bubble!r}")
    mask_bubble = bool(mask_bubble)  # "auto": see the module docstring
    S = coll.axis_size(axis_name)
    stage = coll.axis_index(axis_name)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    trained = [p for p in stacked_params.values() if p.requires_grad]
    if torch.is_grad_enabled() and trained and not x.requires_grad:
        # Tie x to this stage's params by an exact zero, so that on every
        # rank every hand-off lies on a path to the params: the last
        # stage's fill ticks only pass x along, and autograd.grad would
        # otherwise prune their hand-offs' backward there and not on the
        # other stages.
        x = x + 0.0 * trained[0].reshape(-1)[0].to(x.dtype)
    mb = x.reshape(M, B // M, *x.shape[1:])
    T = M + S - 1
    n_local = next(iter(stacked_params.values())).shape[0]

    def run_stage(h, mb_idx):
        aux_sum = None
        for i in range(n_local):
            p_one = {name: p[i] for name, p in stacked_params.items()}
            args = (p_one, h)
            if with_context:
                args += ({"layer": stage * n_local + i, "microbatch": mb_idx},)
            out = layer_fn(*args)
            if with_aux:
                h, aux = out
                aux_sum = aux if aux_sum is None else aux_sum + aux
            else:
                h = out
        return h, aux_sum

    is_first = torch.tensor(stage == 0, device=x.device)
    buf = torch.zeros_like(mb[0])
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = []
    for t in range(T):
        # Stage 0 ingests microbatch t (clamped in the drain phase); later
        # stages take what the previous stage handed over last tick. Stage
        # s holds microbatch t - s on tick t.
        h_in = torch.where(is_first, mb[min(t, M - 1)], buf)
        mb_idx = min(max(t - stage, 0), M - 1)
        valid = 0 <= t - stage < M
        if mask_bubble and not valid:
            # Exact: a buffer consumed at (s, t) was made at (s-1, t-1),
            # and valid(s-1, t-1) == valid(s, t), so no consumed value ever
            # passes through here.
            h_out = h_in
        else:
            with _masked_tick(axis_name) if mask_bubble else contextlib.nullcontext():
                h_out, aux_tick = run_stage(h_in, mb_idx)
            if with_aux and valid:  # garbage ticks' aux stays out of the loss
                aux_acc = aux_acc + aux_tick
        outs.append(h_out)
        if t < T - 1:
            buf = coll.ppermute(h_out, axis_name, 1)
    # The last stage emits microbatch j at tick j + S - 1: its M outputs,
    # broadcast to every stage by a sum.
    last = torch.stack(outs[S - 1:S - 1 + M])
    is_last = torch.tensor(stage == S - 1, device=x.device)
    y = coll.psum(torch.where(is_last, last, torch.zeros_like(last)), axis_name)
    y = y.reshape(B, *x.shape[1:])
    if with_aux:
        return y, coll.psum(aux_acc, axis_name) / (n_local * S * M)
    return y


def stack_layer_params(per_layer_params: list) -> dict:
    """Per-layer param dicts (one structure) -> one dict with a leading
    ``[n_layers]``: the stacked tree whose leaves
    :func:`pipeline_param_specs` shards."""
    return {name: torch.stack([p[name] for p in per_layer_params])
            for name in per_layer_params[0]}


def pipeline_param_specs(stacked_params: dict, axis_name: str = "pipeline") -> dict:
    """Specs of a stacked layer stack, in the port's form (name -> pairs of
    ``(axis, dim)``): the leading dim over ``axis_name``."""
    return {name: ((axis_name, 0),) for name in stacked_params}
