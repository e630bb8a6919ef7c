"""Mixture-of-experts with expert parallelism over an ``"expert"`` mesh axis
(port of ``parallel/moe.py``).

Experts shard over the ``"expert"`` axis (each rank holds ``n_experts /
|axis|`` expert FFNs), tokens are routed Switch-style (top-1) or by
GShard's top-2 rules (``topk=2``), each expert takes at most ``capacity``
tokens, and a load-balance aux loss comes back beside the output. Each
rank computes only its local experts' tokens; the partial outputs are
summed over the axis, so the train step's per-leaf grad contract
(sharded leaves 1/t, replicated ones averaged) applies unchanged.

Three dispatch layouts, as in the JAX package:

- :func:`moe_apply`: tokens replicated across the expert axis; every rank
  routes all tokens and computes only its experts', partial outputs summed
  (:func:`..collectives.psum`). Exact global token-order capacity;
- :func:`moe_apply_a2a`: each rank routes its contiguous ``N/S`` slice into
  per-expert capacity buffers ``[E, C, H]``, a tiled all-to-all over the
  axis delivers each rank the tokens of its experts, the outputs ride the
  reverse all-to-all, and an all-gather rebuilds ``[N, H]``. GShard's
  grouped capacity (one group a rank): equal to the replicated layout when
  nothing overflows;
- ``moe_apply_a2a(..., tokens_sharded=True)``: the batch itself is sharded
  over the axis; the local rows route, and the local rows come back.

Capacity is the Switch rule ``capacity = ceil(capacity_factor * N / E)``
(computed as the JAX package computes it), in token order (by choice rank
first for top-2); an overflow token's output is 0 (pair the layer with a
residual). Invalid (pad) tokens take no slot and add nothing to the
statistics.

Differences of form, not of arithmetic: ``expert_fn`` runs all local
experts at once (``params`` with a leading ``[e_local]`` dim, tokens
``[e_local, C, H]``), where JAX scans one expert at a time; and the
scatters write dropped entries into a spare row that is never read, where
JAX drops out-of-range writes (``mode="drop"``), which CUDA indexing would
fault on. Top-k selection takes the lower expert index first on ties, as
``lax.top_k`` does, by repeated ``argmax`` (``torch.topk`` promises no
order on ties).
"""

from __future__ import annotations

from collections.abc import Callable

import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.parallel import collectives as coll

# expert_fn(local expert params {name: [e_local, ...]}, tokens [e_local, C, H])
#   -> [e_local, C, H]
ExpertFn = Callable[[dict, torch.Tensor], torch.Tensor]


def _balance_aux(count_e, prob_e, n_valid, stats_axes, e):
    """Shazeer/Fedus load-balance aux ``E * sum_e f_e * p_e`` from this
    rank's statistics, summed over every token-sharding axis in
    ``stats_axes`` first (one all-reduce an axis), so it is the global
    ratio on every rank."""
    if stats_axes:
        stats = torch.cat([count_e, prob_e, n_valid.reshape(1)])
        for ax in stats_axes:
            stats = coll.psum(stats, ax)
        count_e, prob_e, n_valid = stats[:e], stats[e:2 * e], stats[2 * e]
    n_valid = n_valid.clamp_min(1.0)
    return e * torch.sum((count_e / n_valid) * (prob_e / n_valid))


def switch_route(router_logits: torch.Tensor, capacity: int, valid=None,
                 stats_axes: tuple[str, ...] = ()):
    """Top-1 routing with per-expert capacity (Switch Transformer).

    ``router_logits`` ``[N, E]``; ``valid`` an optional ``[N]`` bool of real
    tokens (invalid ones are never kept, take no slot and add nothing to
    the statistics); ``stats_axes`` the axes the tokens are sharded over.
    Returns ``(assign [N], gate [N], slot [N], kept [N], aux)``: the chosen
    expert, its softmax probability, the token's slot in the expert's
    buffer (meaningful where ``kept``) and the aux loss."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    assign = probs.argmax(dim=-1)
    gate = probs.gather(1, assign[:, None])[:, 0]
    onehot = F.one_hot(assign, e).float()
    if valid is not None:
        onehot = onehot * valid[:, None].float()
    # Position of each token in its expert's queue, 1-based (token order;
    # invalid tokens were zeroed out of onehot and hold no position).
    pos = (onehot.cumsum(0) * onehot).sum(-1)
    kept = (pos > 0) & (pos <= capacity)
    slot = (pos - 1).long()
    count_e = onehot.sum(0)
    if valid is not None:
        probs = probs * valid[:, None].float()
    prob_e = probs.sum(0)
    n_valid = count_e.sum() if valid is not None else torch.tensor(
        float(n), device=probs.device)
    return assign, gate, slot, kept, _balance_aux(count_e, prob_e, n_valid, stats_axes, e)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest of each row, the lower index first on
    ties; values carry the gradient."""
    scores = probs.detach().clone()
    picks = []
    for _ in range(k):
        idx = scores.argmax(dim=-1)
        picks.append(idx)
        scores.scatter_(1, idx[:, None], float("-inf"))
    assign = torch.stack(picks, dim=1)
    return probs.gather(1, assign), assign


def switch_route_topk(router_logits: torch.Tensor, capacity: int, k: int, valid=None,
                      stats_axes: tuple[str, ...] = ()):
    """Top-k routing (k=2 is GShard's) with per-expert capacity: each token
    picks its k most probable experts with gates renormalised over the k;
    queue priority by choice rank (every first choice before any second),
    then token order; capacity per expert unchanged; a dropped choice adds
    0. The aux counts first choices only (``f_e``) against the mean
    probability mass (``p_e``). Returns ``(assign, gate, slot, kept)``
    ``[N, k]`` and the aux."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    top_p, assign = _top_k(probs, k)
    gate = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    v = (torch.ones(n, device=probs.device) if valid is None else valid.float())
    onehot = F.one_hot(assign, e).float() * v[:, None, None]
    # Rank-major queue positions: offset = what earlier ranks placed in
    # each expert's queue.
    offset = torch.zeros(e, device=probs.device)
    cols = []
    for j in range(k):
        oh = onehot[:, j, :]
        within = (oh.cumsum(0) * oh).sum(-1)  # 1-based, 0 if none
        cols.append(within + (offset * oh).sum(-1) * (within > 0).float())
        offset = offset + oh.sum(0)
    pos = torch.stack(cols, dim=1)
    kept = (pos > 0) & (pos <= capacity)
    slot = (pos - 1).long()
    count_e = onehot[:, 0, :].sum(0)  # first choices only (GShard)
    prob_e = (probs * v[:, None]).sum(0)
    return assign, gate, slot, kept, _balance_aux(count_e, prob_e, v.sum(), stats_axes, e)


def _route(router_logits, capacity, valid, stats_axes, topk):
    """``[N, k]``-shaped routing: top-1 through :func:`switch_route`, top-k
    (k >= 2) through :func:`switch_route_topk`."""
    if topk == 1:
        assign, gate, slot, kept, aux = switch_route(router_logits, capacity, valid,
                                                     stats_axes)
        return assign[:, None], gate[:, None], slot[:, None], kept[:, None], aux
    return switch_route_topk(router_logits, capacity, topk, valid, stats_axes)


def _capacity(capacity_factor: float, n: int, e: int) -> int:
    return int(-(-capacity_factor * n // e))  # ceil, as the JAX package computes it


def _local_experts(expert_params_local: dict) -> int:
    return next(iter(expert_params_local.values())).shape[0]


def moe_apply(expert_fn: ExpertFn, expert_params_local: dict, router_logits: torch.Tensor,
              x: torch.Tensor, *, axis_name: str | None = "expert",
              capacity_factor: float = 1.25, valid=None,
              stats_axes: tuple[str, ...] = (), topk: int = 1):
    """A capacity-bounded MoE layer, experts sharded over ``axis_name``
    (tokens replicated across it; None: the stack is every expert).

    ``expert_params_local`` is this rank's slice of the stacked expert
    params (leading ``[e_local]``), ``router_logits`` ``[N, E]`` and ``x``
    ``[N, H]`` replicated over the axis, ``valid`` an optional ``[N]`` bool.
    Returns ``(y [N, H], aux)``: gate-weighted expert outputs (0 for dropped
    and invalid tokens) and the load-balance aux."""
    n, e_global = router_logits.shape
    h = x.shape[-1]
    local_e = _local_experts(expert_params_local)
    shards = 1 if axis_name is None else coll.axis_size(axis_name)
    if local_e * shards != e_global:
        raise ValueError(f"router has {e_global} experts but shards hold {local_e} x {shards}")
    capacity = _capacity(capacity_factor, n, e_global)
    assign, gate, slot, kept, aux = _route(router_logits, capacity, valid, stats_axes, topk)
    # Flattened (token, choice) entries: choice j of token i is entry i*k + j.
    fa, fg, fs, fk = (t.reshape(-1) for t in (assign, gate, slot, kept))
    tok = torch.arange(n, device=x.device).repeat_interleave(assign.shape[1])
    first = 0 if axis_name is None else coll.axis_index(axis_name) * local_e
    local = fa - first
    mine = fk & (local >= 0) & (local < local_e)
    # Every local expert's capacity buffer in one [e_local * C] index; the
    # entries that are not this rank's go to a spare last row, dropped.
    spare = local_e * capacity
    flat = torch.where(mine, local * capacity + fs, torch.full_like(fs, spare))
    token_idx = torch.zeros(spare + 1, dtype=torch.long, device=x.device).index_put(
        (flat,), tok)[:spare]
    w = torch.zeros(spare + 1, dtype=x.dtype, device=x.device).index_put(
        (flat,), fg.to(x.dtype))[:spare]
    # Unfilled slots read token 0 with weight 0.
    out = expert_fn(expert_params_local, x[token_idx].view(local_e, capacity, h))
    out = out * w.view(local_e, capacity, 1)
    y = torch.zeros_like(x).index_add(0, token_idx, out.reshape(spare, h))
    if axis_name is not None and shards > 1:
        y = coll.psum(y, axis_name)
    return y, aux


def moe_apply_a2a(expert_fn: ExpertFn, expert_params_local: dict,
                  router_logits: torch.Tensor, x: torch.Tensor, *, axis_name: str = "expert",
                  capacity_factor: float = 1.25, valid=None,
                  stats_axes: tuple[str, ...] = (), tokens_sharded: bool = False,
                  topk: int = 1):
    """Token-sharded dispatch: capacity buffers ``[E, C, H]`` exchanged by a
    tiled all-to-all over ``axis_name``.

    With ``tokens_sharded=False`` the arguments are those of
    :func:`moe_apply` (replicated over the axis): each rank routes its
    contiguous ``N/S`` slice, and the output is all-gathered back to ``[N,
    H]``. With ``True`` they are this rank's rows already and the local
    ``[N_loc, H]`` comes back. Capacity per (group, expert) is
    ``ceil(capacity_factor * N_loc / E)``, one group a rank. ``stats_axes``
    names every axis the routed tokens are sharded over (the expert axis
    itself for the replicated entry; ``()`` gives per-group statistics
    under ``tokens_sharded``)."""
    h = x.shape[-1]
    S = coll.axis_size(axis_name)
    local_e = _local_experts(expert_params_local)
    e_global = router_logits.shape[1]
    if local_e * S != e_global:
        raise ValueError(f"router has {e_global} experts but shards hold {local_e} x {S}")
    if tokens_sharded:
        x_loc, logits_loc, valid_loc = x, router_logits, valid
        n_loc = x.shape[0]
    else:
        n = router_logits.shape[0]
        if n % S:
            raise ValueError(f"token count {n} not divisible by expert axis {S}")
        n_loc = n // S
        rows = slice(coll.axis_index(axis_name) * n_loc, (coll.axis_index(axis_name) + 1)
                     * n_loc)
        x_loc, logits_loc = x[rows], router_logits[rows]
        valid_loc = None if valid is None else valid[rows]
    capacity = _capacity(capacity_factor, n_loc, e_global)
    assign, gate, slot, kept, aux = _route(logits_loc, capacity, valid_loc, stats_axes, topk)
    k = assign.shape[1]
    # Kept (token, choice) entries into the per-(global expert) buffers;
    # the dropped ones into a spare last row.
    spare = e_global * capacity
    flat = torch.where(kept, assign * capacity + slot, torch.full_like(slot, spare)).reshape(-1)
    tokf = torch.arange(n_loc, device=x.device).repeat_interleave(k)
    disp = torch.zeros(spare + 1, h, dtype=x.dtype, device=x.device).index_put(
        (flat,), x_loc[tokf])[:spare].view(e_global, capacity, h)
    # All-to-all #1: block j of my buffers -> rank j. Received rows by
    # source: recv[j * local_e + e] = source j's buffer for my expert e.
    recv = coll.all_to_all(disp, axis_name, 0, 0)
    toks = (recv.view(S, local_e, capacity, h).transpose(0, 1)
            .reshape(local_e, S * capacity, h))
    outs = expert_fn(expert_params_local, toks)
    # All-to-all #2 gives each source its tokens' outputs back, [E, C, H]
    # keyed by global expert.
    back = (outs.view(local_e, S, capacity, h).transpose(0, 1)
            .reshape(S * local_e, capacity, h))
    ret = coll.all_to_all(back.contiguous(), axis_name, 0, 0)
    zero = torch.zeros_like(assign)
    vals = ret[torch.where(kept, assign, zero), torch.where(kept, slot, zero)]  # [N, k, H]
    y_loc = (vals * (gate * kept).to(x.dtype)[..., None]).sum(dim=1)
    if tokens_sharded:
        return y_loc, aux
    return coll.all_gather(y_loc, axis_name, 0), aux


def stack_expert_params(per_expert_params: list) -> dict:
    """Per-expert param dicts -> one dict with a leading ``[n_experts]``."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import stack_layer_params

    return stack_layer_params(per_expert_params)


def expert_param_specs(stacked_params: dict, axis_name: str = "expert") -> dict:
    """Specs of a stacked expert set: the leading dim over the expert axis."""
    from distributed_tensorflow_tpu_torch.parallel.pipeline import pipeline_param_specs

    return pipeline_param_specs(stacked_params, axis_name)
