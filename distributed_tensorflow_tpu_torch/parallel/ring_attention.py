"""Ring attention: exact sequence-parallel attention over the ``"seq"`` axis
(port of ``parallel/ring_attention.py``).

The sequence is sharded over a mesh axis; each rank keeps its query shard
and the key/value blocks (with their key mask) travel around the axis line
by :func:`..parallel.collectives.ppermute`, one hop a block. The math is
blockwise online softmax in f32, so the result is full attention, not an
approximation. Gradients flow back along the same ring (``ppermute``'s
backward is the inverse shift) to the rank that owns each K/V block.

Layout: ``[batch, seq_local, heads, head_dim]``; key-padding mask
``[batch, seq_local]``, True = attend. The collectives read the active mesh
(:func:`..parallel.mesh.active_mesh`), as the JAX functions read the axis
their ``shard_map`` binds.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.parallel.collectives import axis_size, ppermute

# Finite mask value: -inf would turn exp(-inf + inf) into NaN for
# fully-masked rows; exp(-1e30 - m) == 0 exactly in f32 for any finite m.
_MASK_VALUE = -1e30


def dense_attention(q, k, v, mask=None):
    """Reference single-device attention, same layout/mask contract.

    ``q,k,v: [B, L, H, D]``; ``mask: [B, Lk]`` True = attend (key padding
    mask). Scores and sums in f32 from the storage dtype's values; P is cast
    to V's dtype before the PV product; returns q.dtype. Fully masked query
    rows come out exactly 0.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("blhd,bkhd->bhlk", q.float(), k.float()) * scale
    if mask is not None:
        keep = mask.to(torch.bool)[:, None, None, :]
        s = torch.where(keep, s, torch.full_like(s, _MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = p * keep
    return torch.einsum(
        "bhlk,bkhd->blhd", p.to(v.dtype).float(), v.float()
    ).to(q.dtype)


def _rotate(k_blk, v_blk, mask_blk, axis_name):
    """The next block in: one hop along the axis line (position i receives
    position i - 1's block)."""
    k_blk = ppermute(k_blk, axis_name, 1)
    v_blk = ppermute(v_blk, axis_name, 1)
    if mask_blk is not None:
        mask_blk = ppermute(mask_blk, axis_name, 1)
    return k_blk, v_blk, mask_blk


def ring_attention(q, k, v, axis_name: str, mask=None, *, inner: str = "einsum",
                   carry_dtype=None):
    """Exact attention with Q sharded and K/V streamed around ``axis_name``.

    Args:
      q, k, v: local shards ``[B, L_local, H, D]`` (global L = L_local x
        the axis size; every rank of the line holds the same B).
      axis_name: the mesh axis to ring over (e.g. ``"seq"``).
      mask: local key-padding mask ``[B, L_local]``, True = attend; it
        travels with K/V.
      inner: ``"einsum"`` materialises the local ``[L_local, L_local]``
        score block in f32; ``"flash"`` runs
        :func:`..ops.flash_attention.flash_attention_block` per block (the
        CUDA kernels on a card) and merges the blocks by logsumexp.
      carry_dtype: dtype the K/V blocks travel in (None: their own). The
        flash inner casts each block to q's dtype at the kernel call, so an
        f32 carry still feeds the kernel bf16 operands.

    Returns ``[B, L_local, H, D]`` in q's dtype: this rank's queries over
    the global sequence; a row with no attendable key is 0.
    """
    if carry_dtype is not None:
        k = k.to(carry_dtype)
        v = v.to(carry_dtype)
    if inner == "flash":
        return _ring_attention_flash(q, k, v, axis_name, mask)
    if inner != "einsum":
        raise ValueError(f"unknown ring inner {inner!r}")
    n = axis_size(axis_name)
    scale = q.shape[-1] ** -0.5
    b, l_q, h, d = q.shape
    q32 = q.float()
    o = torch.zeros((b, l_q, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, l_q), _MASK_VALUE, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, l_q), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, mask
    for i in range(n):
        if i:
            k_blk, v_blk, mask_blk = _rotate(k_blk, v_blk, mask_blk, axis_name)
        s = torch.einsum("blhd,bkhd->bhlk", q32, k_blk.float()) * scale
        if mask_blk is not None:
            keep = mask_blk.to(torch.bool)[:, None, None, :]
            s = torch.where(keep, s, torch.full_like(s, _MASK_VALUE))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        if mask_blk is not None:
            # When every key so far is masked, m_new is the mask value and
            # exp(s - m_new) == 1 for masked entries: zero them.
            p = p * keep
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        o = o * corr.permute(0, 2, 1)[..., None] + torch.einsum(
            "bhlk,bkhd->blhd", p, v_blk.float())
        m = m_new
    # A row with zero attendable keys ends with denom 0: its output is 0.
    safe = denom.clamp_min(1e-37)
    return (o / safe.permute(0, 2, 1)[..., None]).to(q.dtype)


def _ring_attention_flash(q, k, v, axis_name: str, mask=None):
    """The ring with the flash block as its inner step: each hop computes
    this query shard against the streamed block (block-normalised output
    and per-row logsumexp) and merges blocks with the stable weighted
    combine o = sum_j e^{lse_j - m} o_j / sum_j e^{lse_j - m}, in f32. The
    lse cotangent of each block reaches the kernels' backward."""
    from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention_block

    n = axis_size(axis_name)
    b, l_q, h, d = q.shape
    acc = torch.zeros((b, l_q, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, l_q), _MASK_VALUE, dtype=torch.float32, device=q.device)
    z = torch.zeros((b, h, l_q), dtype=torch.float32, device=q.device)
    k_blk, v_blk, mask_blk = k, v, mask
    for i in range(n):
        if i:
            k_blk, v_blk, mask_blk = _rotate(k_blk, v_blk, mask_blk, axis_name)
        o_j, lse_j = flash_attention_block(
            q, k_blk.to(q.dtype), v_blk.to(q.dtype), mask_blk)
        m_new = torch.maximum(m, lse_j)
        w_old = torch.exp(m - m_new)
        w_j = torch.exp(lse_j - m_new)
        acc = (acc * w_old.permute(0, 2, 1)[..., None]
               + o_j.float() * w_j.permute(0, 2, 1)[..., None])
        z = z * w_old + w_j
        m = m_new
    # Fully masked rows: every o_j is 0, so acc is 0 whatever z is.
    safe = z.clamp_min(1e-37)
    return (acc / safe.permute(0, 2, 1)[..., None]).to(q.dtype)
