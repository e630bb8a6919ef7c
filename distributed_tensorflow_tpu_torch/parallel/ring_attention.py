"""Single-device attention (port of ``parallel/ring_attention.py``
``dense_attention``). The ring itself comes with the sequence-parallel
slice."""

from __future__ import annotations

import torch

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
