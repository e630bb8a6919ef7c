"""All-to-all (Ulysses) sequence parallelism, the ring's alternative
(port of ``parallel/ulysses.py``).

Two all-to-alls re-partition the sharding from sequence to heads: each
rank then computes full-sequence attention for its ``H / S`` heads with a
single-device attention (dense, or the flash kernels), and the reverse
exchange restores the sequence sharding. Needs ``num_heads % S == 0``;
holds full-length K/V for its heads. Exact, as the ring is.

Layout as :func:`.ring_attention.ring_attention`: ``[B, L_local, H, D]``
shards with the sequence over the axis; key-padding mask ``[B, L_local]``.
"""

from __future__ import annotations

from distributed_tensorflow_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    axis_size,
)


def _seq_to_heads(x, axis_name: str):
    """``[B, L_loc, H, D]`` sequence-sharded -> ``[B, L, H/S, D]``
    head-sharded: this rank's heads split into S groups (group i to
    position i), the received L_loc chunks concatenated in position order,
    which is the loaders' contiguous sequence sharding."""
    return all_to_all(x, axis_name, split_axis=2, concat_axis=1)


def _heads_to_seq(x, axis_name: str):
    """``[B, L, H/S, D]`` head-sharded -> ``[B, L_loc, H, D]``
    sequence-sharded (the inverse)."""
    return all_to_all(x, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, axis_name: str, mask=None, *, inner: str = "dense"):
    """Exact attention over the global sequence by head re-partitioning.

    ``q, k, v``: local shards ``[B, L_local, H, D]``, H divisible by the
    axis size (else ``ValueError``). ``mask``: local key-padding mask,
    all-gathered once. ``inner``: ``"dense"`` or ``"flash"``
    (:func:`..ops.flash_attention.flash_attention` over the full length).
    Returns ``[B, L_local, H, D]``.
    """
    s = axis_size(axis_name)
    h = q.shape[2]
    if h % s:
        raise ValueError(f"num_heads {h} not divisible by axis size {s}; "
                         "use ring_attention for this geometry")
    if inner not in ("dense", "flash"):
        raise ValueError(f"unknown ulysses inner {inner!r}")
    qh = _seq_to_heads(q, axis_name)
    kh = _seq_to_heads(k, axis_name)
    vh = _seq_to_heads(v, axis_name)
    full_mask = None if mask is None else all_gather(mask, axis_name, dim=1)
    if inner == "flash":
        from distributed_tensorflow_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(qh, kh, vh, mask=full_mask)
    else:
        from distributed_tensorflow_tpu_torch.parallel.ring_attention import dense_attention

        ctx = dense_attention(qh, kh, vh, mask=full_mask)
    return _heads_to_seq(ctx, axis_name)
