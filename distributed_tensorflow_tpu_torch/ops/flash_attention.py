"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Port of ``distributed_tensorflow_tpu/ops/flash_attention.py`` (forward half).
Same layout ``[B, L, H, D]``, same key-padding mask ``[B, L]`` (True =
attend), same results: f32 scores and accumulation, P cast to V's dtype
before the PV product, fully masked query rows giving o = 0 and
lse = -1e30, natural-log lse ``[B, H, L]``.

Dispatch is by the tensors' device and nothing else: CPU tensors run
:func:`flash_attention_reference`, CUDA tensors launch the kernel in
``csrc/flash_fwd.cu`` (built at first use, see :mod:`.build`) or raise.

The TPU package split the forward into a ``[B*H, L, D]`` family and a flat
``[B, L, H*D]`` family to suit Mosaic's (8, 128) tiling; one kernel over the
strided ``[B, L, H, D]`` layout serves both on Hopper. ``packing`` is still
accepted and validated so callers keep their signature, and it never
changes a result. ``block_q``/``block_k`` keep their meaning for the padding
of the plain path; the kernel tiles by 64 and masks the ragged edge itself.

Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

_NEG = -1e30
_LOG2E = math.log2(math.e)
_DEFAULT_BLOCK_Q = 512
_DEFAULT_BLOCK_K = 512
_PACKINGS = (None, "flat", "bh")
_KERNEL_HEAD_DIMS = (32, 64, 128)

#: Kernel launches since the last :func:`reset_launch_counts`; the wrapper
#: adds one where it launches the kernel and nowhere else.
LAUNCHES = {"flash_fwd": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _fit_block(default: int, l: int) -> int:
    """Largest multiple-of-8 block <= default dividing l (the ring-shard
    rule of the JAX package: a length with no such divisor raises)."""
    b = min(default, l)
    if b >= 8 and b % 8 == 0 and l % b == 0:
        return b
    b -= b % 8
    while b >= 8 and l % b:
        b -= 8
    if b >= 8 and l % b == 0:
        return b
    raise ValueError(
        f"block length {l} has no multiple-of-8 divisor <= {default}; "
        "pad the shard or pick a different ring size"
    )


def _packing_ok(h: int, d: int) -> bool:
    """The flat family's head geometry: D divides 128 and H*D is a multiple
    of 128. Kept so an explicit ``packing="flat"`` rejects what the JAX
    package rejects."""
    return d <= 128 and 128 % d == 0 and (h * d) % 128 == 0


def _check_packing(packing, h: int, d: int) -> None:
    if packing not in _PACKINGS:
        raise ValueError(f"packing must be one of {_PACKINGS}, got {packing!r}")
    if packing == "flat" and not _packing_ok(h, d):
        raise ValueError(
            f"packing='flat' needs whole heads tiling 128-lane groups "
            f"(D | 128 and H*D % 128 == 0); got H={h}, D={d}. "
            "Use packing='bh' or None (auto)."
        )


def flash_attention_reference(q, k, v, mask=None):
    """Plain PyTorch forward: ``(o [B, L, H, D], lse [B, H, L])``.

    The kernel's arithmetic in one pass over all keys (one K block, as the
    JAX kernels run at L <= 512 with their default blocks): base-2 scores
    in f32, masked keys at -1e30, P cast to V's dtype for the PV product,
    f32 sums.
    """
    b, l, h, d = q.shape
    scale = d**-0.5
    s = (scale * _LOG2E) * torch.einsum(
        "blhd,bkhd->bhlk", q.float(), k.float()
    )
    if mask is None:
        keep = torch.ones((b, 1, 1, l), dtype=torch.float32, device=q.device)
    else:
        keep = mask.to(torch.float32).reshape(b, 1, 1, l)
    s = torch.where(keep != 0, s, torch.full_like(s, _NEG))
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None]) * keep
    denom = p.sum(dim=-1)
    o = torch.einsum("bhlk,bkhd->blhd", p.to(v.dtype).float(), v.float())
    safe = denom.clamp_min(1e-37)
    o = (o / safe.permute(0, 2, 1)[..., None]).to(q.dtype)
    lse = torch.where(
        denom > 0, m / _LOG2E + torch.log(safe), torch.full_like(m, _NEG)
    )
    return o, lse


def _kernel_library():
    from distributed_tensorflow_tpu_torch.ops.build import load_library

    lib = load_library("flash_fwd", ["flash_fwd.cu"])
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.flash_fwd.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, p]
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def build() -> None:
    """Compile (or load the cached build of) the kernel library."""
    _kernel_library()


def flash_fwd_cuda(q, k, v, mask=None):
    """Launch the CUDA kernel: ``(o, lse)`` for contiguous ``[B, L, H, D]``
    bf16 or fp32 tensors on one CUDA device. Raises on anything else."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_fwd_cuda: dtype {q.dtype} not in (bfloat16, float32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_fwd_cuda: q, k, v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_fwd_cuda: q, k, v must share a [B, L, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, l, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head dim {d} not in {_KERNEL_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"flash_fwd_cuda: {name} must be contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, l):
            raise ValueError(f"flash_fwd_cuda: mask must be bool [{b}, {l}]")
        if mask.device != q.device or not mask.is_contiguous():
            raise ValueError("flash_fwd_cuda: mask must be contiguous on q's device")
    lib = _kernel_library()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, l, h, d,
        int(q.dtype == torch.float32), float(d**-0.5 * _LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: {lib.flash_fwd_error_string(rc).decode()}"
        )
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _pad_len(l: int, block_q: int, block_k: int) -> int:
    # Pad to a common multiple of BOTH blocks (flash_attention.py:898-911).
    block_q = min(block_q, max(l, 8))
    block_k = min(block_k, max(l, 8))
    step = math.lcm(block_q, block_k)
    return -(-l // step) * step


def _forward(q, k, v, mask, l_pad: int):
    """Device dispatch: the kernel on CUDA, the padded plain path on CPU."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, mask)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    b, l = q.shape[:2]
    if l_pad != l:
        pad = (0, 0, 0, 0, 0, l_pad - l)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
        if mask is None:
            mask = torch.ones((b, l), dtype=torch.bool)
        mask = torch.nn.functional.pad(mask, (0, l_pad - l), value=False)
    o, lse = flash_attention_reference(q, k, v, mask)
    return o[:, :l], lse[..., :l]


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, l_pad):
        return _forward(q, k, v, mask, l_pad)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError("flash backward: ported with the training slice")


def flash_attention_block(
    q, k, v, mask=None, *, block_q: int = _DEFAULT_BLOCK_Q,
    block_k: int = _DEFAULT_BLOCK_K, packing: str | None = None,
):
    """One flash block with its logsumexp: ``(o [B, L, H, D], lse [B, H, L])``.

    As in the JAX package, L must already fit both blocks (a ring shard):
    the blocks are fitted to L and a length with no multiple-of-8 divisor
    raises.
    """
    b, l, h, d = q.shape
    _fit_block(block_q, l)
    _fit_block(block_k, l)
    _check_packing(packing, h, d)
    return _FlashForward.apply(q, k, v, mask, l)


def flash_attention(
    q, k, v, mask=None, *, block_q: int = _DEFAULT_BLOCK_Q,
    block_k: int = _DEFAULT_BLOCK_K, packing: str | None = None,
):
    """Exact attention, flash-style. Layout ``[B, L, H, D]``, mask ``[B, L]``.

    Ragged L is handled as the JAX package pads it: padded keys masked out,
    padded query rows sliced off.
    """
    b, l, h, d = q.shape
    _check_packing(packing, h, d)
    o, _ = _FlashForward.apply(q, k, v, mask, _pad_len(l, block_q, block_k))
    return o
