"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of ``distributed_tensorflow_tpu/ops/flash_attention.py``. Same layout
``[B, L, H, D]``, same key-padding mask ``[B, L]`` (True = attend), same
results: f32 scores and accumulation, P cast to V's dtype before the PV
product, fully masked query rows giving o = 0 and lse = -1e30,
natural-log lse ``[B, H, L]``. The backward recomputes P from the saved lse
in the base-2 domain and takes the lse cotangent of
:func:`flash_attention_block` into delta, as ``_bwd_impl`` does.

Dispatch is by the tensors' device and nothing else: CPU tensors run
:func:`flash_attention_reference` and
:func:`flash_attention_backward_reference`, CUDA tensors launch the kernels
in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (built at first use, see
:mod:`.build`) or raise.

The TPU package split each kernel into a ``[B*H, L, D]`` family and a flat
``[B, L, H*D]`` family to suit Mosaic's (8, 128) tiling; one kernel over the
strided ``[B, L, H, D]`` layout serves both on Hopper. ``packing`` is still
accepted and validated so callers keep their signature, and it never
changes a result. ``block_q``/``block_k`` keep their meaning for the padding
of the plain path; the kernels tile by 64 and mask the ragged edge
themselves, so neither direction pads on the card.
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

#: Kernel launches since the last :func:`reset_launch_counts`; each wrapper
#: adds one where it launches its kernel and nowhere else.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


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


_NEG_SCALED = torch.tensor(_NEG, dtype=torch.float32) * _LOG2E


def _recompute_p(q, k, mask, lse):
    """P ``[B, H, Lq, Lk]`` in f32 from the saved lse, in the base-2 domain.

    Masked keys take the SCALED mask value: a fully masked row carries
    lse = -1e30, and ``_NEG * _LOG2E - lse * _LOG2E`` must cancel to 0
    exactly (plain -1e30 would leave +4e29 and exp2 of it inf).
    """
    b, l, h, d = q.shape
    s = (d**-0.5 * _LOG2E) * torch.einsum("blhd,bkhd->bhlk", q.float(), k.float())
    if mask is None:
        keep = torch.ones((b, 1, 1, l), dtype=torch.float32, device=q.device)
    else:
        keep = mask.to(torch.float32).reshape(b, 1, 1, l)
    s = torch.where(keep != 0, s, _NEG_SCALED.to(s.device))
    return torch.exp2(s - (lse * _LOG2E)[..., None]) * keep


def flash_bwd_dq_reference(q, k, v, mask, do, lse, delta):
    """Plain dQ (``_bwd_dq_kernel``): dS = P * (dO V^T - delta), dS cast
    to K's dtype, f32 sums, times scale at the end."""
    p = _recompute_p(q, k, mask, lse)
    dp = torch.einsum("blhd,bkhd->bhlk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhlk,bkhd->blhd", ds.to(k.dtype).float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta):
    """Plain dK, dV (``_bwd_dkv_kernel``): dV = P^T dO with P cast to dO's
    dtype, dK = dS^T Q with dS cast to Q's dtype, f32 sums; scale on dK
    only."""
    p = _recompute_p(q, k, mask, lse)
    dv = torch.einsum("bhlk,blhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("blhd,bkhd->bhlk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhlk,blhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


def flash_bwd_delta(o, do, dlse=None):
    """delta = rowsum(dO * O) - dlse in f32, ``[B, H, L]`` (``_bwd_impl``
    :273-275: the lse cotangent folds into delta)."""
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_backward_reference(q, k, v, mask, o, lse, do, dlse=None):
    """Plain PyTorch backward: ``(dq, dk, dv)`` in the input dtypes.

    ``_bwd_impl``'s arithmetic in torch ops: P recomputed from ``lse``
    ``[B, H, L]``, delta = rowsum(dO * O) - dlse, dS = P * (dP - delta),
    f32 accumulation, scale applied to dQ and dK.
    """
    delta = flash_bwd_delta(o, do, dlse)
    dq = flash_bwd_dq_reference(q, k, v, mask, do, lse, delta)
    dk, dv = flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta)
    return dq, dk, dv


_LIBS: dict = {}


def _libraries() -> dict:
    """The kernel libraries by name, built and bound on the first call and
    cached after it (every launch goes through here)."""
    if _LIBS:
        return _LIBS
    from distributed_tensorflow_tpu_torch.ops.build import load_libraries

    libs = load_libraries({"flash_fwd": ["flash_fwd.cu"], "flash_bwd": ["flash_bwd.cu"]})
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "flash_fwd": {"flash_fwd": [p] * 6 + [i] * 5 + [f, p]},
        "flash_bwd": {
            "flash_bwd_dq": [p] * 8 + [i] * 5 + [f, f, p],
            "flash_bwd_dkv": [p] * 9 + [i] * 5 + [f, f, p],
        },
    }
    for name, lib in libs.items():
        for fn, argtypes in signatures[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    _LIBS.update(libs)
    return _LIBS


def build() -> None:
    """Compile (or load the cached builds of) the kernel libraries, one
    ``nvcc`` per source, started together."""
    _libraries()


def _check_operands(fn: str, tensors: dict, mask, b: int, l: int) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned, bf16 or
    fp32 ``[B, L, H, D]`` tensor of one dtype and shape on one CUDA device
    with D in the kernels' head dims, and ``mask`` is None or a contiguous
    bool ``[B, L]`` on that device."""
    first = next(iter(tensors.values()))
    if not all(x.is_cuda and x.device == first.device for x in tensors.values()):
        raise ValueError(f"{fn}: {', '.join(tensors)} must be on one CUDA device")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: dtype {first.dtype} not in (bfloat16, float32)")
    if any(x.dtype != first.dtype for x in tensors.values()):
        raise TypeError(f"{fn}: {', '.join(tensors)} must share one dtype")
    if first.dim() != 4 or any(x.shape != first.shape for x in tensors.values()):
        raise ValueError(
            f"{fn}: {', '.join(tensors)} must share a [B, L, H, D] shape, got "
            + ", ".join(str(tuple(x.shape)) for x in tensors.values())
        )
    if first.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {first.shape[-1]} not in {_KERNEL_HEAD_DIMS}")
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, l):
            raise ValueError(f"{fn}: mask must be bool [{b}, {l}]")
        if mask.device != first.device or not mask.is_contiguous():
            raise ValueError(f"{fn}: mask must be contiguous on q's device")


def _raise_on(lib, prefix: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} launch failed: {msg}")


def flash_fwd_cuda(q, k, v, mask=None):
    """Launch the forward kernel: ``(o, lse)`` for contiguous
    ``[B, L, H, D]`` bf16 or fp32 tensors on one CUDA device. Raises on
    anything else."""
    b, l, h, d = q.shape
    _check_operands("flash_fwd_cuda", {"q": q, "k": k, "v": v}, mask, b, l)
    lib = _libraries()["flash_fwd"]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, l, h, d,
        int(q.dtype == torch.float32), float(d**-0.5 * _LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, "flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_stats(fn: str, q, **stats) -> None:
    b, l, h, _ = q.shape
    for name, x in stats.items():
        if (x.dtype != torch.float32 or tuple(x.shape) != (b, h, l)
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous f32 [{b}, {h}, {l}] on q's device")


def _bwd_args(q, k, v, mask, do, lse, delta):
    b, l, h, d = q.shape
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
    tail = (b, l, h, d, int(q.dtype == torch.float32), float(d**-0.5 * _LOG2E),
            float(d**-0.5), torch.cuda.current_stream(q.device).cuda_stream)
    return pointers, tail


def flash_bwd_dq_cuda(q, k, v, mask, do, lse, delta):
    """Launch the dQ kernel (``_bwd_dq_kernel``'s counterpart)."""
    _check_operands("flash_bwd_dq_cuda", {"q": q, "k": k, "v": v, "do": do},
                    mask, *q.shape[:2])
    _check_stats("flash_bwd_dq_cuda", q, lse=lse, delta=delta)
    lib = _libraries()["flash_bwd"]
    dq = torch.empty_like(q)
    pointers, tail = _bwd_args(q, k, v, mask, do, lse, delta)
    _raise_on(lib, "flash_bwd", lib.flash_bwd_dq(*pointers, dq.data_ptr(), *tail))
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, mask, do, lse, delta):
    """Launch the dK/dV kernel (``_bwd_dkv_kernel``'s counterpart)."""
    _check_operands("flash_bwd_dkv_cuda", {"q": q, "k": k, "v": v, "do": do},
                    mask, *q.shape[:2])
    _check_stats("flash_bwd_dkv_cuda", q, lse=lse, delta=delta)
    lib = _libraries()["flash_bwd"]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    pointers, tail = _bwd_args(q, k, v, mask, do, lse, delta)
    _raise_on(lib, "flash_bwd",
              lib.flash_bwd_dkv(*pointers, dk.data_ptr(), dv.data_ptr(), *tail))
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, mask, o, lse, do, dlse=None):
    """The backward on the card: ``(dq, dk, dv)``. delta is plain torch
    here, as the JAX package computes it outside Pallas; then the dQ and
    the dK/dV kernels. ``do`` is made contiguous (autograd may hand in a
    strided one); everything else must be as the forward left it. Raises
    on anything the kernels do not take."""
    do = do.contiguous()
    delta = flash_bwd_delta(o, do, dlse)
    dq = flash_bwd_dq_cuda(q, k, v, mask, do, lse, delta)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, mask, do, lse, delta)
    return dq, dk, dv


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


def _backward(q, k, v, mask, o, lse, do, dlse):
    """Device dispatch of the backward, as :func:`_forward`. The plain path
    needs no padding: padded keys are masked (P = 0) and padded query rows
    get a zero cotangent, so both add exact zeros to every gradient."""
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, mask, o, lse, do, dlse)
    return flash_attention_backward_reference(q, k, v, mask, o, lse, do, dlse)


class _Flash(torch.autograd.Function):
    """``(o, lse)`` with the flash backward; the counterpart of the JAX
    package's ``custom_vjp``s. The lse cotangent (None when lse is unused,
    as in :func:`flash_attention`) folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, mask, l_pad):
        o, lse = _forward(q, k, v, mask, l_pad)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = _backward(q, k, v, mask, o, lse, do, dlse)
        return dq, dk, dv, None, None


def flash_attention_block(
    q, k, v, mask=None, *, block_q: int = _DEFAULT_BLOCK_Q,
    block_k: int = _DEFAULT_BLOCK_K, packing: str | None = None,
):
    """One flash block with its logsumexp: ``(o [B, L, H, D], lse [B, H, L])``.

    As in the JAX package, L must already fit both blocks (a ring shard):
    the blocks are fitted to L and a length with no multiple-of-8 divisor
    raises. Differentiable in both outputs.
    """
    b, l, h, d = q.shape
    _fit_block(block_q, l)
    _fit_block(block_k, l)
    _check_packing(packing, h, d)
    return _Flash.apply(q, k, v, mask, l)


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
    o, _ = _Flash.apply(q, k, v, mask, _pad_len(l, block_q, block_k))
    return o
