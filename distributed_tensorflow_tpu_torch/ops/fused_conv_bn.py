r"""Fused 1x1-conv + BatchNorm (+ReLU) with a hand-written backward.

Port of ``distributed_tensorflow_tpu/ops/fused_conv_bn.py``. Same function,
signature and results. The forward stays plain PyTorch (:func:`_fwd_math`:
a matrix product and f32 fast-variance statistics, as the JAX package left
it to XLA); the backward is the kernels of ``csrc/fused_conv_bn.cu`` behind
a ``torch.autograd.Function`` in place of ``_fused``'s ``custom_vjp``::

    g   = dA * mask             mask = (gamma*x_hat+beta > 0) recomputed
    s1  = sum_m g               \  reduce kernel: partials per M range,
    s2  = sum_m g * x_hat       /  summed here
    dz  = gamma*inv * (g - s1/M - x_hat*s2/M)      per element, in registers
    dx  = dz @ W^T              \  apply kernels: dz recomputed per tile,
    dW  = x^T @ dz              /  never written to device memory
    dgamma = s2, dbeta = s1

dz is rounded to W's dtype before both products, dx is written in dA's
dtype, and the f32 dW is cast to W's dtype, as in the JAX package; in f32
none of these rounds. The mean/var outputs feed the running averages only:
their gradient is stopped.

Dispatch is by the tensors' device: CPU tensors take the plain versions
(:func:`bn_bwd_reduce_reference`, :func:`bn_bwd_apply_dx_reference`,
:func:`bn_bwd_apply_dw_reference`), CUDA tensors the kernels or an
exception. ``fused_supported`` keeps the JAX package's gate (channel counts
in [128, 4096], an M that its TPU tiling divides, and the
``FUSED_CONV_BN_MAXM`` / ``FUSED_CONV_BN_MINM`` bounds) so that the same
units fuse as there; the kernels take any M.

The JAX package's holder modules (``Conv1x1Kernel``, ``BNParamsStats``)
declared the leaves ``nn.Conv`` and ``nn.BatchNorm`` would, so that fused
and plain units share one parameter tree. In the port the plain units'
own modules hold them (``models/resnet.py`` ``Conv`` and ``BatchNorm``),
and :func:`fused_unit` runs a unit through those modules.
"""

from __future__ import annotations

import ctypes
import os

import torch

from distributed_tensorflow_tpu_torch.ops.pointwise_conv import (
    check_operands,
    one_wave_rows,
    rows_per_split,
    sm_count,
)

_MAX_KN = 4096
_TILE_BYTES = 2 * 1024 * 1024
# Blocks to aim for in a split pass on the H100's 132 SMs: eight waves of
# the light reduce blocks, two of the fp32 dW kernel's product blocks
# (whose f32 partials cost a write and a read of [splits, K, N] each).
_REDUCE_BLOCKS = 1056
_DW_BLOCKS = 264
# The bf16 dW kernel's dW tile (csrc/fused_conv_bn.cu): _dw_tile_rows(K)
# rows of K by 128 columns of N.
_DW_TILE_N = 128
# The most M rows one of its M ranges takes: 256 `wgmma` k-steps into one
# f32 accumulator, whose error grows with the steps it sums (csrc notes).
# No ResNet-50 or Inception-v3 shape plans a longer range.
_DW_MAX_RANGE_ROWS = 4096


def _dw_tile_rows(k: int) -> int:
    """Rows of dW (of K) a block of the bf16 dW kernel owns; the kernel
    takes what this returns (256 where K > 128: its dz serves two 64-wide
    x2 slices per warpgroup)."""
    return 256 if k > 128 else 128


#: Kernel launches since the last :func:`reset_launch_counts`; each wrapper
#: adds one where it launches its kernel and nowhere else.
LAUNCHES = {"bn_bwd_reduce": 0, "bn_bwd_apply_dx": 0, "bn_bwd_apply_dw": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _tile_m(m: int, k: int, n: int) -> int | None:
    """Largest multiple-of-16 divisor of m whose TPU tile working set fits."""
    cap = max(16, _TILE_BYTES // max(1, 2 * (2 * n + 2 * k)))
    for t in range(min(1024, cap, m) & ~15, 15, -16):
        if m % t == 0:
            return t
    return None


def fused_supported(m: int, k: int, n: int) -> bool:
    """The unit shapes that take the fused backward in the JAX package.

    Both channel dims in [128, 4096] and M tiled by :func:`_tile_m`.
    ``FUSED_CONV_BN_MAXM`` / ``FUSED_CONV_BN_MINM`` (env) bound the M range
    that fuses (M is stage-unique in ResNet-50: 401408 / 100352 / 25088 /
    6272 at b=128).
    """
    maxm = int(os.environ.get("FUSED_CONV_BN_MAXM", "0") or 0)
    minm = int(os.environ.get("FUSED_CONV_BN_MINM", "0") or 0)
    if (maxm and m > maxm) or (minm and m < minm):
        return False
    return 128 <= k <= _MAX_KN and 128 <= n <= _MAX_KN and _tile_m(m, k, n) is not None


def _pack_consts(mu, inv, gamma, beta, c1=None, c2=None) -> torch.Tensor:
    """Per-channel constants as one ``[8, N]`` f32 tensor: mu, inv, gamma,
    beta, s1/M, s2/M (zero when not given), two zero rows."""
    z = torch.zeros_like(mu, dtype=torch.float32)
    rows = [mu, inv, gamma, beta, z if c1 is None else c1, z if c2 is None else c2, z, z]
    return torch.stack([r.to(torch.float32) for r in rows])


def _g_xhat(da2, z2, consts, relu: bool):
    """g and x_hat in f32, each step rounded in the kernels' order."""
    mu, inv, gamma, beta = consts[0], consts[1], consts[2], consts[3]
    xh = (z2.float() - mu) * inv
    da = da2.float()
    g = torch.where(gamma * xh + beta > 0.0, da, torch.zeros_like(da)) if relu else da
    return g, xh


def _dz(da2, z2, consts, relu: bool, dtype):
    g, xh = _g_xhat(da2, z2, consts, relu)
    return ((consts[2] * consts[1]) * (g - consts[4] - xh * consts[5])).to(dtype)


def bn_bwd_reduce_reference(da2, z2, consts, relu: bool):
    """Plain reduce pass (``_reduce_kernel``): ``(s1, s2)`` in f32."""
    g, xh = _g_xhat(da2, z2, consts, relu)
    return g.sum(0), (g * xh).sum(0)


def bn_bwd_apply_dx_reference(da2, z2, w2, consts, relu: bool):
    """Plain dx of the apply pass: ``dz @ W^T`` from dz rounded to W's
    dtype, f32 sums, in dA's dtype."""
    dz = _dz(da2, z2, consts, relu, w2.dtype)
    return torch.matmul(dz.float(), w2.float().t()).to(da2.dtype)


def bn_bwd_apply_dw_reference(da2, z2, x2, consts, relu: bool):
    """Plain dW of the apply pass: ``x^T @ dz`` in f32, dz rounded to x's
    dtype (the unit casts W to x's dtype, so both are W's)."""
    dz = _dz(da2, z2, consts, relu, x2.dtype)
    return torch.matmul(x2.float().t(), dz.float())


_LIBS: dict = {}


def _library():
    """The kernel library, built and bound on the first call and cached."""
    if not _LIBS:
        from distributed_tensorflow_tpu_torch.ops.build import LIBRARIES, load_libraries

        lib = load_libraries({"fused_conv_bn": LIBRARIES["fused_conv_bn"]})["fused_conv_bn"]
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        for fn, argtypes in (
            ("bn_bwd_reduce", [p] * 4 + [i] * 5 + [p]),
            ("bn_bwd_apply_dx", [p] * 5 + [i] * 5 + [p]),
            ("bn_bwd_apply_dw", [p] * 6 + [i] * 7 + [p]),
            ("fused_conv_bn_occupancy", [ip, ip]),
        ):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fused_conv_bn_error_string.argtypes = [ctypes.c_int]
        lib.fused_conv_bn_error_string.restype = ctypes.c_char_p
        _LIBS["fused_conv_bn"] = lib
    return _LIBS["fused_conv_bn"]


def build() -> None:
    """Compile (or load the cached build of) the kernel library."""
    _library()


def occupancy() -> dict:
    """Dynamic shared memory (bytes) and resident blocks per SM of the bf16
    dW kernel, as the card's occupancy calculator reports them:
    ``{"bn_bwd_apply_dw": (smem, blocks)}``."""
    lib = _library()
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.fused_conv_bn_occupancy(ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        msg = lib.fused_conv_bn_error_string(rc).decode()
        raise RuntimeError(f"fused_conv_bn_occupancy failed: {msg}")
    return {"bn_bwd_apply_dw": (smem.value, blocks.value)}


def dw_rows_per_split(m: int, k: int, n: int, sms: int) -> int:
    """M rows per block of the bf16 dW kernel: the wgrad's one-wave rule
    (:func:`one_wave_rows`) over its dW tiles (256 or 128 rows by 128
    columns), in whole 64-row chunks, at most ``_DW_MAX_RANGE_ROWS``."""
    tiles = -(-k // _dw_tile_rows(k)) * -(-n // _DW_TILE_N)
    return min(one_wave_rows(m, tiles, sms), _DW_MAX_RANGE_ROWS)


def _check(fn: str, tensors: dict, consts) -> torch.dtype:
    dtype = check_operands(fn, tensors)
    n = tensors["da"].shape[1]
    if tensors["z"].shape != tensors["da"].shape:
        raise ValueError(f"{fn}: da and z must share one [M, N] shape")
    if (consts.dtype != torch.float32 or tuple(consts.shape) != (8, n)
            or consts.device != tensors["da"].device or not consts.is_contiguous()):
        raise ValueError(f"{fn}: consts must be contiguous f32 [8, {n}] on da's device")
    return dtype


def _launch(lib, fn: str, *args) -> None:
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.fused_conv_bn_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg}")
    LAUNCHES[fn] += 1


def bn_bwd_reduce_cuda(da2, z2, consts, relu: bool):
    """Launch the reduce kernel: ``(s1, s2)`` f32 ``[N]``, its partials
    summed here."""
    dtype = _check("bn_bwd_reduce_cuda", {"da": da2, "z": z2}, consts)
    m, n = da2.shape
    rows = rows_per_split(m, -(-n // 64), _REDUCE_BLOCKS)
    part = torch.empty((-(-m // rows), 2, n), dtype=torch.float32, device=da2.device)
    _launch(_library(), "bn_bwd_reduce", da2.data_ptr(), z2.data_ptr(), consts.data_ptr(),
            part.data_ptr(), m, n, rows, int(dtype == torch.float32), int(relu),
            torch.cuda.current_stream(da2.device).cuda_stream)
    total = part.sum(0)
    return total[0], total[1]


def bn_bwd_apply_dx_cuda(da2, z2, w2, consts, relu: bool):
    """Launch the dx kernel of the apply pass: ``[M, K]`` in dA's dtype."""
    dtype = _check("bn_bwd_apply_dx_cuda", {"da": da2, "z": z2, "w": w2}, consts)
    m, n = da2.shape
    k = w2.shape[0]
    if w2.shape[1] != n:
        raise ValueError(f"bn_bwd_apply_dx_cuda: w {tuple(w2.shape)} is not [K, {n}]")
    dx = torch.empty((m, k), dtype=dtype, device=da2.device)
    _launch(_library(), "bn_bwd_apply_dx", da2.data_ptr(), z2.data_ptr(), w2.data_ptr(),
            consts.data_ptr(), dx.data_ptr(), m, k, n, int(dtype == torch.float32),
            int(relu), torch.cuda.current_stream(da2.device).cuda_stream)
    return dx


def bn_bwd_apply_dw_cuda(da2, z2, x2, consts, relu: bool):
    """Launch the dW kernel of the apply pass: ``[K, N]`` f32. Its partials
    over M ranges (bf16: :func:`dw_rows_per_split`; fp32: two waves of the
    first design's blocks) are summed on the card in a fixed order, so two
    runs give the same bits."""
    dtype = _check("bn_bwd_apply_dw_cuda", {"da": da2, "z": z2, "x": x2}, consts)
    m, n = da2.shape
    k = x2.shape[1]
    if x2.shape[0] != m:
        raise ValueError(f"bn_bwd_apply_dw_cuda: x {tuple(x2.shape)} is not [{m}, K]")
    fp32 = dtype == torch.float32
    rows = (rows_per_split(m, -(-k // 128) * -(-n // 128), _DW_BLOCKS) if fp32
            else dw_rows_per_split(m, k, n, sm_count(da2.device)))
    tile_rows = 0 if fp32 else _dw_tile_rows(k)
    splits = -(-m // rows)
    dw = torch.empty((k, n), dtype=torch.float32, device=da2.device)
    part = (torch.empty((splits, k, n), dtype=torch.float32, device=da2.device)
            if splits > 1 else None)
    _launch(_library(), "bn_bwd_apply_dw", da2.data_ptr(), z2.data_ptr(), x2.data_ptr(),
            consts.data_ptr(), 0 if part is None else part.data_ptr(), dw.data_ptr(), m, k, n,
            rows, tile_rows, int(fp32), int(relu),
            torch.cuda.current_stream(da2.device).cuda_stream)
    return dw


def _bn_bwd(da2, z2, x2, w2, mean, inv, gamma, beta, relu: bool):
    """``(dx2, dw [K, N] f32, s1, s2)``: the kernels for CUDA tensors, the
    plain versions for CPU ones."""
    m = x2.shape[0]
    consts = _pack_consts(mean, inv, gamma, beta)
    if da2.is_cuda:
        da2, z2, x2, w2 = (t.contiguous() for t in (da2, z2, x2, w2))
        s1, s2 = bn_bwd_reduce_cuda(da2, z2, consts, relu)
        consts = _pack_consts(mean, inv, gamma, beta, s1 / m, s2 / m)
        dx2 = bn_bwd_apply_dx_cuda(da2, z2, w2, consts, relu)
        dw = bn_bwd_apply_dw_cuda(da2, z2, x2, consts, relu)
        return dx2, dw, s1, s2
    if da2.device.type != "cpu":
        raise ValueError(f"the fused conv+BN backward runs on cuda or cpu, not {da2.device}")
    s1, s2 = bn_bwd_reduce_reference(da2, z2, consts, relu)
    consts = _pack_consts(mean, inv, gamma, beta, s1 / m, s2 / m)
    dx2 = bn_bwd_apply_dx_reference(da2, z2, w2, consts, relu)
    dw = bn_bwd_apply_dw_reference(da2, z2, x2, consts, relu)
    return dx2, dw, s1, s2


def _fwd_math(x2, w2, gamma, beta, relu: bool, eps: float):
    """Forward: ``(a2, z2, mean, var, inv)``; statistics in f32, fast
    variance E[z^2] - E[z]^2 (biased), as flax's BatchNorm computes them."""
    z2 = torch.matmul(x2, w2)
    zf = z2.float()
    mean = zf.mean(0)
    var = zf.square().mean(0) - mean.square()
    inv = torch.rsqrt(var + eps)
    y = (zf - mean) * (inv * gamma) + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype), z2, mean, var, inv


class _Fused(torch.autograd.Function):
    """``(a2, mean, var)`` with the fused backward; mean and var carry no
    gradient."""

    @staticmethod
    def forward(ctx, x2, w2, gamma, beta, relu, eps):
        a2, z2, mean, var, inv = _fwd_math(x2, w2, gamma, beta, relu, eps)
        ctx.save_for_backward(x2, w2, z2, mean, inv, gamma, beta)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return a2, mean, var

    @staticmethod
    def backward(ctx, da2, _dmean, _dvar):
        x2, w2, z2, mean, inv, gamma, beta = ctx.saved_tensors
        dx2, dw, s1, s2 = _bn_bwd(da2, z2, x2, w2, mean, inv, gamma, beta, ctx.relu)
        return dx2, dw.to(w2.dtype), s2, s1, None, None


def conv1x1_bn_act(x4, kernel, gamma, beta, *, relu: bool, strides: int = 1,
                   eps: float = 1e-5):
    """1x1 conv + train-mode BatchNorm (+ReLU) with the fused backward.

    Args:
      x4: ``[B, H, W, K]`` activations (bf16 on the card's main path).
      kernel: ``[1, 1, K, N]`` or ``[K, N]`` conv kernel (cast to x4's dtype).
      gamma, beta: BN scale/bias ``[N]`` (f32).
      relu: apply ReLU after the BN.
      strides: spatial stride (a strided 1x1 conv = slice, then product).

    Returns ``(a [B, H', W', N], batch_mean [N], batch_var [N])``; the
    statistics carry no gradient. Shapes must pass :func:`fused_supported`.
    """
    if kernel.dim() == 4:
        kernel = kernel[0, 0]
    if strides > 1:
        x4 = x4[:, ::strides, ::strides, :]
    b, h, w, k = x4.shape
    n = kernel.shape[1]
    if not fused_supported(h * w * b, k, n):
        raise ValueError(
            f"conv1x1_bn_act: shape (M={h * w * b}, K={k}, N={n}) is outside "
            "the fused kernel family's supported range; gate callers on "
            "fused_supported(m, k, n)"
        )
    x2 = x4.reshape(b * h * w, k)
    a2, mean, var = _Fused.apply(x2, kernel.to(x4.dtype), gamma, beta, relu, eps)
    return a2.reshape(b, h, w, n), mean, var


def fused_unit(x, conv, bn, stats, *, relu: bool, dtype, strides: int = 1,
               eps: float = 1e-5):
    """One conv1x1 + BN (+ReLU) unit through the fused op: ``conv`` holds the
    kernel (``weight [N, K, 1, 1]``), ``bn`` the scale/bias and updates the
    running averages in ``stats`` from the batch statistics."""
    a, mean, var = conv1x1_bn_act(
        x.to(dtype), conv.weight[:, :, 0, 0].t(), bn.weight, bn.bias,
        relu=relu, strides=strides, eps=eps,
    )
    bn.update(stats, mean, var)
    return a
