r"""Fused 1x1-conv + BatchNorm (+ReLU) with a hand-written backward.

Port of ``distributed_tensorflow_tpu/ops/fused_conv_bn.py``. Same function,
signature and results. The forward stays plain PyTorch (:func:`_fwd_math`:
a matrix product and f32 fast-variance statistics, as the JAX package left
it to XLA); the backward is the kernels of ``csrc/fused_conv_bn.cu`` behind
a ``torch.autograd.Function`` in place of ``_fused``'s ``custom_vjp``::

    g   = dA * mask             mask = (gamma*x_hat+beta > 0) recomputed
    s1  = sum_m g               \  reduce kernel: one launch, which also
    s2  = sum_m g * x_hat       /  writes s1/M and s2/M into the constants
    dz  = gamma*inv * (g - s1/M - x_hat*s2/M)      per element, on chip
    dx  = dz @ W^T              \  apply kernels: dz made in shared memory,
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
from typing import NamedTuple

import torch

from distributed_tensorflow_tpu_torch.ops.pointwise_conv import (
    check_operands,
    one_wave_rows,
    rows_per_split,
    sm_count,
)

_MAX_KN = 4096
_TILE_BYTES = 2 * 1024 * 1024
# Blocks to aim for in the fp32 dW kernel's split pass on the H100's 132
# SMs: two waves of its product blocks (whose f32 partials cost a write and
# a read of [splits, K, N] each).
_DW_BLOCKS = 264
# The reduce kernel (csrc/fused_conv_bn.cu `bn_reduce_kernel_sm90`): rows
# of its boxes, and its blocks an SM (three stages of two 16 KB boxes).
_RED_BOX_ROWS = 128
_RED_BLOCKS_PER_SM = 2
# The bf16 dx kernels: the strip kernel keeps dz of up to this many
# columns of N in shared memory.
_DX_STRIP_MAX_N = 512
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
    beta, s1/M, s2/M (zero when not given: the card's reduce writes them),
    two zero rows. Two launches and few host operations: it runs once a
    unit on the step's path."""
    rows = [mu, inv, gamma, beta] if c1 is None else [mu, inv, gamma, beta, c1, c2]
    out = torch.zeros((8, mu.shape[0]), dtype=torch.float32, device=mu.device)
    torch.stack([r if r.dtype == torch.float32 else r.float() for r in rows],
                out=out[:len(rows)])
    return out


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


def reduce_plan(m: int, n: int, fp32: bool, sms: int) -> tuple[int, int]:
    """``(columns, rows)`` of a block of the reduce kernel: a strip of 128
    bytes of columns (64 bf16, 32 fp32) and M ranges of whole 128-row boxes,
    as many as fill one wave of ``sms`` SMs at two blocks each with the
    shape's strips (one range where the strips alone fill it)."""
    cols = 32 if fp32 else 64
    strips = -(-n // cols)
    boxes = -(-m // _RED_BOX_ROWS)
    splits = max(1, min(boxes, _RED_BLOCKS_PER_SM * sms // strips))
    return cols, -(-boxes // splits) * _RED_BOX_ROWS


class DxPlan(NamedTuple):
    """The bf16 dx kernel for a shape and its tiles: ``rows`` of M by
    ``k_cols`` of K each."""

    kernel: str  # "strip" or "panel"
    rows: int
    k_cols: int


def dx_plan(m: int, k: int, n: int, sms: int) -> DxPlan:
    """The bf16 dx kernel and its tiles for an ``[M, N] x [K, N]^T`` shape.

    N <= 512: the strip kernel. A tile is 128 rows of M and a group of
    128-column K tiles; the block makes the tile's dz (all of N) once and
    walks the group's K tiles over it. The group is the one whose tiles
    take the least time over ``sms`` SMs, counted as rounds of tiles times
    a tile's K tiles plus one for its dz phase; a tie keeps the longer
    group (dz made fewer times). On the H100 this picked the fastest group
    at each of ResNet-50's and Inception-v3's strip shapes: all of K where
    the strips fill the SMs many times over, two groups on Inception-v3's
    17x17 grid (289 strips: 5 rounds of 3 K tiles, not 3 of 6) and where M
    is small (6272 or 8192 rows: 49 or 64 strips), three at 3200 rows.

    N > 512: the panel kernel, 64 rows by 256 columns of K where K <= 256,
    else 512: a block keeps the tile's dx in registers and makes each chunk
    of dz once for it (``ceil(K / k_cols)`` times in all)."""
    if n > _DX_STRIP_MAX_N:
        return DxPlan("panel", 64, 256 if k <= 256 else 512)
    strips, k_tiles = -(-m // 128), -(-k // 128)

    def cost(per: int) -> tuple[int, int]:
        rounds = -(-strips * -(-k_tiles // per) // sms)
        return rounds * (per + 1), -per

    return DxPlan("strip", 128, 128 * min(range(1, k_tiles + 1), key=cost))


def _library():
    """The kernel library, built and bound on the first call and cached."""
    if not _LIBS:
        from distributed_tensorflow_tpu_torch.ops.build import LIBRARIES, load_libraries

        lib = load_libraries({"fused_conv_bn": LIBRARIES["fused_conv_bn"]})["fused_conv_bn"]
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(i)
        for fn, argtypes in (
            ("bn_bwd_reduce", [p] * 7 + [i] * 6 + [p]),
            ("bn_bwd_apply_dx", [p] * 5 + [i] * 7 + [p]),
            ("bn_bwd_apply_dw", [p] * 6 + [i] * 7 + [p]),
            ("fused_conv_bn_occupancy", [i, ip, ip]),
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
    kernels, as the card's occupancy calculator reports them: ``{name:
    (smem, blocks)}`` for the dW kernel (256-row tiles), the dx strip
    kernel up to N = 256 and 512, the dx panel kernel at 256 and 512
    columns of K, and the reduce."""
    lib = _library()
    out = {}
    for which, name in enumerate(("bn_bwd_apply_dw", "bn_bwd_apply_dx_strip_256",
                                  "bn_bwd_apply_dx_strip_512", "bn_bwd_apply_dx_panel_256",
                                  "bn_bwd_apply_dx_panel_512", "bn_bwd_reduce")):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.fused_conv_bn_occupancy(which, ctypes.byref(smem), ctypes.byref(blocks))
        if rc != 0:
            msg = lib.fused_conv_bn_error_string(rc).decode()
            raise RuntimeError(f"fused_conv_bn_occupancy({name}) failed: {msg}")
        out[name] = (smem.value, blocks.value)
    return out


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
            or consts.get_device() != tensors["da"].get_device() or not consts.is_contiguous()):
        raise ValueError(f"{fn}: consts must be contiguous f32 [8, {n}] on da's device")
    return dtype


def _launch(lib, fn: str, *args) -> None:
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.fused_conv_bn_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg}")
    LAUNCHES[fn] += 1


# Per device: the reduce kernel's tickets, one per column strip (N up to
# 32768 fp32), zero between launches (each launch leaves them so). One
# stream at a time may run the reduce on a device.
_TICKETS: dict = {}
_N_TICKETS = 1024


def _tickets(device: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(_N_TICKETS, dtype=torch.int32, device=device)
    return t


def bn_bwd_reduce_cuda(da2, z2, consts, relu: bool, *, write_consts: bool = False):
    """Launch the reduce kernel: ``(s1, s2)`` f32 ``[N]``, summed over M in
    the launch in a fixed order (two runs give the same bits). With
    ``write_consts`` it also writes ``s1 / M`` and ``s2 / M`` into rows 4-5
    of ``consts``, as the CPU path's division gives them, for the apply
    kernels."""
    dtype = _check("bn_bwd_reduce_cuda", {"da": da2, "z": z2}, consts)
    m, n = da2.shape
    fp32 = dtype == torch.float32
    device = da2.get_device()
    cols, rows = reduce_plan(m, n, fp32, sm_count(device))
    strips, splits = -(-n // cols), -(-m // rows)
    part = torch.empty((strips, splits, 2, cols), dtype=torch.float32, device=device)
    s12 = torch.empty((2, n), dtype=torch.float32, device=device)
    _launch(_library(), "bn_bwd_reduce", da2.data_ptr(), z2.data_ptr(), consts.data_ptr(),
            part.data_ptr(), s12.data_ptr(), consts.data_ptr() if write_consts else None,
            _tickets(device).data_ptr(), _N_TICKETS, m, n, rows, int(fp32), int(relu),
            torch.cuda.current_stream(device).cuda_stream)
    return s12[0], s12[1]


def bn_bwd_apply_dx_cuda(da2, z2, w2, consts, relu: bool):
    """Launch the dx kernel of the apply pass: ``[M, K]`` in dA's dtype
    (bf16: the strip or panel kernel, by :func:`dx_plan`)."""
    dtype = _check("bn_bwd_apply_dx_cuda", {"da": da2, "z": z2, "w": w2}, consts)
    m, n = da2.shape
    k = w2.shape[0]
    if w2.shape[1] != n:
        raise ValueError(f"bn_bwd_apply_dx_cuda: w {tuple(w2.shape)} is not [K, {n}]")
    device = da2.get_device()
    dx = torch.empty((m, k), dtype=dtype, device=device)
    plan = dx_plan(m, k, n, sm_count(device))
    _launch(_library(), "bn_bwd_apply_dx", da2.data_ptr(), z2.data_ptr(), w2.data_ptr(),
            consts.data_ptr(), dx.data_ptr(), m, k, n, int(plan.kernel == "strip"),
            plan.k_cols, int(dtype == torch.float32), int(relu),
            torch.cuda.current_stream(device).cuda_stream)
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
        # The reduce fills rows 4-5 of consts; nothing runs between it and
        # the apply kernels.
        da2, z2, x2, w2 = (t.contiguous() for t in (da2, z2, x2, w2))
        s1, s2 = bn_bwd_reduce_cuda(da2, z2, consts, relu, write_consts=True)
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
