"""1x1 convolution with hand-written backward kernels: the ResNet-50 hot path.

Port of ``distributed_tensorflow_tpu/ops/pointwise_conv.py``. Same
functions, signatures and results: the forward ``y = x2 @ w`` and, inside
the autograd Functions, the weight gradient ``dw = x2^T @ g`` stay plain
matrix products (``torch.matmul``; the JAX VJPs compute dW with a plain
dot on purpose), and the input gradient ``dx = g @ w^T`` is a kernel,
``csrc/pointwise_conv.cu``, behind a ``torch.autograd.Function`` in place
of the JAX ``custom_vjp``s.

The weight-gradient kernel of the JAX package (``_wgrad_pallas``) is
ported as :func:`wgrad`, also in ``csrc/pointwise_conv.cu``; like the JAX
one, only the standalone bench (``scripts/torch_pw_bench.py``) calls it.

Dispatch is by the tensors' device and nothing else: for CPU tensors the
plain versions (:func:`dgrad_reference`, :func:`wgrad_reference`), for CUDA
tensors the kernels (built at first use, see :mod:`.build`) or an
exception.

The JAX package flattened activations in H,W,B,C order and gave N = 64 a
kernel of its own in the ``[H*W, C, B]`` view: both were XLA:TPU layout
rules. An NHWC tensor flattens to ``[B*H*W, C]`` as a view, so the N = 64
route (:func:`pointwise_conv_n64`) launches the same kernel; only its
launch counter differs. ``_supported`` keeps the TPU's M tiling rule so
that the same units take the kernel as in the JAX package; the kernel
itself takes any M.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_MAX_TILE_M = 1024
_MAX_KN = 4096
# The bf16 wgrad kernel's geometry (csrc/pointwise_conv.cu): M rows per
# chunk of its copy ring, dW columns per block, and dW rows per block
# (64 where K <= 64, else 128).
_WGRAD_CHUNK = 64
_WGRAD_TILE_N = 128

#: Kernel launches since the last :func:`reset_launch_counts`; each wrapper
#: adds one where it launches its kernel and nowhere else.
LAUNCHES = {"pw_dgrad": 0, "pw_dgrad_n64": 0, "pw_wgrad": 0}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _tile_m(m: int) -> int | None:
    """Largest multiple-of-16 divisor of m, capped at _MAX_TILE_M."""
    for t in range(min(_MAX_TILE_M, m), 15, -16):
        if t % 16 == 0 and m % t == 0:
            return t
    return None


def _supported(m: int, k: int, n: int) -> bool:
    """The units that take the dgrad kernel in the JAX package: both
    channel counts in [128, 4096] and M a multiple of 16."""
    return _tile_m(m) is not None and 128 <= k <= _MAX_KN and 128 <= n <= _MAX_KN


def dgrad_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain dgrad: ``g [M, N] @ w [K, N]^T`` with f32 sums, in g's dtype."""
    return torch.matmul(g.float(), w.float().t()).to(g.dtype)


def wgrad_reference(x2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain wgrad: ``x2 [M, K]^T @ g [M, N]`` in f32, ``[K, N]``."""
    return x2.float().t() @ g.float()


def rows_per_split(m: int, tiles: int, target: int) -> int:
    """M rows per block of a split-M pass: enough splits that the pass has
    about ``target`` blocks with ``tiles`` blocks per split, at least 256
    rows each, a multiple of 32."""
    splits = max(1, min(-(-target // tiles), m // 256))
    rows = -(-m // splits)
    return -(-rows // 32) * 32


def wgrad_rows_per_split(m: int, k: int, n: int, sms: int) -> int:
    """M rows per block of the wgrad kernel, a multiple of its 64-row
    chunk: as many M ranges as fill one wave of ``sms`` blocks with the
    shape's dW tiles, and one range where the tiles alone fill the wave.
    More ranges would add waves and f32 partials without adding SMs."""
    tiles = -(-k // (64 if k <= 64 else 128)) * -(-n // _WGRAD_TILE_N)
    chunks = -(-m // _WGRAD_CHUNK)
    splits = min(chunks, max(1, sms // tiles))
    return -(-chunks // splits) * _WGRAD_CHUNK


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_LIBS: dict = {}


def _library():
    """The kernel library, built and bound on the first call and cached."""
    if not _LIBS:
        from distributed_tensorflow_tpu_torch.ops.build import LIBRARIES, load_libraries

        lib = load_libraries({"pointwise_conv": LIBRARIES["pointwise_conv"]})["pointwise_conv"]
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pw_dgrad.argtypes = [p] * 3 + [i] * 4 + [p]
        lib.pw_dgrad.restype = ctypes.c_int
        lib.pw_wgrad.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.pw_wgrad.restype = ctypes.c_int
        lib.pointwise_conv_occupancy.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.pointwise_conv_occupancy.restype = ctypes.c_int
        lib.pointwise_conv_error_string.argtypes = [ctypes.c_int]
        lib.pointwise_conv_error_string.restype = ctypes.c_char_p
        _LIBS["pointwise_conv"] = lib
    return _LIBS["pointwise_conv"]


def build() -> None:
    """Compile (or load the cached build of) the kernel library."""
    _library()


def occupancy() -> dict:
    """Dynamic shared memory (bytes) and resident blocks per SM of each
    bf16 kernel, as the card's occupancy calculator reports them:
    ``{"pw_dgrad": (smem, blocks), "pw_wgrad_128x128": ...,
    "pw_wgrad_64x128": ...}``, the wgrad kernel once per shape of its dW
    tile (rows x columns; 64 rows where K <= 64)."""
    lib = _library()
    out = {}
    for key, which in (("pw_dgrad", 0), ("pw_wgrad_128x128", 1), ("pw_wgrad_64x128", 2)):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.pointwise_conv_occupancy(which, ctypes.byref(smem), ctypes.byref(blocks))
        if rc != 0:
            msg = lib.pointwise_conv_error_string(rc).decode()
            raise RuntimeError(f"pointwise_conv_occupancy({which}) failed: {msg}")
        out[key] = (smem.value, blocks.value)
    return out


def check_operands(fn: str, tensors: dict) -> torch.dtype:
    """Raise unless every tensor is a contiguous, 16-byte aligned 2-D bf16
    or fp32 tensor of one dtype on one CUDA device whose last dim is a
    multiple of 8; returns the dtype."""
    first = next(iter(tensors.values()))
    if not all(x.is_cuda and x.device == first.device for x in tensors.values()):
        raise ValueError(f"{fn}: {', '.join(tensors)} must be on one CUDA device")
    if first.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: dtype {first.dtype} not in (bfloat16, float32)")
    for name, x in tensors.items():
        if x.dtype != first.dtype:
            raise TypeError(f"{fn}: {', '.join(tensors)} must share one dtype")
        if x.dim() != 2 or x.shape[1] % 8:
            raise ValueError(f"{fn}: {name} must be 2-D with a multiple of 8 columns, "
                             f"got {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    return first.dtype


def dgrad_cuda(g: torch.Tensor, w: torch.Tensor, route: str = "pw_dgrad") -> torch.Tensor:
    """Launch the dgrad kernel for contiguous ``g [M, N]`` and ``w [K, N]``
    (bf16 or fp32, N and K multiples of 8) on one CUDA device; ``route``
    names the launch counter (``pw_dgrad`` or ``pw_dgrad_n64``)."""
    dtype = check_operands("dgrad_cuda", {"g": g, "w": w})
    (m, n), k = g.shape, w.shape[0]
    if w.shape[1] != n:
        raise ValueError(f"dgrad_cuda: g {tuple(g.shape)} and w {tuple(w.shape)} disagree on N")
    lib = _library()
    dx = torch.empty((m, k), dtype=dtype, device=g.device)
    rc = lib.pw_dgrad(g.data_ptr(), w.data_ptr(), dx.data_ptr(), m, k, n,
                      int(dtype == torch.float32),
                      torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        msg = lib.pointwise_conv_error_string(rc).decode()
        raise RuntimeError(f"pw_dgrad launch failed: {msg}")
    LAUNCHES[route] += 1
    return dx


def wgrad_cuda(x2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the wgrad kernel for contiguous ``x2 [M, K]`` and ``g [M, N]``
    (bf16 or fp32, K and N multiples of 8, any M) on one CUDA device:
    ``dW [K, N]`` in f32, the partials over the M ranges that
    :func:`wgrad_rows_per_split` chooses summed by the kernel's second
    pass."""
    dtype = check_operands("wgrad_cuda", {"x2": x2, "g": g})
    (m, k), n = x2.shape, g.shape[1]
    if g.shape[0] != m:
        raise ValueError(f"wgrad_cuda: x2 {tuple(x2.shape)} and g {tuple(g.shape)} disagree on M")
    lib = _library()
    rows = wgrad_rows_per_split(m, k, n, _sm_count(x2.device))
    splits = -(-m // rows)
    dw = torch.empty((k, n), dtype=torch.float32, device=x2.device)
    part = (torch.empty((splits, k, n), dtype=torch.float32, device=x2.device)
            if splits > 1 else None)
    rc = lib.pw_wgrad(x2.data_ptr(), g.data_ptr(), 0 if part is None else part.data_ptr(),
                      dw.data_ptr(), m, k, n, rows, int(dtype == torch.float32),
                      torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        msg = lib.pointwise_conv_error_string(rc).decode()
        raise RuntimeError(f"pw_wgrad launch failed: {msg}")
    LAUNCHES["pw_wgrad"] += 1
    return dw


def wgrad(x2: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``_wgrad_pallas``'s counterpart: ``dW = x2^T @ g`` in f32 for
    ``x2 [M, K]`` and ``g [M, N]``. The kernel for CUDA tensors, the plain
    version for CPU ones."""
    if x2.is_cuda:
        return wgrad_cuda(x2.contiguous(), g.contiguous())
    if x2.device.type != "cpu":
        raise ValueError(f"pointwise wgrad runs on cuda or cpu, not {x2.device}")
    return wgrad_reference(x2, g)


def _dgrad(g: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """Device dispatch: the kernel for CUDA tensors, the plain version for
    CPU ones."""
    if g.is_cuda:
        return dgrad_cuda(g.contiguous(), w.contiguous(), route)
    if g.device.type != "cpu":
        raise ValueError(f"pointwise dgrad runs on cuda or cpu, not {g.device}")
    return dgrad_reference(g, w)


class _PwMatmul(torch.autograd.Function):
    """``x2 @ w`` with the dgrad kernel in its backward (``_pw_matmul``); dW
    stays a plain product, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.matmul(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = _dgrad(g, w, "pw_dgrad")
        dw = torch.matmul(x2.t(), g)
        return dx.to(x2.dtype), dw.to(w.dtype)


def pointwise_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2 @ w`` with the dgrad kernel when the JAX package's routing
    allows (:func:`_supported`), else a plain product. x2: [M, K]; w: [K, N]."""
    m, k = x2.shape
    n = w.shape[1]
    if not _supported(m, k, n):
        return torch.matmul(x2, w)
    return _PwMatmul.apply(x2, w)


class _Pw4dN64(torch.autograd.Function):
    """``[B, H, W, K] -> [B, H, W, N]`` 1x1 conv with the N = 64 dgrad
    route (``_pw4d_n64``): dx4 in g's dtype, dw in w's dtype."""

    @staticmethod
    def forward(ctx, x4, w):
        ctx.save_for_backward(x4, w)
        b, h, w_, k = x4.shape
        return torch.matmul(x4.reshape(b * h * w_, k), w).reshape(b, h, w_, w.shape[1])

    @staticmethod
    def backward(ctx, g4):
        x4, w = ctx.saved_tensors
        n = g4.shape[-1]
        g2 = g4.reshape(-1, n)
        dx4 = _dgrad(g2, w, "pw_dgrad_n64").reshape(x4.shape)
        dw = torch.matmul(x4.reshape(-1, x4.shape[-1]).t(), g2)
        return dx4, dw.to(w.dtype)


def pointwise_conv_n64(x4: torch.Tensor, kernel2: torch.Tensor) -> torch.Tensor:
    """1x1 conv to 64 features with the N = 64 dgrad route."""
    return _Pw4dN64.apply(x4, kernel2)


def pointwise_conv(x: torch.Tensor, kernel: torch.Tensor, strides: int = 1) -> torch.Tensor:
    """NHWC 1x1 convolution with the dgrad kernel in its backward.

    x: ``[B, H, W, Cin]``; kernel: ``[1, 1, Cin, Cout]`` (or ``[Cin, Cout]``).
    A strided 1x1 conv reads only the top-left pixel of each window, so
    stride s is a spatial slice before the product.
    """
    if kernel.dim() == 4:
        kernel = kernel[0, 0]
    if strides > 1:
        x = x[:, ::strides, ::strides, :]
    b, h, w_, cin = x.shape
    y = pointwise_matmul(x.reshape(b * h * w_, cin), kernel)
    return y.reshape(b, h, w_, kernel.shape[1])
