"""ctypes bindings for the port's host C++ input pipeline (port of
``data/native.py``).

A pthread worker pool in ``csrc/data_pipeline.cpp`` (the port's own copy of
the JAX package's C++ pipeline) samples a per-epoch
permutation (without replacement, via an O(1) Feistel index permutation),
augments (pad-crop / flip / per-image standardization for CIFAR;
random-resized-crop + per-channel normalization for ImageNet), and stages
batches in a bounded ring — deterministic by construction (per-ticket RNG,
in-order staging). For the same arguments its batches are bit for bit the
JAX package's.

The library is built with ``g++`` at first use into ``build/host/``
(:func:`..ops.build.load_host_library`). A failed build raises with the
compiler's output: unlike the JAX package, nothing here falls back to the
numpy feed, which would train on other batches; a caller that wants the
numpy feed asks for it (``cli.train --no-native-input``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.ops import build

_SOURCES = ["data_pipeline.cpp"]
_BIND_LOCK = threading.Lock()
_bound: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (once, cached by content) and bind the host library."""
    global _bound
    lib = build.load_host_library("data_pipeline", _SOURCES)
    with _BIND_LOCK:
        if _bound is lib:
            return lib
        lib.dp_create.restype = ctypes.c_void_p
        lib.dp_create.argtypes = [
            ctypes.c_void_p,  # images
            ctypes.c_void_p,  # labels
            ctypes.c_int64,   # n
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # h, w, c
            ctypes.c_int, ctypes.c_int,  # out_h, out_w
            ctypes.c_int,     # batch
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # pad, flip, standardize
            ctypes.c_int, ctypes.c_float,  # rrc, rrc_min_area
            ctypes.c_int,     # src_u8
            ctypes.c_void_p, ctypes.c_void_p,  # mean, stddev
            ctypes.c_uint64,  # seed
            ctypes.c_uint64, ctypes.c_uint64,  # stream_offset, stream_stride
            ctypes.c_uint64,  # start_ticket
            ctypes.c_int, ctypes.c_int,  # n_threads, queue_cap
        ]
        lib.dp_next.restype = ctypes.c_int
        lib.dp_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int]
        lib.dp_destroy.restype = None
        lib.dp_destroy.argtypes = [ctypes.c_void_p]
        lib.dp_crc32c.restype = ctypes.c_uint32
        lib.dp_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32]
        _bound = lib
    return lib


def native_available() -> bool:
    """Whether the host library builds and loads here. The port's feeds do
    not use this to pick a fallback; a failed build raises where the
    pipeline is made."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return load_library().dp_crc32c(data, len(data), crc)


def resolve_input_dtype(name) -> torch.dtype:
    """Normalize an input-batch dtype knob to a torch dtype: float32 or
    bfloat16 (narrower images lose augmentation precision for no transfer
    gain)."""
    s = str(name).lower().removeprefix("torch.")
    if s in ("bfloat16", "bf16"):
        return torch.bfloat16
    if s in ("float32", "f32", "fp32"):
        return torch.float32
    raise ValueError(f"input dtype {name!r} not supported: pick float32 or bfloat16")


class NativePipeline:
    """Threaded batch producer over an in-memory (or memory-mapped) dataset.

    :meth:`next` returns ``(images [B, out_H, out_W, C], labels [B] int32)``
    as new CPU tensors; :meth:`next_into` writes the next batch into tensors
    the caller owns (pinned staging buffers on the card's path), so nothing
    is copied twice. Deterministic for a fixed ``seed`` whatever
    ``n_threads``. Sampling is per-epoch permutation without replacement;
    ``start_ticket`` resumes the stream at batch N.

    ``images`` may be float32 or uint8 (uint8 pixels are scaled by 1/255 —
    pass an ``np.memmap`` for datasets that don't fit RAM). When
    ``out_size != (H, W)`` or ``rrc=True``, images are (random-resized-)
    cropped and bilinearly resampled to ``out_size``.

    Several processes: pass ``stream_offset = rank * batch`` and
    ``stream_stride = world * batch`` with the SAME seed everywhere — the
    ranks then share each epoch's permutation and read disjoint slices.

    ``out_dtype="bfloat16"`` rounds the staged float32 batch to bfloat16
    (nearest even) as it is copied out; augmentation keeps full precision.
    ``close()`` (or leaving the ``with`` block) unblocks a thread waiting in
    ``next()``, which then raises instead of returning garbage.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch: int,
        *,
        out_size: tuple[int, int] | None = None,
        pad: int = 0,
        flip: bool = False,
        standardize: bool = False,
        rrc: bool = False,
        rrc_min_area: float = 0.08,
        mean: np.ndarray | None = None,
        stddev: np.ndarray | None = None,
        seed: int = 0,
        stream_offset: int = 0,
        stream_stride: int = 0,
        start_ticket: int = 0,
        n_threads: int = 4,
        queue_cap: int = 8,
        out_dtype: str = "float32",
    ):
        self._handle = None
        self.out_dtype = resolve_input_dtype(out_dtype)
        lib = load_library()
        # Own contiguous arrays: the C++ side keeps raw pointers to these.
        # uint8 sources stay uint8 (memmaps pass through without being
        # read), anything else becomes float32.
        if images.ndim != 4:
            raise ValueError(f"images must be [N, H, W, C], got {images.shape}")
        if images.dtype == np.uint8:
            self._images = images if images.flags["C_CONTIGUOUS"] else np.ascontiguousarray(images)
            src_u8 = 1
        else:
            self._images = np.ascontiguousarray(images, np.float32)
            src_u8 = 0
        self._labels = np.ascontiguousarray(labels, np.int32)
        n, h, w, c = self._images.shape
        if len(self._labels) != n:
            raise ValueError(f"{n} images vs {len(self._labels)} labels")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        oh, ow = out_size if out_size is not None else (h, w)
        self.shape = (batch, oh, ow, c)
        self.batch = batch
        self._lib = lib
        self._mean = np.ascontiguousarray(mean, np.float32) if mean is not None else None
        self._std = np.ascontiguousarray(stddev, np.float32) if stddev is not None else None
        if (self._mean is None) != (self._std is None):
            raise ValueError("mean and stddev must be given together")
        for name, v in (("mean", self._mean), ("stddev", self._std)):
            if v is not None and v.shape != (c,):
                raise ValueError(f"{name} must have one value per channel ({c}), got {v.shape}")
        self._handle = lib.dp_create(
            self._images.ctypes.data_as(ctypes.c_void_p),
            self._labels.ctypes.data_as(ctypes.c_void_p),
            n, h, w, c, oh, ow, batch,
            pad, int(flip), int(standardize),
            int(rrc), float(rrc_min_area), src_u8,
            self._mean.ctypes.data_as(ctypes.c_void_p) if self._mean is not None else None,
            self._std.ctypes.data_as(ctypes.c_void_p) if self._std is not None else None,
            seed, stream_offset, stream_stride, start_ticket,
            n_threads, queue_cap,
        )

    def next_into(self, images: torch.Tensor, labels: torch.Tensor) -> None:
        """Write the next batch into ``images`` (``self.shape``, ``out_dtype``)
        and ``labels`` (``[batch]`` int32), contiguous CPU tensors."""
        if self._handle is None:
            raise RuntimeError("pipeline is closed")
        for t, shape, dtype in ((images, self.shape, self.out_dtype),
                                (labels, (self.batch,), torch.int32)):
            if (t.device.type != "cpu" or tuple(t.shape) != shape or t.dtype != dtype
                    or not t.is_contiguous()):
                raise ValueError(f"output must be a contiguous CPU {dtype} tensor of "
                                 f"shape {shape}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
        ok = self._lib.dp_next(self._handle, images.data_ptr(), labels.data_ptr(),
                               int(self.out_dtype == torch.bfloat16))
        if not ok:
            # Racing close()/destruction: never hand back uninitialized
            # buffers as if they were data.
            raise RuntimeError("pipeline stopped while waiting for a batch")

    def next(self) -> tuple[torch.Tensor, torch.Tensor]:
        images = torch.empty(self.shape, dtype=self.out_dtype)
        labels = torch.empty((self.batch,), dtype=torch.int32)
        self.next_into(images, labels)
        return images, labels

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
