"""Host -> device image batches (port of ``data/loader.py``).

Both producers are **stream-position indexed**: batch ``k`` of a run is a
pure function of ``(seed, k)``, so a checkpoint-restored run passes
``start_step=N`` and consumes batches ``N, N+1, ...``. Under several
processes every rank takes its own contiguous slice of each global batch
(:func:`..parallel.mesh.process_rows`, the JAX package's per-process
slice); one process takes it all.

- :func:`device_batches`, the numpy feed: each epoch reshuffles with the
  permutation ``np.random.default_rng(seed + epoch)`` of the JAX package,
  so both packages draw the same rows in the same order; center crop and
  per-channel normalisation, no augmentation.
- :func:`native_device_batches`, the host C++ pipeline
  (:mod:`.native`): augmentation on a worker pool, batches bit for bit the
  JAX package's ``native_device_batches``.

Assembly runs inline in ``next()``; wrap either in
:func:`~.prefetch.prefetch` to move it off the step's critical path.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.data.native import NativePipeline
from distributed_tensorflow_tpu_torch.data.synthetic import SyntheticClassification
from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.parallel.mesh import process_rows


def _center_crop(images: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    h, w = images.shape[1:3]
    oh, ow = out_hw
    y0, x0 = max(0, (h - oh) // 2), max(0, (w - ow) // 2)
    return images[:, y0 : y0 + oh, x0 : x0 + ow]


def device_batches(
    dataset: SyntheticClassification,
    global_batch: int,
    *,
    device="cuda",
    seed: int = 0,
    start_step: int = 0,
    out_size: tuple[int, int] | None = None,
    mean: np.ndarray | None = None,
    stddev: np.ndarray | None = None,
) -> Iterator[dict]:
    """Infinite iterator of ``{"image": f32 [b, H, W, C], "label": int32
    [b]}`` tensors on ``device`` (the card by default), ``b`` this
    process's rows of ``global_batch``.

    The tail examples that don't fill a global batch are dropped each
    epoch. uint8 datasets are scaled to [0, 1]; ``out_size`` center-crops;
    ``mean``/``stddev`` normalise per channel.
    """
    dev = resolve_device(device)
    n = len(dataset)
    if global_batch > n:
        raise ValueError(f"global batch {global_batch} > dataset size {n}")
    start, stop = process_rows(global_batch)
    batches_per_epoch = n // global_batch
    step = start_step
    epoch, order = -1, None
    while True:
        e, slot = divmod(step, batches_per_epoch)
        if e != epoch:
            epoch, order = e, np.random.default_rng(seed + e).permutation(n)
        lo = slot * global_batch
        idx = order[lo + start : lo + stop]
        images = dataset.images[idx]
        # Crop before the u8 -> f32 scale: the elementwise work then touches
        # only the pixels kept (the result is the same).
        if out_size is not None and images.shape[1:3] != tuple(out_size):
            images = _center_crop(images, out_size)
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        if mean is not None:
            images = (images - mean) / stddev
        yield {
            "image": torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev),
            "label": torch.from_numpy(np.ascontiguousarray(dataset.labels[idx])).to(dev),
        }
        step += 1


class native_device_batches:  # noqa: N801 — a producer, named as the JAX function
    """Like :func:`device_batches` but fed by the host C++ pipeline
    (:class:`.native.NativePipeline`): an infinite iterator of
    ``{"image", "label"}`` tensors on ``device``, this process's rows of
    ``global_batch``.

    Augmentation (pad-crop/flip/standardize, or random-resized-crop +
    per-channel normalization) and batch staging run in the C++ worker pool
    off the Python thread. Sampling is per-epoch permutation without
    replacement; every rank shares the epoch permutation (same seed) and
    reads its slice: ``stream_offset = rank * local_b``, ``stream_stride =
    global_batch``. ``start_step`` resumes the stream at batch N. A failed
    build of the host library raises here.

    On the card the pipeline writes each batch straight into one of
    ``staging`` pinned host buffers, the host->device copy is issued
    ``non_blocking`` on the feed's own stream, and a CUDA event recorded
    after it guards the buffer: it is written again only once that copy has
    completed. The step's stream waits on the copy before any later work,
    and the device tensors are marked as used there (``record_stream``).
    ``close()`` stops the worker pool.
    """

    def __init__(
        self,
        dataset: SyntheticClassification,
        global_batch: int,
        *,
        device="cuda",
        out_size: tuple[int, int] | None = None,
        pad: int = 0,
        flip: bool = False,
        standardize: bool = False,
        rrc: bool = False,
        mean: np.ndarray | None = None,
        stddev: np.ndarray | None = None,
        seed: int = 0,
        start_step: int = 0,
        n_threads: int = 4,
        out_dtype: str = "float32",
        staging: int = 4,
    ):
        self.device = resolve_device(device)
        if global_batch > len(dataset):
            raise ValueError(f"global batch {global_batch} > dataset size {len(dataset)}")
        if staging < 1:
            raise ValueError(f"staging must be >= 1, got {staging}")
        start, stop = process_rows(global_batch)
        self.pipeline = NativePipeline(
            dataset.images, dataset.labels, batch=stop - start, out_size=out_size,
            pad=pad, flip=flip, standardize=standardize, rrc=rrc, mean=mean,
            stddev=stddev, seed=seed, stream_offset=start, stream_stride=global_batch,
            start_ticket=start_step, n_threads=n_threads, out_dtype=out_dtype,
        )
        self._slots = []
        self._next_slot = 0
        if self.device.type == "cuda":
            # Made here, on the caller's thread: its current stream is the
            # one the steps run on, whichever thread later pulls batches.
            self._consumer = torch.cuda.current_stream(self.device)
            self._stream = torch.cuda.Stream(self.device)
            p = self.pipeline
            self._slots = [
                (torch.empty(p.shape, dtype=p.out_dtype, pin_memory=True),
                 torch.empty((p.batch,), dtype=torch.int32, pin_memory=True),
                 None)
                for _ in range(staging)
            ]

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self.device.type == "cpu":
            images, labels = self.pipeline.next()
            return {"image": images, "label": labels}
        i = self._next_slot
        self._next_slot = (i + 1) % len(self._slots)
        images, labels, copied = self._slots[i]
        if copied is not None:
            copied.synchronize()  # this buffer's last copy has left it
        self.pipeline.next_into(images, labels)
        with torch.cuda.stream(self._stream):
            batch = {"image": images.to(self.device, non_blocking=True),
                     "label": labels.to(self.device, non_blocking=True)}
            copied = torch.cuda.Event()
            copied.record(self._stream)
        self._slots[i] = (images, labels, copied)
        self._consumer.wait_event(copied)
        for t in batch.values():
            t.record_stream(self._consumer)
        return batch

    def close(self) -> None:
        self.pipeline.close()
        for _, _, copied in self._slots:
            if copied is not None:
                copied.synchronize()
