"""Host -> device image batches (port of ``data/loader.py``
``device_batches``).

The producer is **stream-position indexed**: batch ``k`` of a run is a pure
function of ``(seed, k)``, so a checkpoint-restored run passes
``start_step=N`` and consumes batches ``N, N+1, ...``. Each epoch reshuffles
with the permutation ``np.random.default_rng(seed + epoch)`` of the JAX
package, so both packages draw the same rows in the same order. Under
several processes every rank takes its own contiguous slice of each global
batch (:func:`..parallel.mesh.process_rows`, the JAX package's per-process
slice); one process takes it all.

The native C++ pipeline (augmentation on a worker pool) comes with a later
slice; this is the numpy feed the JAX package falls back to when that
library cannot be built. Assembly runs inline in ``next()``; wrap it in
:func:`~.prefetch.prefetch` to move it off the step's critical path.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

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
