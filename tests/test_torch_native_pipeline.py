"""Port parity: the host C++ input pipeline against the JAX package's.

The port builds its own copy of the pipeline (``csrc/data_pipeline.cpp``,
g++ into ``build/host/``); for the same dataset and arguments every batch
must hold the same bytes as the JAX package's ``NativePipeline`` — float32
exactly, bfloat16 as the same bit patterns (round to nearest even, as
``ml_dtypes``). Datasets are seeded numpy arrays of at most 24x24 pixels.
"""

from __future__ import annotations

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import loader as jloader
from distributed_tensorflow_tpu.data.native import NativePipeline as JNativePipeline
from distributed_tensorflow_tpu.data.readers import IMAGENET_MEAN, IMAGENET_STD
from distributed_tensorflow_tpu.parallel.mesh import build_mesh
from distributed_tensorflow_tpu_torch.data.loader import native_device_batches
from distributed_tensorflow_tpu_torch.data.native import NativePipeline
from distributed_tensorflow_tpu_torch.data.synthetic import SyntheticClassification


def _f32(n=40, hw=(12, 12), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, *hw, 3)).astype(np.float32) * 3 + 1,
            rng.integers(0, 10, n).astype(np.int32))


def _u8(n=24, hw=(20, 20), seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
            rng.integers(0, 1000, n).astype(np.int32))


CASES = {
    # CIFAR: pad-crop + flip + per-image standardization, f32 source.
    "cifar_f32": (_f32, dict(batch=8, pad=4, flip=True, standardize=True, seed=3)),
    # ImageNet: u8 source, random-resized crop + flip + mean/std, smaller output.
    "imagenet_u8_rrc": (_u8, dict(batch=6, out_size=(12, 12), rrc=True, flip=True,
                                  mean=IMAGENET_MEAN, stddev=IMAGENET_STD, seed=5)),
    # Center crop with RRC off (a non-square source).
    "center_crop": (lambda: _u8(16, (20, 16)), dict(batch=4, out_size=(12, 12), seed=2)),
}


def _take(pipe, n):
    out = [pipe.next() for _ in range(n)]
    pipe.close()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_jax_bit_for_bit(case):
    """Seven batches (past an epoch boundary), the port at 1 and 3 worker
    threads against the JAX package's at 4."""
    make, kw = CASES[case]
    images, labels = make()
    want = _take(JNativePipeline(images, labels, n_threads=4, **kw), 7)
    for n_threads in (1, 3):
        got = _take(NativePipeline(images, labels, n_threads=n_threads, **kw), 7)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.dtype == torch.float32 and gl.dtype == torch.int32
            np.testing.assert_array_equal(gi.numpy(), wi)
            np.testing.assert_array_equal(gl.numpy(), wl)


def test_start_ticket_resumes_the_stream():
    images, labels = _u8()
    kw = dict(batch=6, out_size=(12, 12), rrc=True, flip=True, seed=9)
    want = _take(JNativePipeline(images, labels, **kw), 7)
    got = _take(NativePipeline(images, labels, start_ticket=3, **kw), 4)
    for (gi, gl), (wi, wl) in zip(got, want[3:]):
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)


def test_two_ranks_tile_the_epoch_as_jax_does():
    """stream_offset = rank * 4, stride 8: each rank equals JAX's rank, and
    one epoch (5 global batches of 40 examples) reads every example once."""
    images, labels = _f32()
    labels = np.arange(40, dtype=np.int32)  # label = example index
    seen = []
    for rank in (0, 1):
        kw = dict(batch=4, stream_offset=rank * 4, stream_stride=8, flip=True, seed=4)
        want = _take(JNativePipeline(images, labels, **kw), 5)
        got = _take(NativePipeline(images, labels, **kw), 5)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi.numpy(), wi)
            np.testing.assert_array_equal(gl.numpy(), wl)
            seen += gl.tolist()
    assert sorted(seen) == list(range(40))


def test_bfloat16_output_rounds_as_ml_dtypes():
    images, labels = _u8()
    kw = dict(batch=6, out_size=(12, 12), rrc=True, mean=IMAGENET_MEAN,
              stddev=IMAGENET_STD, seed=1, out_dtype="bfloat16")
    want = _take(JNativePipeline(images, labels, **kw), 3)
    got = _take(NativePipeline(images, labels, **kw), 3)
    for (gi, _), (wi, _) in zip(got, want):
        assert gi.dtype == torch.bfloat16 and wi.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(gi.view(torch.int16).numpy(), wi.view(np.int16))


def test_next_after_close_raises():
    images, labels = _f32()
    p = NativePipeline(images, labels, batch=8)
    p.next()
    p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.next()
    with pytest.raises(ValueError, match="contiguous CPU"):
        NativePipeline(images, labels, batch=8).next_into(
            torch.empty(8, 12, 12, 3, dtype=torch.bfloat16), torch.empty(8, dtype=torch.int32))


def test_native_device_batches_equal_jax_on_the_cpu():
    """The producer (this process's rows, resumed at start_step 2) against
    the JAX producer on a one-device mesh."""
    images, labels = _u8()
    ds = SyntheticClassification(images=images, labels=labels)
    kw = dict(out_size=(12, 12), rrc=True, flip=True, mean=IMAGENET_MEAN,
              stddev=IMAGENET_STD, seed=6, start_step=2)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    ref = jloader.native_device_batches(ds, mesh, 8, **kw)
    got = native_device_batches(ds, 8, device="cpu", **kw)
    for _ in range(3):
        w, g = next(ref), next(got)
        for k in ("image", "label"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    ref.close()
    got.close()
