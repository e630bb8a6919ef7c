"""Port parity: the dataset readers against the JAX package's, on tiny
files the tests write (no downloads).

MNIST idx (plain and ``.gz``) and CIFAR-10 pickles load to the same arrays;
a PNG class tree and TFRecord shards prepare to byte-identical u8 caches.
The port reads TFRecords without TensorFlow (its framing and ``tf.Example``
parsed in Python, both CRC-32Cs checked): the shards are written here with
``tf.io.TFRecordWriter``, and the port prepares them with ``tensorflow``
made unimportable, so an import of it anywhere on that path would fail.
Images are at most 36x36 pixels.
"""

from __future__ import annotations

import gzip
import io
import logging
import pickle
import struct
import sys
from unittest import mock

import numpy as np
import pytest

from distributed_tensorflow_tpu.data import readers as jreaders
from distributed_tensorflow_tpu_torch.data import readers
from distributed_tensorflow_tpu_torch.data.native import crc32c


def _write_mnist(tmp, n=12, gz=False, prefix="train"):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, 28, 28), np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    op, suffix = (gzip.open, ".gz") if gz else (open, "")
    with op(tmp / f"{prefix}-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with op(tmp / f"{prefix}-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _assert_same(got, want):
    assert got.images.dtype == want.images.dtype and got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(np.asarray(got.images), np.asarray(want.images))
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("gz", [False, True], ids=["idx", "idx_gz"])
def test_mnist_equals_jax(tmp_path, gz):
    _write_mnist(tmp_path, gz=gz)
    _write_mnist(tmp_path, n=5, gz=gz, prefix="t10k")
    for split in ("train", "test"):
        _assert_same(readers.load_mnist(tmp_path, split), jreaders.load_mnist(tmp_path, split))
    (tmp_path / f"train-images-idx3-ubyte{'.gz' if gz else ''}").unlink()
    with pytest.raises(FileNotFoundError):
        readers.load_mnist(tmp_path)


def test_cifar10_pickles_equal_jax(tmp_path):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with (base / name).open("wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3 * 32 * 32), np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, f)
    for split in ("train", "test"):
        got = readers.load_cifar10(tmp_path, split)
        assert got.images.shape == ((15 if split == "train" else 3), 32, 32, 3)
        _assert_same(got, jreaders.load_cifar10(tmp_path, split))


def _png_tree(root, classes=("cat", "dog", "emu"), per_class=3):
    from PIL import Image

    rng = np.random.default_rng(3)
    for i, cls in enumerate(classes):
        (root / cls).mkdir(parents=True)
        for j in range(per_class):
            hw = (30 + 2 * j, 36 - 3 * i)  # not square, not the cache size
            Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(
                root / cls / f"{j}.png")
    # "_"-prefixed directories are caches, never classes.
    (root / "_notes").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "_notes" / "x.png")


def _cache_bytes(cache):
    return {p.name: p.read_bytes() for p in sorted(cache.iterdir())}


def test_png_class_tree_prepares_the_jax_cache(tmp_path):
    _png_tree(tmp_path / "train")
    got = readers.prepare_imagefolder(tmp_path / "train", tmp_path / "port", size=24)
    want = jreaders.prepare_imagefolder(tmp_path / "train", tmp_path / "jax", size=24)
    assert _cache_bytes(got) == _cache_bytes(want)
    assert (got / "classes.txt").read_text().split() == ["cat", "dog", "emu"]
    # load_imagefolder prepares _cache_train_24 on first use, then maps it.
    ds = readers.load_imagefolder(tmp_path, "train", size=24)
    assert isinstance(ds.images, np.memmap) and ds.images.shape == (9, 24, 24, 3)
    _assert_same(ds, jreaders.load_imagefolder(tmp_path, "train", size=24))
    with pytest.raises(FileNotFoundError, match="'val' split"):
        readers.load_imagefolder(tmp_path, "val", size=24)


def _write_shard(tf, path, labels, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    with tf.io.TFRecordWriter(str(path)) as w:
        for label in labels:
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (36, 30, 3), np.uint8)).save(buf, "JPEG")
            feature = {
                "image/encoded": tf.train.Feature(
                    bytes_list=tf.train.BytesList(value=[buf.getvalue()])),
                "image/class/label": tf.train.Feature(
                    int64_list=tf.train.Int64List(value=[label])),
                "image/format": tf.train.Feature(
                    bytes_list=tf.train.BytesList(value=[b"JPEG"])),
            }
            ex = tf.train.Example(features=tf.train.Features(feature=feature))
            w.write(ex.SerializeToString())


def test_tfrecords_prepare_the_jax_cache_without_tensorflow(tmp_path):
    import tensorflow as tf

    src = tmp_path / "train"
    src.mkdir()
    shards = [src / "train-00000-of-00002", src / "train-00001-of-00002"]
    _write_shard(tf, shards[0], [1, 2, 3], seed=4)
    _write_shard(tf, shards[1], [4, 1000], seed=5)
    (src / "train_stats.json").write_text("{}")  # not a shard: never parsed
    with mock.patch.dict(sys.modules, {"tensorflow": None}):
        got = {off: readers.prepare_tfrecords(shards, tmp_path / f"port{off}", size=24,
                                              label_offset=off) for off in (0, 1)}
        ds = readers.load_imagefolder(tmp_path, "train", size=24)  # via shard_re
        with pytest.raises(ValueError, match="negative"):
            readers.prepare_tfrecords(shards, tmp_path / "neg", size=24, label_offset=2)
    for off, cache in got.items():
        want = jreaders.prepare_tfrecords(shards, tmp_path / f"jax{off}", size=24,
                                          label_offset=off)
        assert _cache_bytes(cache) == _cache_bytes(want)
    np.testing.assert_array_equal(np.load(got[1] / "labels.npy"), [0, 1, 2, 3, 999])
    np.testing.assert_array_equal(ds.labels, [1, 2, 3, 4, 1000])
    with pytest.raises(ValueError, match="negative"):
        jreaders.prepare_tfrecords(shards, tmp_path / "jneg", size=24, label_offset=2)

    # One flipped payload byte fails the payload's CRC.
    raw = bytearray(shards[1].read_bytes())
    raw[12 + 40] ^= 0x01
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="payload.*CRC-32C"):
        readers.prepare_tfrecords([bad], tmp_path / "bad", size=24)


def test_crc32c_against_a_bitwise_reference():
    def reference(data: bytes) -> int:
        crc = 0xFFFFFFFF
        for b in data:
            crc ^= b
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
        return crc ^ 0xFFFFFFFF

    rng = np.random.default_rng(7)
    assert crc32c(b"123456789") == 0xE3069283  # the standard check value
    for n in (0, 1, 7, 8, 9, 63, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc32c(data) == reference(data)
        assert crc32c(data[n // 3:], crc32c(data[: n // 3])) == reference(data)


def test_load_dataset_falls_back_loudly(tmp_path, caplog):
    kw = dict(fallback_examples=16, image_shape=(12, 12, 3), num_classes=5, seed=2)
    with caplog.at_level(logging.WARNING):
        got = readers.load_dataset("imagenet", tmp_path / "missing", **kw)
    assert "FALLING BACK TO SYNTHETIC DATA" in caplog.text
    _assert_same(got, jreaders.load_dataset("imagenet", tmp_path / "missing", **kw))
    _write_mnist(tmp_path)
    _assert_same(readers.load_dataset("mnist", tmp_path), jreaders.load_dataset("mnist", tmp_path))
    with pytest.raises(ValueError, match="no image_shape"):
        readers.load_dataset("unknown", None)


def test_decoding_without_pil_names_the_package(tmp_path):
    (tmp_path / "a").mkdir()
    with mock.patch.dict(sys.modules, {"PIL": None}):
        with pytest.raises(ImportError, match="PIL"):
            readers.prepare_imagefolder(tmp_path, tmp_path / "cache", size=8)
