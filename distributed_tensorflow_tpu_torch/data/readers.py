"""Real-dataset readers, gated on local file presence (port of
``data/readers.py``).

MNIST idx files and CIFAR-10 python-pickle batches load into the same
in-memory :class:`SyntheticClassification` container the synthetic
generators produce, and ImageNet-class data (a class-folder tree or
TFRecord shards) is decoded once into a memory-mapped u8 cache, so every
downstream component (loader, train step, CLI) is agnostic to where the
pixels came from. Every reader's arrays are byte for byte the JAX
package's for the same files.

TFRecord shards are read here without TensorFlow: the framing (a u64
length, the masked CRC-32C of the length, the payload, the masked CRC-32C
of the payload) and the ``tf.Example`` protobuf wire format are parsed in
Python, and both CRCs are checked (:func:`.native.crc32c`, the host
library). JPEG and PNG decoding needs PIL, imported only where an image
tree or shard is prepared.

``load_dataset`` is the single entry: real data when the files exist under
``data_dir``, seeded synthetic otherwise — the run never fails for lack of
a download, and says loudly that it fell back.
"""

from __future__ import annotations

import gzip
import logging
import pickle
import re
import struct
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from distributed_tensorflow_tpu_torch.data.synthetic import (
    SyntheticClassification,
    synthetic_image_classification,
)

logger = logging.getLogger(__name__)

_MNIST_IMAGE_MAGIC = 2051
_MNIST_LABEL_MAGIC = 2049

# ImageNet channel statistics (RGB, [0,1] pixel scale) — the standard
# normalization constants for ImageNet-trained CNNs.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _open_maybe_gz(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return path.open("rb")


def _read_idx_images(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _MNIST_IMAGE_MAGIC:
            raise ValueError(f"{path}: bad idx image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: Path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _MNIST_LABEL_MAGIC:
            raise ValueError(f"{path}: bad idx label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int32)


def _find(data_dir: Path, names: list[str]) -> Path | None:
    for name in names:
        for cand in (data_dir / name, data_dir / (name + ".gz")):
            if cand.exists():
                return cand
    return None


def load_mnist(data_dir: str | Path, split: str = "train") -> SyntheticClassification:
    """MNIST from idx files (optionally .gz). Pixels scaled to [0, 1]."""
    data_dir = Path(data_dir)
    prefix = "train" if split == "train" else "t10k"
    img = _find(data_dir, [f"{prefix}-images-idx3-ubyte", f"{prefix}-images.idx3-ubyte"])
    lab = _find(data_dir, [f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels.idx1-ubyte"])
    if img is None or lab is None:
        raise FileNotFoundError(f"no MNIST {split} idx files under {data_dir}")
    images = _read_idx_images(img).astype(np.float32) / 255.0
    labels = _read_idx_labels(lab)
    if len(images) != len(labels):
        raise ValueError(f"{len(images)} images vs {len(labels)} labels")
    return SyntheticClassification(images=images, labels=labels)


def load_cifar10(data_dir: str | Path, split: str = "train") -> SyntheticClassification:
    """CIFAR-10 from the python-version pickle batches. NHWC [0, 1] float.

    The batches are pickles: point ``data_dir`` only at files from a source
    you trust (unpickling runs code)."""
    data_dir = Path(data_dir)
    base = data_dir / "cifar-10-batches-py"
    if not base.exists():
        base = data_dir
    names = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    images, labels = [], []
    for name in names:
        path = base / name
        if not path.exists():
            raise FileNotFoundError(f"missing CIFAR-10 batch {path}")
        with path.open("rb") as f:
            d = pickle.load(f, encoding="bytes")
        raw = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        images.append(raw.astype(np.float32) / 255.0)
        labels.append(np.asarray(d[b"labels"], np.int32))
    return SyntheticClassification(images=np.concatenate(images), labels=np.concatenate(labels))


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding image files needs the PIL package (Pillow), which is not "
            "installed here; prepare the u8 cache (images.npy, labels.npy) on a "
            "host that has it") from e
    return Image


def _decode_resize_center(img, size: int) -> np.ndarray:
    """PIL image -> RGB u8 [size, size, 3]: shorter side to ``size``, center crop."""
    Image = _pil_image()
    img = img.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    img = img.resize(
        (max(size, int(round(w * scale))), max(size, int(round(h * scale)))),
        Image.BILINEAR,
    )
    w, h = img.size
    x0, y0 = (w - size) // 2, (h - size) // 2
    return np.asarray(img.crop((x0, y0, x0 + size, y0 + size)), np.uint8)


_IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def prepare_imagefolder(src_dir: str | Path, cache_dir: str | Path, *, size: int = 256) -> Path:
    """Decode a class-subdirectory image tree into a memmap-able u8 cache.

    Layout in: ``src_dir/<class_name>/*.jpg`` (the torchvision ImageFolder /
    ImageNet "train" convention). Layout out: ``cache_dir/images.npy``
    (``[N, size, size, 3] u8``, written incrementally via ``open_memmap`` so
    ImageNet-scale sets never materialize in RAM), ``labels.npy``,
    ``classes.txt``. Returns ``cache_dir``. Decode once offline; the native
    pipeline then random-resized-crops straight out of the page cache.
    """
    Image = _pil_image()
    src_dir, cache_dir = Path(src_dir), Path(cache_dir)
    # "_"-prefixed dirs are cache/metadata (e.g. _cache_train_256), never
    # classes — including one would silently shift every label index.
    classes = sorted(
        d.name for d in src_dir.iterdir() if d.is_dir() and not d.name.startswith("_")
    )
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {src_dir}")
    files: list[tuple[Path, int]] = []
    for label, cls in enumerate(classes):
        for p in sorted((src_dir / cls).rglob("*")):
            if p.suffix.lower() in _IMG_EXTS:
                files.append((p, label))
    if not files:
        raise FileNotFoundError(f"no image files under {src_dir}")
    cache_dir.mkdir(parents=True, exist_ok=True)
    images = np.lib.format.open_memmap(
        cache_dir / "images.npy", mode="w+", dtype=np.uint8,
        shape=(len(files), size, size, 3),
    )
    labels = np.empty(len(files), np.int32)
    for i, (path, label) in enumerate(files):
        with Image.open(path) as img:
            images[i] = _decode_resize_center(img, size)
        labels[i] = label
    images.flush()
    np.save(cache_dir / "labels.npy", labels)
    (cache_dir / "classes.txt").write_text("\n".join(classes) + "\n")
    return cache_dir


# ---------------------------------------------------------------- TFRecord

_CRC_MASK_DELTA = 0xA282EAD8


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC-32C: rotate right by 15, add a constant."""
    from distributed_tensorflow_tpu_torch.data.native import crc32c

    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


def read_tfrecords(path: str | Path) -> Iterator[bytes]:
    """The records of one TFRecord file, each framing CRC checked."""
    with Path(path).open("rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", head[:8])
            (len_crc,) = struct.unpack("<I", head[8:])
            if _masked_crc(head[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt record length (CRC-32C mismatch)")
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) < length or len(tail) < 4:
                raise ValueError(f"{path}: truncated record")
            if _masked_crc(payload) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: corrupt record payload (CRC-32C mismatch)")
            yield payload


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated protobuf varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 64:
            raise ValueError("protobuf varint longer than 64 bits")


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """``(field number, wire type, value)`` of a protobuf message: ints for
    varints and fixed-width fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if pos > len(buf):
            raise ValueError("truncated protobuf field")
        yield num, wire, val


def _example_features(record: bytes) -> dict[str, bytes]:
    """``tf.Example``: Features (field 1) -> map<string, Feature> (field 1,
    entries of key 1 / value 2)."""
    feats = {}
    for num, wire, features in _fields(record):
        if num != 1 or wire != 2:
            continue
        for fnum, fwire, entry in _fields(features):
            if fnum != 1 or fwire != 2:
                continue
            key, value = None, b""
            for enum, _, v in _fields(entry):
                if enum == 1:
                    key = v.decode()
                elif enum == 2:
                    value = v
            if key is not None:
                feats[key] = value
    return feats


def _bytes_list(feature: bytes) -> list[bytes]:
    """Feature.bytes_list (field 1) -> BytesList.value (field 1, repeated)."""
    return [v for num, _, lst in _fields(feature) if num == 1
            for vnum, _, v in _fields(lst) if vnum == 1]


def _int64_list(feature: bytes) -> list[int]:
    """Feature.int64_list (field 3) -> Int64List.value (field 1, packed or not)."""
    out = []
    for num, _, lst in _fields(feature):
        if num != 3:
            continue
        for vnum, vwire, v in _fields(lst):
            if vnum != 1:
                continue
            if vwire == 2:  # packed
                pos = 0
                while pos < len(v):
                    x, pos = _varint(v, pos)
                    out.append(x)
            else:
                out.append(v)
    return [x - (1 << 64) if x >= 1 << 63 else x for x in out]


def _single(values: list, key: str, i: int):
    if len(values) != 1:
        raise ValueError(f"record {i}: {key!r} holds {len(values)} values, expected 1")
    return values[0]


def prepare_tfrecords(
    files: list[str | Path],
    cache_dir: str | Path,
    *,
    size: int = 256,
    label_offset: int = 0,
) -> Path:
    """Decode ImageNet-style TFRecords into the same u8 cache layout.

    Expects ``tf.Example`` records with ``image/encoded`` (JPEG bytes) and
    ``image/class/label``. The cache is 0-based (what the loss one-hot,
    accuracy, and imagefolder caches all use); classic ILSVRC shards store
    1-based labels (0 = background), so pass ``label_offset=1`` for those —
    stored label = raw - offset, validated non-negative. Records are read
    without TensorFlow, each CRC checked; the cache is byte for byte the
    JAX package's for the same shards.
    """
    import io

    Image = _pil_image()
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    # Pass 1: count records (CRCs checked, no decode) so the memmap can be
    # sized up front and pixels stream straight to disk.
    n = sum(1 for f in files for _ in read_tfrecords(f))
    if n == 0:
        raise FileNotFoundError(f"no records in {files}")
    images = np.lib.format.open_memmap(
        cache_dir / "images.npy", mode="w+", dtype=np.uint8, shape=(n, size, size, 3),
    )
    labels = np.empty(n, np.int32)
    records = (r for f in files for r in read_tfrecords(f))
    for i, raw in enumerate(records):
        feats = _example_features(raw)
        for key in ("image/encoded", "image/class/label"):
            if key not in feats:
                raise ValueError(f"record {i}: no {key!r} feature")
        encoded = _single(_bytes_list(feats["image/encoded"]), "image/encoded", i)
        with Image.open(io.BytesIO(encoded)) as img:
            images[i] = _decode_resize_center(img, size)
        raw_label = _single(_int64_list(feats["image/class/label"]), "image/class/label", i)
        label = raw_label - label_offset
        if label < 0:
            raise ValueError(
                f"record {i}: label {raw_label} - offset {label_offset} is "
                "negative; wrong label_offset?"
            )
        labels[i] = label
    images.flush()
    np.save(cache_dir / "labels.npy", labels)
    return cache_dir


def load_imagefolder(
    data_dir: str | Path, split: str = "train", *, size: int = 256
) -> SyntheticClassification:
    """ImageNet-class data: u8 cache, raw imagefolder, or TFRecords.

    Resolution order under ``data_dir`` (then ``data_dir/<split>``):

    1. A prepared cache (``images.npy`` + ``labels.npy``) — memory-mapped,
       so ImageNet-scale arrays cost no RAM up front.
    2. Class subdirectories of images — prepared into
       ``data_dir/_cache_<split>_<size>`` on first use, then memory-mapped.
    3. ``*tfrecord*`` / ``<split>-NNNNN-of-NNNNN`` TFRecord shards — same.

    Images stay uint8 ``[N, size, size, 3]``; the train-time pipeline does
    the random-resized-crop to the model geometry and the 1/255 scale.
    """
    data_dir = Path(data_dir)
    if (data_dir / split).exists():
        split_dir = data_dir / split
    elif split == "train":
        # Bare layout: class dirs / shards directly under data_dir.
        split_dir = data_dir
    else:
        # Never silently serve train images as a val split.
        raise FileNotFoundError(f"no {split!r} split under {data_dir}")

    def _from_cache(cache: Path) -> SyntheticClassification:
        return SyntheticClassification(
            images=np.load(cache / "images.npy", mmap_mode="r"),
            labels=np.load(cache / "labels.npy"),
        )

    for cand in (split_dir, data_dir / f"_cache_{split}_{size}"):
        if (cand / "images.npy").exists() and (cand / "labels.npy").exists():
            return _from_cache(cand)
    cache = data_dir / f"_cache_{split}_{size}"
    if any(d.is_dir() and not d.name.startswith("_") for d in split_dir.iterdir()):
        return _from_cache(prepare_imagefolder(split_dir, cache, size=size))
    # Only genuine record shards: "*.tfrecord*" or the classic
    # "<split>-00000-of-01024" naming. Never directories or stray metadata
    # files (train_stats.json would fail the record parser mid-prepare).
    shard_re = re.compile(rf"(tfrecord|^{re.escape(split)}-\d+-of-\d+$)")
    tfrecords = sorted(p for p in split_dir.iterdir() if p.is_file() and shard_re.search(p.name))
    if tfrecords:
        return _from_cache(prepare_tfrecords(tfrecords, cache, size=size))
    raise FileNotFoundError(
        f"no prepared cache, class subdirectories, or TFRecords under {split_dir}"
    )


_LOADERS = {"mnist": load_mnist, "cifar10": load_cifar10, "imagenet": load_imagefolder}


def load_dataset(
    name: str,
    data_dir: str | Path | None,
    *,
    split: str = "train",
    fallback_examples: int = 4096,
    image_shape: tuple[int, int, int] | None = None,
    num_classes: int = 10,
    seed: int = 0,
) -> SyntheticClassification:
    """Real data if present under ``data_dir``, else seeded synthetic.

    The synthetic fallback mirrors the requested geometry so shapes are the
    same either way; a ``data_dir`` that holds no data gives the
    "FALLING BACK TO SYNTHETIC DATA" warning.
    """
    defaults = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}
    if name in _LOADERS and data_dir is not None:
        try:
            return _LOADERS[name](data_dir, split)
        except FileNotFoundError as e:
            # The user pointed at real data and didn't get it — training on
            # synthetic noise must never look like a successful real run.
            logger.warning(
                "%s not found under %s (%s); FALLING BACK TO SYNTHETIC DATA",
                name, data_dir, e,
            )
    shape = image_shape or defaults.get(name)
    if shape is None:
        raise ValueError(f"unknown dataset {name!r} and no image_shape given")
    return synthetic_image_classification(fallback_examples, shape, num_classes, seed=seed)
