"""Host feed throughput of the PyTorch port's C++ input pipeline.

The port of ``scripts/feed_bench.py``'s ``native`` mode: batches/s and
images/s, per core and in all, of the real augmentation work (random-resized
crop + flip + ImageNet mean/std, the ``imagenet_resnet50`` preset's) from a
u8 memory-mapped cache through :class:`NativePipeline`, at a given geometry
and thread counts; and the cores the feed needs to keep up with a device
rate (``--target-img-per-s``):

    cores_needed = target_img_per_s / img_per_s_per_core

With ``--device cuda`` each configuration is also timed through
``native_device_batches`` onto the card (pinned staging, the host->device
copy). ``--crc-bytes N`` times the CRC-32C that checks TFRecord framing over
a record of N bytes (about 110 kB: an ImageNet JPEG).

    python3 scripts/torch_feed_bench.py [--images 1280] [--threads 1,4,all]
        [--cache DIR] [--device cuda] [--crc-bytes 110000]

One JSON line per configuration. Without ``--cache``, a seeded cache of
``--images`` images at ``--src-hw`` is written under ``build/feed_bench/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributed_tensorflow_tpu_torch.data.readers import (  # noqa: E402
    IMAGENET_MEAN,
    IMAGENET_STD,
)


def host_cores() -> int:
    return len(os.sched_getaffinity(0))


def write_cache(out: Path, n: int, hw: int, seed: int = 0) -> Path:
    """A seeded u8 cache (``images.npy`` [n, hw, hw, 3], ``labels.npy``),
    written in chunks through a memmap."""
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    images = np.lib.format.open_memmap(out / "images.npy", mode="w+", dtype=np.uint8,
                                       shape=(n, hw, hw, 3))
    for lo in range(0, n, 256):
        hi = min(n, lo + 256)
        images[lo:hi] = rng.integers(0, 256, (hi - lo, hw, hw, 3), dtype=np.uint8)
    images.flush()
    np.save(out / "labels.npy", rng.integers(0, 1000, n).astype(np.int32))
    return out


def load_cache(cache: Path) -> tuple[np.ndarray, np.ndarray]:
    return np.load(cache / "images.npy", mmap_mode="r"), np.load(cache / "labels.npy")


def imagenet_kwargs(out_hw: int) -> dict:
    """The imagenet_resnet50 preset's training augmentation."""
    return dict(out_size=(out_hw, out_hw), rrc=True, flip=True, mean=IMAGENET_MEAN,
                stddev=IMAGENET_STD)


def bench_native(images, labels, *, out_hw: int, batch: int, n_batches: int,
                 n_threads: int) -> dict:
    """Host rate of :class:`NativePipeline` alone, in steady state: the
    batches the workers and the ring can hold ahead are taken untimed, then
    ``n_batches`` are timed."""
    from distributed_tensorflow_tpu_torch.data.native import NativePipeline

    with NativePipeline(images, labels, batch, seed=0, n_threads=n_threads, queue_cap=2,
                        **imagenet_kwargs(out_hw)) as pipe:
        for _ in range(n_threads + 2):
            pipe.next()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            pipe.next()
        dt = time.perf_counter() - t0
    img_s = batch * n_batches / dt
    return {"mode": "native", "out": out_hw, "batch": batch, "threads": n_threads,
            "batches_per_s": n_batches / dt, "host_ms_per_batch": 1e3 * dt / n_batches,
            "img_per_s": img_s, "img_per_s_per_core": img_s / n_threads}


def bench_device(images, labels, *, out_hw: int, batch: int, n_batches: int,
                 n_threads: int, device: str) -> dict:
    """The same stream through ``native_device_batches`` onto ``device``,
    after the same untimed warm-up (the ring holds 8, the staging buffers
    4): the copies waited for at the end (``torch.cuda.synchronize``)."""
    import torch

    from distributed_tensorflow_tpu_torch.data.loader import native_device_batches
    from distributed_tensorflow_tpu_torch.data.synthetic import SyntheticClassification

    ds = SyntheticClassification(images=images, labels=labels)
    feed = native_device_batches(ds, batch, device=device, n_threads=n_threads, seed=0,
                                 **imagenet_kwargs(out_hw))
    try:
        for _ in range(n_threads + 12):
            next(feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(feed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        feed.close()
    img_s = batch * n_batches / dt
    return {"mode": "native_device", "device": torch.cuda.get_device_name(0), "out": out_hw,
            "batch": batch, "threads": n_threads, "batches_per_s": n_batches / dt,
            "host_ms_per_batch": 1e3 * dt / n_batches, "img_per_s": img_s,
            "img_per_s_per_core": img_s / n_threads}


def bench_crc(n_bytes: int, reps: int = 200) -> dict:
    """CRC-32C over one record of ``n_bytes`` (seeded bytes), per record."""
    from distributed_tensorflow_tpu_torch.data.native import crc32c

    data = np.random.default_rng(1).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    crc32c(data)
    t0 = time.perf_counter()
    for _ in range(reps):
        crc32c(data)
    dt = (time.perf_counter() - t0) / reps
    return {"mode": "crc32c", "record_bytes": n_bytes, "us_per_record": dt * 1e6,
            "gb_per_s": n_bytes / dt / 1e9}


def parse_threads(spec: str, cores: int) -> list[int]:
    out = []
    for part in spec.split(","):
        out.append(cores if part.strip() == "all" else int(part))
    return sorted(set(out))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cache", default="", help="existing u8 cache (images.npy, labels.npy)")
    ap.add_argument("--images", type=int, default=1280, help="images of the seeded cache")
    ap.add_argument("--src-hw", type=int, default=256, help="stored size of the seeded cache")
    ap.add_argument("--out", type=int, default=224, help="output size (RRC target)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=10, help="timed batches a configuration")
    ap.add_argument("--threads", default="1,4,all", help="worker-thread counts ('all' = cores)")
    ap.add_argument("--target-img-per-s", type=float, default=1280.0,
                    help="device rate the feed must sustain, for cores_needed")
    ap.add_argument("--device", default="", help="also time native_device_batches onto "
                                                  "this device (cuda)")
    ap.add_argument("--crc-bytes", type=int, default=0, help="time CRC-32C on a record of "
                                                             "this many bytes")
    args = ap.parse_args(argv)

    cores = host_cores()
    cache = Path(args.cache) if args.cache else write_cache(
        ROOT / "build" / "feed_bench" / f"u8_{args.images}_{args.src_hw}", args.images,
        args.src_hw)
    images, labels = load_cache(cache)
    print(json.dumps({"mode": "host", "cores": cores, "cache": str(cache),
                      "images": images.shape}), flush=True)
    for n_threads in parse_threads(args.threads, cores):
        kw = dict(out_hw=args.out, batch=args.batch, n_batches=args.batches,
                  n_threads=n_threads)
        rows = [bench_native(images, labels, **kw)]
        if args.device:
            rows.append(bench_device(images, labels, device=args.device, **kw))
        for r in rows:
            r["cores"] = cores
            r["cores_needed"] = args.target_img_per_s / r["img_per_s_per_core"]
            print(json.dumps(r), flush=True)
    if args.crc_bytes:
        print(json.dumps(bench_crc(args.crc_bytes)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
