"""Prepare an ImageNet-class dataset into the port's u8 memmap cache.

Decode once offline (PIL is needed here, and only here); training then
random-resized-crops straight out of the page cache through the port's host
C++ pipeline. TFRecord shards are read without TensorFlow.

    # class folders of images:
    python3 scripts/torch_prepare_imagenet.py --src /data/raw/train --out /data/cache/train

    # TFRecord shards (classic ILSVRC: 1-based labels -> pass --label-offset 1):
    python3 scripts/torch_prepare_imagenet.py --tfrecords '/data/raw/train-*' \\
        --out /data/cache/train --label-offset 1

The cache (``images.npy``, ``labels.npy``) is what ``cli.train --data-dir``
reads for the ImageNet presets.
"""

from __future__ import annotations

import argparse
import glob
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_tensorflow_tpu_torch.data.readers import (  # noqa: E402
    prepare_imagefolder,
    prepare_tfrecords,
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default="", help="class-folder root (one subdirectory a class)")
    ap.add_argument("--tfrecords", default="", help="glob of TFRecord shards")
    ap.add_argument("--out", required=True, help="cache dir (images.npy, labels.npy)")
    ap.add_argument("--size", type=int, default=256, help="stored square size")
    ap.add_argument("--label-offset", type=int, default=0,
                    help="subtract from TFRecord labels (1 for classic ILSVRC)")
    args = ap.parse_args(argv)
    if bool(args.src) == bool(args.tfrecords):
        ap.error("pass exactly one of --src / --tfrecords")

    t0 = time.perf_counter()
    if args.src:
        cache = prepare_imagefolder(args.src, args.out, size=args.size)
    else:
        shards = sorted(glob.glob(args.tfrecords))
        if not shards:
            ap.error(f"no shards match {args.tfrecords!r}")
        cache = prepare_tfrecords(shards, args.out, size=args.size,
                                  label_offset=args.label_offset)
    labels = np.load(cache / "labels.npy")
    print(f"prepared {len(labels)} examples ({labels.max() + 1} classes) at "
          f"{args.size}x{args.size} in {time.perf_counter() - t0:.1f}s -> {cache}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
