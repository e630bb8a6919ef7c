"""Dataset entry point (port of ``data/readers.py`` ``load_dataset``).

``load_dataset`` returns real data when a reader finds it under
``data_dir``, else seeded synthetic data of the requested geometry, so
shapes are the same either way. The MNIST, CIFAR-10 and ImageFolder
readers come with a later slice: here every name takes the synthetic
path, and naming a ``data_dir`` raises rather than train on noise that
looks like a real run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from distributed_tensorflow_tpu_torch.data.synthetic import (
    SyntheticClassification,
    synthetic_image_classification,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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
    """Seeded synthetic data of the requested geometry (``split`` picks
    nothing yet: the callers seed the splits apart). ``image_shape``
    defaults to MNIST's and CIFAR-10's for those names."""
    if data_dir is not None:
        raise NotImplementedError(
            f"reading {name!r} from {data_dir}: the MNIST/CIFAR/ImageFolder readers "
            "are ported with the image-readers slice"
        )
    defaults = {"mnist": (28, 28, 1), "cifar10": (32, 32, 3)}
    shape = image_shape or defaults.get(name)
    if shape is None:
        raise ValueError(f"unknown dataset {name!r} and no image_shape given")
    return synthetic_image_classification(fallback_examples, shape, num_classes, seed=seed)
