"""Seeded synthetic datasets with learnable class structure (port of
``data/synthetic.py``, numpy only: the same seed gives the same arrays in
both packages).

Stand-ins for MNIST/CIFAR/ImageNet where no real data is present: each
class gets a fixed random template; samples are template + noise, so a
real model trained on them converges.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticClassification:
    """In-memory synthetic image-classification dataset."""

    images: np.ndarray  # [N,H,W,C] float32
    labels: np.ndarray  # [N] int32

    def __len__(self):
        return len(self.labels)


def synthetic_image_classification(
    num_examples: int,
    image_shape: tuple[int, int, int],
    num_classes: int,
    *,
    seed: int = 0,
    noise: float = 0.5,
) -> SyntheticClassification:
    """Class-template images + Gaussian noise; linearly separable-ish."""
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(num_classes, *image_shape)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num_examples).astype(np.int32)
    images = templates[labels] + noise * rng.normal(
        size=(num_examples, *image_shape)
    ).astype(np.float32)
    return SyntheticClassification(images=images.astype(np.float32), labels=labels)
