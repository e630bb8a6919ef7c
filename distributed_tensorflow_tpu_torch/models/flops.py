"""FLOPs per image of an image model's training step.

Counted from the port's own layers by running them: one training-mode
forward of a single image under ``torch.utils.flop_counter.FlopCounterMode``,
which adds 2 x H_out x W_out x kh x kw x C_in x C_out for every convolution
and 2 x in x out for every matrix product (the fused 1x1 units' products and
the Dense heads), i.e. 2 FLOPs per multiply-add. Pooling, BatchNorm and the
other elementwise work are not counted, as is the convention. ResNet-50's
stem counts as the 4x4 space-to-depth convolution the port runs (0.31
GFLOP in place of the 7x7's 0.24). A training step is taken as 3 x the
forward (the backward computes two products per forward product).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def train_flops_per_image(model, image_shape) -> int:
    """One training step's FLOPs per ``image_shape`` (H, W, C) image:
    3 x those of ``model``'s training forward (the aux head included where
    the model has one)."""
    device = next(model.parameters()).device
    x = torch.zeros((1, *image_shape), device=device)
    kwargs = {}
    if hasattr(model, "init_batch_stats"):
        kwargs["batch_stats"] = model.init_batch_stats()
    if getattr(model, "dropout_rate", 0.0):
        kwargs["generator"] = torch.Generator(device).manual_seed(0)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, train=True, **kwargs)
    return 3 * int(counter.get_total_flops())
