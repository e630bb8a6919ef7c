"""LeNet-5, the MNIST sanity workload (port of ``models/lenet.py``).

The classic LeCun-98 shape (6-16-120-84-10) on 28x28x1 NHWC inputs with
SAME padding on the first conv; the head computes in f32. Parameters are
created on ``device`` (default the card; raises without one) with flax's
initialisers (lecun_normal kernels, zero biases) drawn from ``generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.resnet import conv2d_nhwc, truncated_normal_


def _avg_pool(x):
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class LeNet5(nn.Module):
    """``forward(x [B, 28, 28, 1], *, train=False) -> logits [B, classes]``."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32, *, device="cuda",
                 generator=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(16 * 5 * 5, 120)
        self.fc2 = nn.Linear(120, 84)
        self.head = nn.Linear(84, num_classes)
        self.to(dev)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        with torch.no_grad():
            for mod in (self.conv1, self.conv2, self.fc1, self.fc2, self.head):
                truncated_normal_(mod.weight.data, 1.0, mod.weight[0].numel(), generator)
                mod.bias.zero_()

    def forward(self, x, *, train: bool = False):
        dt = self.dtype
        x = x.to(dt)
        x = _avg_pool(torch.relu(conv2d_nhwc(x, self.conv1.weight, 1, "SAME", self.conv1.bias)))
        x = _avg_pool(torch.relu(conv2d_nhwc(x, self.conv2.weight, 1, "VALID", self.conv2.bias)))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = torch.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = torch.relu(F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt)))
        return F.linear(x.float(), self.head.weight, self.head.bias)
