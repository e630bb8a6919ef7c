"""ResNet family: ResNet-20 (CIFAR-10) and ResNet-50 (ImageNet).

Port of ``distributed_tensorflow_tpu/models/resnet.py``: the same networks,
NHWC at the public functions, parameters f32 and compute in ``dtype``
(bf16 on the card's main path), BatchNorm statistics in f32.

Parameter names mirror the flax tree (``stem_conv``, ``stem_bn``,
``BottleneckBlock_<i>``/``BasicBlock_<i>``, ``Conv_<j>``, ``BatchNorm_<j>``,
``proj``, ``proj_bn``, ``head``) under torch's leaf names: conv kernels are
``weight [out, in, kh, kw]``, BatchNorm scale and bias ``weight``/``bias``,
Dense ``weight [out, in]``/``bias`` (:mod:`..interop` converts).

BatchNorm follows flax, not ``torch.nn.BatchNorm2d``: statistics in f32
even for bf16 inputs, the biased fast variance E[x^2] - E[x]^2, running
averages ``0.9 * ra + 0.1 * batch``, eps 1e-5, and the running averages in
eval. The model is functional in its statistics, as flax's
``mutable=["batch_stats"]`` is: ``forward(x, batch_stats, train=...)``
returns ``(logits, new_batch_stats)`` and updates nothing in place, so the
train step can average or slice-average the new statistics like any other
output. ``batch_stats`` is a flat dict ``"<bn module path>.mean"`` /
``".var"`` -> f32 ``[C]`` (:meth:`ResNet.init_batch_stats`).

The 3x3 and stem convolutions go to ``torch.nn.functional.conv2d`` on an
NCHW view of the NHWC tensor (``permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor is channels-last memory, so no copy is made), with flax's SAME
padding (stride 2 pads one row and column at the end only).

``pw_backend`` picks the path of the bottleneck blocks' 1x1 convolutions:
``"conv"`` (a plain convolution), ``"pallas"`` (the dgrad kernel of
:mod:`..ops.pointwise_conv` under the JAX package's routing) or ``"fused"``
(in training, whole conv1x1 + BN (+ReLU) units with the fused backward of
:mod:`..ops.fused_conv_bn` where :func:`~..ops.fused_conv_bn.fused_supported`
allows). The names keep the JAX package's, whose kernels were Pallas.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.device import resolve_device

_PW_BACKENDS = ("conv", "pallas", "fused")
# flax's truncated-normal initialisers cut at two standard deviations and
# rescale by the truncated distribution's stddev.
_TRUNC_STD = 0.87962566103423978


def truncated_normal_(t: torch.Tensor, scale: float, fan_in: int, generator) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    he_normal is scale 2, lecun_normal scale 1."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA SAME padding of one spatial dim: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x, weight, stride: int = 1, padding="SAME", bias=None):
    """``nn.Conv`` on NHWC ``x`` with an OIHW ``weight`` (cast to x's dtype):
    ``padding`` is ``"SAME"``, ``"VALID"`` or ``((top, bottom), (left, right))``."""
    kh, kw = weight.shape[2:]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        padding = ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pad = (0, 0)
    b = None if bias is None else bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), b, stride, pad)
    return y.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (kh, kw), use_bias=False)``: ``weight``
    ``[out, in, kh, kw]``, He-normal. ``kernel`` is ``k`` (square) or
    ``(kh, kw)``."""

    def __init__(self, cin: int, features: int, kernel: int | tuple[int, int],
                 strides: int = 1, padding="SAME"):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.weight = nn.Parameter(torch.empty(features, cin, kh, kw))
        self.strides = strides
        self.padding = padding

    def reset_parameters(self, generator) -> None:
        o, i, kh, kw = self.weight.shape
        truncated_normal_(self.weight.data, 2.0, i * kh * kw, generator)

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.strides, self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    (last) axis: ``weight`` (scale) and ``bias``; its running averages live
    in the ``batch_stats`` dict under ``key`` (the module's path, set by the
    model)."""

    def __init__(self, features: int, zero_scale: bool = False, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.zero_scale = zero_scale
        self.eps = eps
        self.momentum = momentum
        self.key = ""

    def reset_parameters(self, generator=None) -> None:
        nn.init.constant_(self.weight.data, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias.data)

    def update(self, stats: "BatchStats", mean, var) -> None:
        """Fold batch statistics into this layer's running averages (flax's
        momentum rule); no gradient flows into them."""
        m = self.momentum
        old_mean, old_var = stats.running(self.key)
        stats.new[f"{self.key}.mean"] = m * old_mean + (1 - m) * mean.detach()
        stats.new[f"{self.key}.var"] = m * old_var + (1 - m) * var.detach()

    def forward(self, x, stats: "BatchStats"):
        if stats.train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = torch.clamp_min(xf.square().mean(dims) - mean.square(), 0.0)
            self.update(stats, mean, var)
        else:
            xf = x
            mean, var = stats.running(self.key)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class BatchStats:
    """The running statistics one forward reads (``old``) and the new ones
    it collects in training (``new``): flax's mutable ``batch_stats``."""

    def __init__(self, old: dict, train: bool):
        self.old = old
        self.train = train
        self.new: dict[str, torch.Tensor] = {}

    def running(self, key: str):
        return self.old[f"{key}.mean"], self.old[f"{key}.var"]


class PointwiseConv(Conv):
    """1x1 convolution (``nn.Conv(features, (1, 1))``'s ``weight``) with the
    dgrad kernel in its backward (``backend="pallas"``): N = 64 outputs from
    K >= 128 inputs take the N = 64 route, everything else
    :func:`~..ops.pointwise_conv.pointwise_matmul` (which keeps a plain
    product where the JAX routing does). A strided 1x1 conv is a spatial
    slice, then the product."""

    def __init__(self, cin: int, features: int, kernel: int = 1, strides: int = 1):
        if kernel != 1:
            raise ValueError(f"PointwiseConv is a 1x1 convolution, got kernel {kernel}")
        super().__init__(cin, features, 1, strides)

    def forward(self, x):
        from distributed_tensorflow_tpu_torch.ops.pointwise_conv import (
            pointwise_conv_n64,
            pointwise_matmul,
        )

        s = self.strides
        if s > 1:
            x = x[:, ::s, ::s, :]
        b, h, w, cin = x.shape
        features = self.weight.shape[0]
        k2 = self.weight[:, :, 0, 0].t().to(x.dtype)
        if features == 64 and cin >= 128:
            return pointwise_conv_n64(x, k2)
        y = pointwise_matmul(x.reshape(b * h * w, cin), k2)
        return y.reshape(b, h, w, features)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (CIFAR ResNets)."""

    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3)
        # Zero-initialised final BN scale: each residual branch starts as
        # the identity (Goyal et al.).
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        self.has_proj = strides != 1 or cin != filters
        if self.has_proj:
            self.proj = Conv(cin, filters, 1, strides)
            self.proj_bn = BatchNorm(filters)

    def forward(self, x, stats: BatchStats):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), stats))
        y = self.BatchNorm_1(self.Conv_1(y), stats)
        residual = self.proj_bn(self.proj(x), stats) if self.has_proj else x
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 down / 3x3 / 1x1 up (x4) bottleneck block (ImageNet ResNets),
    stride on the 3x3. ``pw_backend`` routes the three 1x1 units (see the
    module docstring)."""

    def __init__(self, cin: int, filters: int, strides: int = 1, *, pw_backend: str = "conv",
                 dtype=torch.float32):
        super().__init__()
        c1 = PointwiseConv if pw_backend == "pallas" else Conv
        out = filters * 4
        self.fused = pw_backend == "fused"
        self.dtype = dtype
        self.Conv_0 = c1(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = c1(filters, out, 1)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        self.strides = strides
        self.has_proj = strides != 1 or cin != out
        if self.has_proj:
            self.proj = c1(cin, out, 1, strides)
            self.proj_bn = BatchNorm(out)

    def _unit(self, x, conv, bn, strides: int, relu: bool, stats: BatchStats):
        """One conv1x1 -> BN (-> ReLU) unit; fused when training and the
        shape qualifies (``_unit`` of the JAX block)."""
        from distributed_tensorflow_tpu_torch.ops.fused_conv_bn import (
            fused_supported,
            fused_unit,
        )

        b, h, w, cin = x.shape
        # Ceil division: x[:, ::s, ::s] keeps ceil(h/s) rows.
        m = b * (-(-h // strides)) * (-(-w // strides))
        if self.fused and stats.train and fused_supported(m, cin, conv.weight.shape[0]):
            return fused_unit(x, conv, bn, stats, relu=relu, dtype=self.dtype, strides=strides)
        y = bn(conv(x), stats)
        return torch.relu(y) if relu else y

    def forward(self, x, stats: BatchStats):
        y = self._unit(x, self.Conv_0, self.BatchNorm_0, 1, True, stats)
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), stats))
        y = self._unit(y, self.Conv_2, self.BatchNorm_2, 1, False, stats)
        residual = x
        if self.has_proj:
            residual = self._unit(x, self.proj, self.proj_bn, self.strides, False, stats)
        return torch.relu(y + residual)


class SpaceToDepthStem(nn.Module):
    """The ImageNet 7x7/s2 stem conv as a 2x2-space-to-depth 4x4/s1 conv.

    The JAX package's reparameterisation, kept as it is: the input becomes
    ``[B, H/2, W/2, 4C]``, the 7x7 kernel is zero-padded to 8x8 (one leading
    row and column) and regrouped to 4x4 over 4C inputs, and block padding
    (2, 1) reproduces the original symmetric pad 3. The parameter is the
    original 7x7 ``weight [F, C, 7, 7]``, so both stems share one tree.
    """

    def __init__(self, cin: int = 3, features: int = 64):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, 7, 7))

    def reset_parameters(self, generator) -> None:
        truncated_normal_(self.weight.data, 2.0, self.weight[0].numel(), generator)

    def forward(self, x):
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem needs even H/W, got {(h, w)}")
        f = self.weight.shape[0]
        x = (x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, h // 2, w // 2, 4 * c))
        k = self.weight.to(x.dtype).permute(2, 3, 1, 0)      # HWIO [7, 7, C, F]
        k8 = F.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))              # [8, 8, C, F]
        k2 = (k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1))   # OIHW [F, 4C, 4, 4]
        return conv2d_nhwc(x, k2, 1, ((2, 1), (2, 1)))


class ResNet(nn.Module):
    """Residual network over NHWC inputs.

    ``stem="imagenet"``: 7x7/2 conv (through :class:`SpaceToDepthStem` when
    ``stem_s2d`` and H, W are even), BN, ReLU, 3x3/2 max-pool;
    ``stem="cifar"``: one 3x3 conv, BN, ReLU. ``remat`` recomputes each
    block's activations in the backward (``torch.utils.checkpoint``).

    ``forward(x, batch_stats, *, train=False) -> (logits, new_batch_stats)``:
    ``x`` ``[B, H, W, C]``, logits f32 ``[B, num_classes]``. In eval the
    running averages normalise and ``batch_stats`` comes back unchanged.
    Parameters are created on ``device`` (default the card; raises without
    one) and drawn from ``generator`` (default: seeded with ``seed``) with
    the JAX package's initialisers.
    """

    def __init__(self, stage_sizes: Sequence[int], block: type, num_filters: int = 64,
                 num_classes: int = 1000, stem: str = "imagenet", stem_s2d: bool = True,
                 remat: bool = False, pw_backend: str = "conv", dtype=torch.float32,
                 in_channels: int = 3, *, device="cuda", generator=None, seed: int = 0):
        super().__init__()
        if pw_backend not in _PW_BACKENDS:
            raise ValueError(f"pw_backend must be one of {_PW_BACKENDS}, got {pw_backend!r}")
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        dev = resolve_device(device)
        self.stem = stem
        self.stem_s2d = stem_s2d
        self.remat = remat
        self.pw_backend = pw_backend
        self.dtype = dtype
        if stem == "imagenet":
            self.stem_conv = SpaceToDepthStem(in_channels, num_filters)
        else:
            self.stem_conv = Conv(in_channels, num_filters, 3)
        self.stem_bn = BatchNorm(num_filters)
        cin = num_filters
        i_block = 0
        bottleneck = block is BottleneckBlock
        kwargs = {"pw_backend": pw_backend, "dtype": dtype} if bottleneck else {}
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                filters = num_filters * 2**i
                blk = block(cin, filters, 2 if i > 0 and j == 0 else 1, **kwargs)
                self.add_module(f"{block.__name__}_{i_block}", blk)
                i_block += 1
                cin = filters * (4 if bottleneck else 1)
        self.n_blocks = i_block
        self.block_name = block.__name__
        self.head = nn.Linear(cin, num_classes)
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.key = name
        self.to(dev)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(seed)
        self._init_params(generator)

    @torch.no_grad()
    def _init_params(self, generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (Conv, SpaceToDepthStem, BatchNorm)):
                mod.reset_parameters(generator)
        truncated_normal_(self.head.weight.data, 1.0, self.head.in_features, generator)
        self.head.bias.zero_()

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        """Running averages at init: mean 0, var 1, f32, on the model's device."""
        out = {}
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                out[f"{mod.key}.mean"] = torch.zeros(c, device=mod.weight.device)
                out[f"{mod.key}.var"] = torch.ones(c, device=mod.weight.device)
        return out

    def _stem(self, x, stats: BatchStats):
        if self.stem == "imagenet":
            if self.stem_s2d and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
                x = self.stem_conv(x)
            else:
                x = conv2d_nhwc(x, self.stem_conv.weight, 2, ((3, 3), (3, 3)))
            x = torch.relu(self.stem_bn(x, stats))
            # Max-pool pads with -inf, as flax's does.
            y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1)
            return y.permute(0, 2, 3, 1)
        return torch.relu(self.stem_bn(self.stem_conv(x), stats))

    def forward(self, x, batch_stats: dict, *, train: bool = False):
        stats = BatchStats(batch_stats, train)
        x = self._stem(x.to(self.dtype), stats)
        for i in range(self.n_blocks):
            blk = getattr(self, f"{self.block_name}_{i}")
            if self.remat and train:
                x = checkpoint(blk, x, stats, use_reentrant=False)
            else:
                x = blk(x, stats)
        x = x.mean(dim=(1, 2))
        # The head computes in f32: the logits/loss edge is where bf16 hurts.
        logits = F.linear(x.float(), self.head.weight, self.head.bias)
        return logits, (stats.new if train else batch_stats)


def ResNet20(num_classes: int = 10, dtype=torch.float32, **kwargs) -> ResNet:
    """He et al. CIFAR ResNet, n=3: 6n+2 = 20 layers, ~0.27M params."""
    return ResNet((3, 3, 3), BasicBlock, num_filters=16, num_classes=num_classes,
                  stem="cifar", dtype=dtype, **kwargs)


def ResNet50(num_classes: int = 1000, dtype=torch.float32, **kwargs) -> ResNet:
    """Bottleneck ImageNet ResNet-50, ~25.6M params: the north-star model.
    ``kwargs`` reach :class:`ResNet` (``pw_backend``, ``remat``, ``device``,
    ``generator``, ...)."""
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_filters=64, num_classes=num_classes,
                  stem="imagenet", dtype=dtype, **kwargs)
