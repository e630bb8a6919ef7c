"""Inception-v3: the reference's async-PS stress workload.

Port of ``distributed_tensorflow_tpu/models/inception.py`` (Szegedy et al.
2015, torchvision layout): ``BasicConv`` (conv without bias, BatchNorm with
eps 1e-3, ReLU) everywhere; stages A (x3), B, C (x4), D, E (x2); an
auxiliary classifier on the 17x17 grid. NHWC at the public functions,
parameters f32 and compute in ``dtype`` (bf16 on the card's main path),
as :mod:`.resnet`, whose ``Conv``, ``BatchNorm`` and ``BatchStats`` it
reuses: the model is functional in its BatchNorm statistics,
``forward(x, batch_stats, train=..., generator=...) -> (out,
new_batch_stats)``.

Module names are the flax ones (``BasicConv_<i>`` in call order inside
each block, ``InceptionA_0`` ..., ``aux`` with ``fc``, ``head``, and
``Conv_0``/``BatchNorm_0`` inside each ``BasicConv``), so
:mod:`..interop` maps the tree by name.

Pooling follows flax: the 3x3/1 average pools are SAME with the padding
counted (border windows divide by 9), the aux pool is 5/3 VALID, the max
pools 3/2 VALID. Dropout (0.5 before ``head``) draws from the
``torch.Generator`` the caller passes. With ``fused=True``, in training, the
1x1 stride-1 units that ``fused_supported`` takes run the fused conv+BN+ReLU
backward (:mod:`..ops.fused_conv_bn`), as in the JAX package; the aux
head's 5x5 unit never does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from distributed_tensorflow_tpu_torch.device import resolve_device
from distributed_tensorflow_tpu_torch.models.bert import dropout
from distributed_tensorflow_tpu_torch.models.resnet import (
    BatchNorm,
    BatchStats,
    Conv,
    truncated_normal_,
)

_BN_EPS = 1e-3


class BasicConv(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3) + ReLU. ``kernel`` is ``k`` or
    ``(kh, kw)``; ``strides`` a square stride."""

    def __init__(self, cin: int, features: int, kernel, strides: int = 1, padding="SAME",
                 *, dtype=torch.float32, fused: bool = False):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, strides, padding)
        self.BatchNorm_0 = BatchNorm(features, eps=_BN_EPS)
        self.kernel = tuple(self.Conv_0.weight.shape[2:])
        self.strides = strides
        self.padding = padding
        self.dtype = dtype
        self.fused = fused

    def forward(self, x, stats: BatchStats):
        from distributed_tensorflow_tpu_torch.ops.fused_conv_bn import (
            fused_supported,
            fused_unit,
        )

        b, h, w, cin = x.shape
        features = self.Conv_0.weight.shape[0]
        # A 1x1 stride-1 conv is padding-free only under SAME/VALID.
        if (self.fused and stats.train and self.kernel == (1, 1) and self.strides == 1
                and self.padding in ("SAME", "VALID")
                and fused_supported(b * h * w, cin, features)):
            return fused_unit(x, self.Conv_0, self.BatchNorm_0, stats, relu=True,
                              dtype=self.dtype, eps=_BN_EPS)
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), stats))


def _nchw(pool, x, *args, **kwargs):
    """An NCHW pooling op on an NHWC tensor (a view both ways)."""
    return pool(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


def _avg_pool_same(x):
    """flax ``avg_pool(x, (3, 3), (1, 1), "SAME")``: padding counted."""
    return _nchw(F.avg_pool2d, x, 3, 1, 1, count_include_pad=True)


def _max_pool(x):
    """flax ``max_pool(x, (3, 3), (2, 2), "VALID")``."""
    return _nchw(F.max_pool2d, x, 3, 2)


class _Block(nn.Module):
    """A block of ``BasicConv_<i>`` units numbered in call order."""

    def __init__(self, units, *, dtype, fused):
        super().__init__()
        for i, (cin, features, kernel, *rest) in enumerate(units):
            self.add_module(f"BasicConv_{i}", BasicConv(cin, features, kernel, *rest,
                                                        dtype=dtype, fused=fused))

    def unit(self, i: int, x, stats):
        return getattr(self, f"BasicConv_{i}")(x, stats)


class InceptionA(_Block):
    def __init__(self, cin: int, pool_features: int, *, dtype=torch.float32, fused=False):
        super().__init__([(cin, 64, 1), (cin, 48, 1), (48, 64, 5), (cin, 64, 1), (64, 96, 3),
                          (96, 96, 3), (cin, pool_features, 1)], dtype=dtype, fused=fused)
        self.features = 224 + pool_features

    def forward(self, x, stats):
        u = lambda i, y: self.unit(i, y, stats)  # noqa: E731
        b1 = u(0, x)
        b5 = u(2, u(1, x))
        b3 = u(5, u(4, u(3, x)))
        bp = u(6, _avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], dim=-1)


class InceptionB(_Block):
    """35x35 -> 17x17 grid reduction."""

    def __init__(self, cin: int, *, dtype=torch.float32, fused=False):
        super().__init__([(cin, 384, 3, 2, "VALID"), (cin, 64, 1), (64, 96, 3),
                          (96, 96, 3, 2, "VALID")], dtype=dtype, fused=fused)
        self.features = 384 + 96 + cin

    def forward(self, x, stats):
        u = lambda i, y: self.unit(i, y, stats)  # noqa: E731
        b3 = u(0, x)
        bd = u(3, u(2, u(1, x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=-1)


class InceptionC(_Block):
    """17x17 blocks with factorized 1x7/7x1 convolutions."""

    def __init__(self, cin: int, channels_7x7: int, *, dtype=torch.float32, fused=False):
        c7 = channels_7x7
        super().__init__([(cin, 192, 1), (cin, c7, 1), (c7, c7, (1, 7)), (c7, 192, (7, 1)),
                          (cin, c7, 1), (c7, c7, (7, 1)), (c7, c7, (1, 7)), (c7, c7, (7, 1)),
                          (c7, 192, (1, 7)), (cin, 192, 1)], dtype=dtype, fused=fused)
        self.features = 768

    def forward(self, x, stats):
        u = lambda i, y: self.unit(i, y, stats)  # noqa: E731
        b1 = u(0, x)
        b7 = u(3, u(2, u(1, x)))
        bd = u(8, u(7, u(6, u(5, u(4, x)))))
        bp = u(9, _avg_pool_same(x))
        return torch.cat([b1, b7, bd, bp], dim=-1)


class InceptionD(_Block):
    """17x17 -> 8x8 grid reduction."""

    def __init__(self, cin: int, *, dtype=torch.float32, fused=False):
        super().__init__([(cin, 192, 1), (192, 320, 3, 2, "VALID"), (cin, 192, 1),
                          (192, 192, (1, 7)), (192, 192, (7, 1)), (192, 192, 3, 2, "VALID")],
                         dtype=dtype, fused=fused)
        self.features = 320 + 192 + cin

    def forward(self, x, stats):
        u = lambda i, y: self.unit(i, y, stats)  # noqa: E731
        b3 = u(1, u(0, x))
        b7 = u(5, u(4, u(3, u(2, x))))
        return torch.cat([b3, b7, _max_pool(x)], dim=-1)


class InceptionE(_Block):
    """8x8 blocks with split 1x3/3x1 branches."""

    def __init__(self, cin: int, *, dtype=torch.float32, fused=False):
        super().__init__([(cin, 320, 1), (cin, 384, 1), (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (cin, 448, 1), (448, 384, 3), (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (cin, 192, 1)], dtype=dtype, fused=fused)
        self.features = 2048

    def forward(self, x, stats):
        u = lambda i, y: self.unit(i, y, stats)  # noqa: E731
        b1 = u(0, x)
        b3 = u(1, x)
        b3 = torch.cat([u(2, b3), u(3, b3)], dim=-1)
        bd = u(5, u(4, x))
        bd = torch.cat([u(6, bd), u(7, bd)], dim=-1)
        bp = u(8, _avg_pool_same(x))
        return torch.cat([b1, b3, bd, bp], dim=-1)


class InceptionAux(nn.Module):
    """Auxiliary classifier over the 17x17x768 grid; ``fc`` computes in f32."""

    def __init__(self, cin: int, num_classes: int, *, dtype=torch.float32, fused=False):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, 128, 1, dtype=dtype, fused=fused)
        self.BasicConv_1 = BasicConv(128, 768, 5, padding="VALID", dtype=dtype)
        self.fc = nn.Linear(768, num_classes)

    def forward(self, x, stats):
        if x.shape[1] < 17 or x.shape[2] < 17:
            # The 5x5/3 pool then the VALID 5x5 conv need a >= 17x17 grid.
            raise ValueError(
                f"aux head needs a >=17x17 grid, got {x.shape[1]}x{x.shape[2]} "
                "(input >=299x299); use aux_logits=False for smaller inputs")
        x = _nchw(F.avg_pool2d, x, 5, 3)
        x = self.BasicConv_1(self.BasicConv_0(x, stats), stats)
        return F.linear(x.mean(dim=(1, 2)).float(), self.fc.weight, self.fc.bias)


class InceptionV3(nn.Module):
    """Inception-v3 over NHWC inputs (299x299 canonical; >= 75x75 with
    ``aux_logits=False``: the aux head raises below a 17x17 grid).

    ``forward(x, batch_stats, *, train=False, generator=None) -> (out,
    new_batch_stats)``: in training with ``aux_logits``, ``out`` is
    ``(logits, aux_logits)`` (the loss adds 0.3 x the aux cross-entropy),
    else ``logits``; logits are f32 ``[B, num_classes]``. Training with
    ``dropout_rate > 0`` needs ``generator``. In eval the running averages
    normalise, the aux head does not run and ``batch_stats`` comes back
    unchanged. Parameters are created on ``device`` (default the card;
    raises without one), drawn from ``generator`` (default: seeded with
    ``seed``) with the JAX package's initialisers.
    """

    def __init__(self, num_classes: int = 1000, aux_logits: bool = True,
                 dropout_rate: float = 0.5, dtype=torch.float32, fused: bool = False,
                 in_channels: int = 3, *, device="cuda", generator=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"dtype": dtype, "fused": fused}
        self.dtype = dtype
        self.aux_logits = aux_logits
        self.dropout_rate = dropout_rate
        for i, args in enumerate([(in_channels, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                                  (32, 64, 3), (64, 80, 1), (80, 192, 3, 1, "VALID")]):
            self.add_module(f"BasicConv_{i}", BasicConv(*args, **kw))
        blocks = [("InceptionA_0", InceptionA, (32,)), ("InceptionA_1", InceptionA, (64,)),
                  ("InceptionA_2", InceptionA, (64,)), ("InceptionB_0", InceptionB, ()),
                  ("InceptionC_0", InceptionC, (128,)), ("InceptionC_1", InceptionC, (160,)),
                  ("InceptionC_2", InceptionC, (160,)), ("InceptionC_3", InceptionC, (192,)),
                  ("InceptionD_0", InceptionD, ()), ("InceptionE_0", InceptionE, ()),
                  ("InceptionE_1", InceptionE, ())]
        cin = 192
        self.block_names = []
        for name, cls, args in blocks:
            block = cls(cin, *args, **kw)
            self.add_module(name, block)
            self.block_names.append(name)
            cin = block.features
            if name == "InceptionC_3" and aux_logits:
                self.aux = InceptionAux(cin, num_classes, **kw)
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
            if isinstance(mod, (Conv, BatchNorm)):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Linear):  # flax Dense: lecun-normal, zero bias
                truncated_normal_(mod.weight.data, 1.0, mod.in_features, generator)
                mod.bias.zero_()

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        """Running averages at init: mean 0, var 1, f32, on the model's device."""
        out = {}
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                out[f"{mod.key}.mean"] = torch.zeros(c, device=mod.weight.device)
                out[f"{mod.key}.var"] = torch.ones(c, device=mod.weight.device)
        return out

    def forward(self, x, batch_stats: dict, *, train: bool = False, generator=None):
        stats = BatchStats(batch_stats, train)
        x = x.to(self.dtype)
        for i in range(3):
            x = getattr(self, f"BasicConv_{i}")(x, stats)
        x = _max_pool(x)
        x = self.BasicConv_4(self.BasicConv_3(x, stats), stats)
        x = _max_pool(x)
        aux = None
        for name in self.block_names:
            x = getattr(self, name)(x, stats)
            if name == "InceptionC_3" and self.aux_logits and train:
                aux = self.aux(x, stats)
        x = dropout(x.mean(dim=(1, 2)), self.dropout_rate, train, generator)
        logits = F.linear(x.float(), self.head.weight, self.head.bias)
        out = (logits, aux) if aux is not None else logits
        return out, (stats.new if train else batch_stats)
