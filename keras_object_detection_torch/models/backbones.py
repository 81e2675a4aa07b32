"""Backbones and their registry (counterpart of
``keras_object_detection_tpu/models/backbones.py``): the darknet tables,
``VGG16Backbone`` and ``MobileNetV2Backbone``.

Each backbone takes an NCHW tensor in the model's compute dtype and returns
its features in that dtype; parameters are float32.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from keras_object_detection_torch.models.darknet import (ARCHITECTURES,
                                                         DarknetBackbone)
from keras_object_detection_torch.models.layers import (BatchNorm, Conv2d,
                                                        conv_same,
                                                        max_pool_2x2, relu6)

VGG16_WIDTHS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
MOBILENETV2_SCHEDULE = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class VGG16Backbone(nn.Module):
    """VGG16's feature extractor (Simonyan & Zisserman 2014): per stage of
    ``widths`` ``(width, convs)``, 3x3 SAME convs with bias, each followed
    by ReLU, then a 2x2 max pool. No BatchNorm. Output stride 32 (448 ->
    14x14x512). ``convs[k]`` is the JAX package's ``Conv_k``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 widths: Sequence[Tuple[int, int]] = VGG16_WIDTHS,
                 in_channels: int = 3, *, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.widths = tuple(tuple(w) for w in widths)
        self.convs = nn.ModuleList()
        channels = in_channels
        for width, reps in self.widths:
            for _ in range(reps):
                self.convs.append(Conv2d(channels, width, 3, generator))
                channels = width
        self.out_channels = channels

    def segments(self) -> List[Callable]:
        """The forward as pieces in order, for ``remat``: one a stage."""
        first = 0
        out = []
        for _, reps in self.widths:
            out.append(functools.partial(self._stage, first, reps))
            first += reps
        return out

    def _stage(self, first: int, reps: int, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for k in range(first, first + reps):
            x = F.relu(conv_same(self.convs[k], x))
        return max_pool_2x2(x)

    def forward(self, x: torch.Tensor,
                apply: Optional[Callable] = None) -> torch.Tensor:
        return _run(self.segments(), x, apply)


def _run(segments: List[Callable], x: torch.Tensor,
         apply: Optional[Callable]) -> torch.Tensor:
    """``segments`` in turn, each through ``apply(segment, x)`` (default:
    called), as ``DarknetBackbone.forward`` runs them."""
    for fn in segments:
        x = fn(x) if apply is None else apply(fn, x)
    return x


class _InvertedResidual(nn.Module):
    """MobileNetV2's inverted residual block (Sandler et al. 2018): a 1x1
    expansion to ``inp * expand`` channels (left out when ``expand == 1``),
    a 3x3 depthwise conv at ``strides`` (SAME: at stride 2 on an even size it
    pads 0 low and 1 high), a 1x1 projection to ``filters``; BatchNorm
    (momentum 0.999, eps 1e-3) after each conv, relu6 after the first two,
    convs without bias. The input is added back when ``strides == 1`` and
    ``inp == filters``. ``convs[j]`` / ``bns[j]`` are flax's ``Conv_j`` /
    ``BatchNorm_j``."""

    def __init__(self, inp: int, filters: int, strides: int, expand: int, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        hidden = inp * expand
        self.strides = strides
        self.residual = strides == 1 and inp == filters
        self.convs = nn.ModuleList()
        if expand != 1:
            self.convs.append(Conv2d(inp, hidden, 1, generator, bias=False))
        self.convs.append(Conv2d(hidden, hidden, 3, generator, bias=False,
                                 groups=hidden))
        self.convs.append(Conv2d(hidden, filters, 1, generator, bias=False))
        self.bns = nn.ModuleList(
            BatchNorm(c, 1e-3, bn_mode, momentum=0.999)
            for c in [hidden] * (len(self.convs) - 1) + [filters])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        *expand, depthwise, project = zip(self.convs, self.bns)
        for conv, bn in expand:
            x = relu6(bn(conv(x)))
        conv, bn = depthwise
        x = relu6(bn(conv_same(conv, x, self.strides)))
        conv, bn = project
        x = bn(conv(x))
        return x + residual if self.residual else x


class MobileNetV2Backbone(nn.Module):
    """MobileNetV2's feature extractor, output stride 32 (448 ->
    14x14x1280): a 3x3 stride-2 stem conv to 32 channels, the inverted
    residual blocks of the ``(t, c, n, s)`` ``schedule`` (the first block of
    each row at stride s, the rest at 1), a 1x1 conv to 1280; BatchNorm and
    relu6 after the stem and the last conv. ``convs`` = flax's ``Conv_0``
    (stem) and ``Conv_1`` (last), ``bns`` likewise, ``blocks[i]`` =
    ``_InvertedResidual_i``."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 schedule: Sequence[Tuple[int, int, int, int]] =
                 MOBILENETV2_SCHEDULE, in_channels: int = 3, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        self.dtype = dtype
        self.schedule = tuple(tuple(row) for row in schedule)
        bn = lambda c: BatchNorm(c, 1e-3, bn_mode, momentum=0.999)  # noqa: E731
        stem = Conv2d(in_channels, 32, 3, generator, bias=False)
        self.blocks = nn.ModuleList()
        channels = 32
        for t, c, n, s in self.schedule:
            for i in range(n):
                self.blocks.append(_InvertedResidual(
                    channels, c, s if i == 0 else 1, t, generator=generator,
                    bn_mode=bn_mode))
                channels = c
        self.convs = nn.ModuleList(
            [stem, Conv2d(channels, 1280, 1, generator, bias=False)])
        self.bns = nn.ModuleList([bn(32), bn(1280)])
        self.out_channels = 1280

    def segments(self) -> List[Callable]:
        """The forward as pieces in order, for ``remat``: the stem, each
        inverted residual block, the last conv."""
        return [self._stem, *self.blocks, self._last]

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bns[0](conv_same(self.convs[0], x.to(self.dtype), 2)))

    def _last(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bns[1](self.convs[1](x)))

    def forward(self, x: torch.Tensor,
                apply: Optional[Callable] = None) -> torch.Tensor:
        return _run(self.segments(), x, apply)


def _darknet(name: str, default_activation: str = "relu"):
    def build(dtype: torch.dtype, activation: str = default_activation, *,
              generator: torch.Generator, bn_mode: str = "flax",
              return_tap: bool = False,
              return_taps: int = 0) -> DarknetBackbone:
        return DarknetBackbone(ARCHITECTURES[name], activation, dtype,
                               generator=generator, bn_mode=bn_mode,
                               return_tap=return_tap, return_taps=return_taps)

    return build


def _vgg16(dtype: torch.dtype, activation: str = "relu", *,
           generator: torch.Generator, bn_mode: str = "flax") -> VGG16Backbone:
    return VGG16Backbone(dtype, generator=generator)


def _mobilenetv2(dtype: torch.dtype, activation: str = "relu", *,
                 generator: torch.Generator,
                 bn_mode: str = "flax") -> MobileNetV2Backbone:
    return MobileNetV2Backbone(dtype, generator=generator, bn_mode=bn_mode)


# ``activation`` applies to the darknet family; VGG16 and MobileNetV2 keep
# their own (ReLU, relu6). darknet19's and darknet53's LeakyReLU default is
# what the registry gives a caller that passes none; YoloV1 always passes the
# config's.
BACKBONES = {
    "darknet24": _darknet("darknet24"),
    "darknet19": _darknet("darknet19", "leaky_relu"),
    "darknet_tiny": _darknet("darknet_tiny"),
    "darknet_micro": _darknet("darknet_micro"),
    "darknet53": _darknet("darknet53", "leaky_relu"),
    "vgg16": _vgg16,
    "mobilenetv2": _mobilenetv2,
}
