"""Conv building blocks (counterpart of
``keras_object_detection_tpu/models/layers.py`` ``ConvBlock`` and
``max_pool_2x2``).

Tensors run NCHW (in ``channels_last`` memory where the caller asks for it).
Parameters and BN statistics are float32; the conv runs in the block's
compute dtype, as flax's ``nn.Conv(dtype=...)`` casts its kernel and bias.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) zero padding of XLA's ``"SAME"``: the output has
    ``ceil(size / stride)`` positions and the low side gets the smaller half,
    so at stride 2 an odd total pads 0 low and 1 high."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class BatchNorm(nn.Module):
    """Inference BatchNorm in the arithmetic of the installed flax's
    ``_normalize``: ``y = (x.float() - mean) * (rsqrt(var + eps) * scale)
    + bias``, all in float32, cast to the input dtype once at the end.

    Training-mode statistics, and their running update (flax's biased
    variance, not ``nn.BatchNorm2d``'s unbiased one), belong to the training
    slice (ROADMAP 1.7)."""

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet (ROADMAP 1.7); "
                "call .eval() for inference")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        y = y + self.bias[:, None, None]
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """Conv parameters, OIHW weight and bias, initialised from an explicit
    generator: He-normal weight (std ``sqrt(2 / fan_in)``, so random
    activations keep their scale through a deep ReLU stack) and zero bias.
    The conv runs in the input's dtype, as flax's ``nn.Conv(dtype=...)``
    casts its kernel and bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: torch.Generator):
        super().__init__()
        std = math.sqrt(2.0 / (in_channels * kernel_size * kernel_size))
        weight = torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        self.weight = nn.Parameter(weight.normal_(0.0, std, generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        # the bias is added after the conv's output is rounded to x.dtype,
        # as flax does; a bias fused into the conv rounds once, and in
        # bfloat16 that drifts from the JAX forward by ~3x more
        y = F.conv2d(x, self.weight.to(x.dtype), None, stride, padding)
        return y + self.bias.to(x.dtype)[:, None, None]


class ConvBlock(nn.Module):
    """Zero padding -> Conv (with bias) -> BatchNorm -> ReLU / LeakyReLU(0.1).

    ``padding`` is an int (symmetric, the reference's ``ZeroPadding2D``) or
    ``"SAME"`` (XLA's rule, see ``same_padding``)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: Union[int, str] = 0,
                 activation: str = "relu",
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        if activation not in ("relu", "leaky_relu"):
            raise ValueError(f"unknown activation {activation!r}")
        if isinstance(padding, str) and padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        self.kernel_size = kernel_size
        self.strides = strides
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        self.conv = Conv2d(in_channels, filters, kernel_size, generator)
        self.bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor,
                strides: Optional[int] = None) -> torch.Tensor:
        """``strides`` overrides the constructor's, for a head whose stride
        follows the incoming feature size."""
        strides = self.strides if strides is None else strides
        x = x.to(self.dtype)
        if self.padding == "SAME":
            ph = same_padding(x.shape[2], self.kernel_size, strides)
            pw = same_padding(x.shape[3], self.kernel_size, strides)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                pad = (0, 0)
        else:
            pad = (self.padding, self.padding)
        x = self.conv(x, strides, pad)
        x = self.bn(x)
        if self.activation == "leaky_relu":
            return F.leaky_relu(x, 0.1)
        return F.relu(x)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool (VALID, like ``flax.linen.max_pool``)."""
    return F.max_pool2d(x, 2, 2)
