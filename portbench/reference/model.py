"""The plain reference of the two detectors the benchmark runs, in float32:
a Darknet backbone walked from its architecture table, then YOLOv1's conv
head (3x3 1024 block, 1x1 conv to ``C + 5B``) or YOLOv3's three-scale FPN
head (arXiv:1804.02767 §2.3). Every conv block is zero padding -> conv with
bias -> BatchNorm (batch statistics in training, running ones in eval; eps
1e-3, momentum 0.99, the biased variance ``max(E[x^2] - E[x]^2, 0)``) ->
ReLU or LeakyReLU(0.1).

Parameter and buffer names are those of the system's ``state_dict``, so one
dict of weights loads into both. ``lowp``, where given, rounds the input,
the weight and the output of every convolution (the lower-precision control
of ``lowp.py``); it is None for the reference itself.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Round = Optional[Callable[[torch.Tensor], torch.Tensor]]

# (kernel, filters, stride, padding), "M" a 2x2 max pool, [a, b, repeats] a
# repeated pair, ("R", filters, repeats) Darknet-53's residual stage.
DARKNET24 = (
    (7, 64, 2, 3), "M", (3, 192, 1, 1), "M", (1, 128, 1, 0), (3, 256, 1, 1),
    (1, 256, 1, 0), (3, 512, 1, 1), "M", [(1, 256, 1, 0), (3, 512, 1, 1), 4],
    (1, 512, 1, 0), (3, 1024, 1, 1), "M",
    [(1, 512, 1, 0), (3, 1024, 1, 1), 2], (3, 1024, 1, 1), (3, 1024, 2, 1),
    (3, 1024, 1, 1), (3, 1024, 1, 1))
DARKNET53 = (
    (3, 32, 1, 1), (3, 64, 2, 1), ("R", 64, 1), (3, 128, 2, 1), ("R", 128, 2),
    (3, 256, 2, 1), ("R", 256, 8), (3, 512, 2, 1), ("R", 512, 8),
    (3, 1024, 2, 1), ("R", 1024, 4))
DARKNET_MICRO = ((3, 16, 1, 1), "M", (3, 32, 1, 1), "M", (3, 64, 1, 1), "M",
                 (3, 64, 1, 1))
TABLES = {"darknet24": DARKNET24, "darknet53": DARKNET53,
          "darknet_micro": DARKNET_MICRO}


def same_padding(size: int, kernel: int, stride: int):
    """(low, high) padding of ``"SAME"``: ``ceil(size / stride)`` outputs,
    the low side the smaller half."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, lowp: Round):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.lowp = lowp

    def forward(self, x, stride=1, padding=(0, 0)):
        if self.lowp is None:
            return (F.conv2d(x, self.weight, None, stride, padding)
                    + self.bias[:, None, None])
        y = F.conv2d(self.lowp(x), self.lowp(self.weight), None, stride,
                     padding)
        return self.lowp(y + self.bias[:, None, None])


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        # 0.99 as the system's; the weight maker sets 0 to copy one batch's
        # statistics into the running ones
        self.momentum = 0.99

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-3) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, leaky=False,
                 lowp: Round = None):
        super().__init__()
        self.conv = Conv(cin, cout, k, lowp)
        self.bn = BatchNorm(cout)
        self.stride, self.padding, self.leaky = stride, padding, leaky

    def forward(self, x, stride=None):
        stride = self.stride if stride is None else stride
        k = self.conv.weight.shape[-1]
        if self.padding == "SAME":
            ph = same_padding(x.shape[2], k, stride)
            pw = same_padding(x.shape[3], k, stride)
            x = self.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), stride)
        else:
            x = self.conv(x, stride, (self.padding, self.padding))
        x = self.bn(x)
        return F.leaky_relu(x, 0.1) if self.leaky else F.relu(x)


class Darknet(nn.Module):
    """The table's conv blocks in order (``blocks[i]``); with ``taps`` the
    feature maps before the last ``taps`` downsamples, coarse -> fine."""

    def __init__(self, table: Sequence, leaky: bool, taps: int, lowp: Round):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.plan = []
        channels = 3
        downs = [i for i, e in enumerate(table)
                 if e == "M" or (isinstance(e, tuple) and len(e) == 4
                                 and e[2] > 1)]
        tap_at = {idx: taps - 1 - j for j, idx in enumerate(downs[-taps:])} \
            if taps else {}
        self.tap_channels = [0] * taps

        def conv(k, f, s, p):
            nonlocal channels
            self.blocks.append(ConvBlock(channels, f, k, s, p, leaky, lowp))
            channels = f

        for i, e in enumerate(table):
            if i in tap_at:
                self.plan.append(("tap", tap_at[i]))
                self.tap_channels[tap_at[i]] = channels
            if e == "M":
                self.plan.append(("pool",))
            elif isinstance(e, tuple) and e[0] == "R":
                for _ in range(e[2]):
                    self.plan.append(("res", len(self.blocks)))
                    conv(1, e[1] // 2, 1, 0)
                    conv(3, e[1], 1, 1)
            elif isinstance(e, tuple):
                self.plan.append(("conv", len(self.blocks)))
                conv(*e)
            else:
                a, b, repeats = e
                for _ in range(repeats):
                    self.plan.append(("conv", len(self.blocks)))
                    conv(*a)
                    self.plan.append(("conv", len(self.blocks)))
                    conv(*b)
        self.out_channels = channels

    def forward(self, x):
        taps = [None] * len(self.tap_channels)
        for step in self.plan:
            if step[0] == "tap":
                taps[step[1]] = x
            elif step[0] == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif step[0] == "res":
                x = x + self.blocks[step[1] + 1](self.blocks[step[1]](x))
            else:
                x = self.blocks[step[1]](x)
        return x, taps


class ConvHead(nn.Module):
    def __init__(self, cin, depth, grid, lowp: Round):
        super().__init__()
        self.grid = grid
        self.block = ConvBlock(cin, 1024, 3, padding="SAME", lowp=lowp)
        self.conv = Conv(1024, depth, 1, lowp)

    def forward(self, x, taps):
        x = self.block(x, max(x.shape[2] // self.grid, 1))
        return self.conv(x).permute(0, 2, 3, 1)


class FPNHead(nn.Module):
    """Per scale at ``f`` channels (512, halved a scale): the 1x1 / 3x3
    trunk of five blocks, a 3x3 ``2f`` block and a 1x1 conv to the depth;
    between scales a 1x1 ``f / 2`` block, a nearest 2x upsample and the
    concatenation with the backbone's tap."""

    def __init__(self, cin, tap_channels, depth, scales, leaky: bool,
                 lowp: Round):
        super().__init__()
        self.scales = scales
        self.blocks = nn.ModuleList()
        self.convs = nn.ModuleList()
        kw = dict(padding="SAME", leaky=leaky, lowp=lowp)
        channels, f = cin, 512
        for s in range(scales):
            for k in (1, 3, 1, 3, 1):
                width = f if k == 1 else 2 * f
                self.blocks.append(ConvBlock(channels, width, k, **kw))
                channels = width
            self.blocks.append(ConvBlock(f, 2 * f, 3, **kw))
            self.convs.append(Conv(2 * f, depth, 1, lowp))
            if s + 1 < scales:
                f //= 2
                self.blocks.append(ConvBlock(channels, f, 1, **kw))
                channels = f + tap_channels[s]

    def forward(self, x, taps):
        blocks = iter(self.blocks)
        outs = []
        for s in range(self.scales):
            for _ in range(5):
                x = next(blocks)(x)
            outs.append(self.convs[s](next(blocks)(x)).permute(0, 2, 3, 1))
            if s + 1 < self.scales:
                x = F.interpolate(next(blocks)(x), scale_factor=2,
                                  mode="nearest")
                x = torch.cat([x, taps[s]], dim=1)
        return tuple(outs)


class Detector(nn.Module):
    """``(B, H, W, 3)`` float images in [0, 1] -> the ``(B, S, S, depth)``
    grid (conv head) or the per-scale grids, coarse -> fine (FPN head)."""

    def __init__(self, cfg: dict, lowp: Round = None):
        super().__init__()
        m, g = cfg["model"], cfg["grid"]
        fpn = m["head"] == "fpn"
        if m["head"] not in ("conv", "fpn"):
            raise ValueError(f"the reference has no {m['head']!r} head")
        scales = m["fpn_scales"] if fpn else 0
        leaky = m["activation"] == "leaky_relu"
        self.backbone = Darknet(TABLES[m["backbone"]], leaky,
                                scales - 1 if fpn else 0, lowp)
        c = g["num_classes"]
        if fpn:
            per = len(g["anchors"]) // scales
            self.head = FPNHead(self.backbone.out_channels,
                                self.backbone.tap_channels, per * (5 + c),
                                scales, leaky, lowp)
        else:
            self.head = ConvHead(self.backbone.out_channels,
                                 c + 5 * g["num_boxes"], g["grid"], lowp)

    def forward(self, images):
        x, taps = self.backbone(images.permute(0, 3, 1, 2))
        return self.head(x, taps)
