"""Darknet-style YOLOv1 backbones driven by an architecture table
(counterpart of ``keras_object_detection_tpu/models/darknet.py``).

Table grammar: a tuple is ``(kernel_size, filters, stride, padding)``, ``"M"``
is a 2x2/2 max-pool, a list is ``[conv_a, conv_b, num_repeats]``. The
``("R", filters, repeats)`` residual entries of Darknet-53 (ROADMAP 1.11)
and the passthrough/pyramid taps (ROADMAP 1.10/1.11) are not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Sequence

import torch
from torch import nn

from keras_object_detection_torch.models.layers import ConvBlock, max_pool_2x2

# 24-conv YOLOv1 architecture (Redmon et al. 2016).
ARCHITECTURE_CONFIG: Sequence[Any] = (
    (7, 64, 2, 3),
    "M",
    (3, 192, 1, 1),
    "M",
    (1, 128, 1, 0),
    (3, 256, 1, 1),
    (1, 256, 1, 0),
    (3, 512, 1, 1),
    "M",
    [(1, 256, 1, 0), (3, 512, 1, 1), 4],
    (1, 512, 1, 0),
    (3, 1024, 1, 1),
    "M",
    [(1, 512, 1, 0), (3, 1024, 1, 1), 2],
    (3, 1024, 1, 1),
    (3, 1024, 2, 1),
    (3, 1024, 1, 1),
    (3, 1024, 1, 1),
)

# Darknet-19 (YOLOv2's backbone, arXiv:1612.08242 Table 6): 18 feature convs,
# alternating 3x3 / 1x1 bottlenecks, stride 32 (its 19th conv is the
# classifier, dropped for detection).
DARKNET19_CONFIG: Sequence[Any] = (
    (3, 32, 1, 1),
    "M",
    (3, 64, 1, 1),
    "M",
    (3, 128, 1, 1),
    (1, 64, 1, 0),
    (3, 128, 1, 1),
    "M",
    (3, 256, 1, 1),
    (1, 128, 1, 0),
    (3, 256, 1, 1),
    "M",
    (3, 512, 1, 1),
    (1, 256, 1, 0),
    (3, 512, 1, 1),
    (1, 256, 1, 0),
    (3, 512, 1, 1),
    "M",
    (3, 1024, 1, 1),
    (1, 512, 1, 0),
    (3, 1024, 1, 1),
    (1, 512, 1, 0),
    (3, 1024, 1, 1),
)

# Micro variant for fast tests (56x56 -> 7x7, 3 pools).
DARKNET_MICRO_CONFIG: Sequence[Any] = (
    (3, 16, 1, 1),
    "M",
    (3, 32, 1, 1),
    "M",
    (3, 64, 1, 1),
    "M",
    (3, 64, 1, 1),
)

# Small variant for CPU runs (224x224 -> 7x7).
DARKNET_TINY_CONFIG: Sequence[Any] = (
    (3, 16, 1, 1),
    "M",
    (3, 32, 1, 1),
    "M",
    (3, 64, 1, 1),
    "M",
    (3, 128, 1, 1),
    "M",
    (3, 256, 1, 1),
    "M",
    (3, 256, 1, 1),
)


# name -> architecture table (Darknet-53's residual table is ROADMAP 1.11)
ARCHITECTURES = {
    "darknet24": ARCHITECTURE_CONFIG,
    "darknet19": DARKNET19_CONFIG,
    "darknet_tiny": DARKNET_TINY_CONFIG,
    "darknet_micro": DARKNET_MICRO_CONFIG,
}


def _is_conv(entry) -> bool:
    return (isinstance(entry, (tuple, list)) and len(entry) == 4
            and all(isinstance(v, int) for v in entry))


class DarknetBackbone(nn.Module):
    """Walks an architecture table. ``blocks[i]`` is the i-th conv of the
    table in order, the JAX package's ``ConvBlock_{i}``."""

    def __init__(self, architecture: Sequence[Any] = ARCHITECTURE_CONFIG,
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, *, generator: torch.Generator,
                 return_tap: bool = False, return_taps: int = 0,
                 bn_mode: str = "flax"):
        super().__init__()
        if return_tap or return_taps:
            raise NotImplementedError(
                "backbone taps are not ported yet (ROADMAP 1.10 passthrough, "
                "1.11 FPN)")
        self.blocks = nn.ModuleList()
        self.plan = []  # "M" or an index into self.blocks
        channels = in_channels

        def conv(entry):
            nonlocal channels
            k, f, s, p = entry
            self.plan.append(len(self.blocks))
            self.blocks.append(ConvBlock(channels, f, k, s, p, activation,
                                         dtype, generator=generator,
                                         bn_mode=bn_mode))
            channels = f

        for entry in architecture:
            if isinstance(entry, str):
                if entry != "M":
                    raise ValueError(f"unknown table entry {entry!r}")
                self.plan.append("M")
            elif _is_conv(entry):
                conv(entry)
            elif entry[0] == "R":
                raise NotImplementedError(
                    "residual ('R', ...) entries are not ported yet "
                    "(ROADMAP 1.11)")
            else:
                conv_a, conv_b, repeats = entry
                for _ in range(repeats):
                    conv(conv_a)
                    conv(conv_b)
        self.out_channels = channels

    def segments(self) -> List[Callable]:
        """The forward as pieces in order, for ``remat``: each conv block
        with the pools that follow it."""
        groups: List[list] = []
        for step in self.plan:
            if step == "M" and groups:
                groups[-1][1] += 1
            else:
                groups.append([step, 0])
        return [functools.partial(self._segment, step, pools)
                for step, pools in groups]

    def _segment(self, step, pools: int, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_2x2(x) if step == "M" else self.blocks[step](x)
        for _ in range(pools):
            x = max_pool_2x2(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fn in self.segments():
            x = fn(x)
        return x
