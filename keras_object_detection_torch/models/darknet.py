"""Darknet-style YOLOv1 backbones driven by an architecture table
(counterpart of ``keras_object_detection_tpu/models/darknet.py``).

Table grammar: a tuple is ``(kernel_size, filters, stride, padding)``, ``"M"``
is a 2x2/2 max-pool, a list is ``[conv_a, conv_b, num_repeats]``. The
``("R", filters, repeats)`` residual entries of Darknet-53 (ROADMAP 1.11)
and the passthrough/pyramid taps (ROADMAP 1.10/1.11) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for step in self.plan:
            x = max_pool_2x2(x) if step == "M" else self.blocks[step](x)
        return x
