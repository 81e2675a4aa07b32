"""Darknet-style YOLOv1 backbones driven by an architecture table
(counterpart of ``keras_object_detection_tpu/models/darknet.py``).

Table grammar: a tuple is ``(kernel_size, filters, stride, padding)``, ``"M"``
is a 2x2/2 max-pool, a list is ``[conv_a, conv_b, num_repeats]``. The
``("R", filters, repeats)`` residual entries of Darknet-53 and the FPN's
pyramid taps (ROADMAP 1.11) are not ported yet.
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


def _downsample_indices(architecture: Sequence[Any]) -> List[int]:
    """Indices of the table's downsampling entries (pools and stride-2
    convs), in order. Repeat and residual blocks are always stride 1, so
    only scalar entries count."""
    return [i for i, entry in enumerate(architecture)
            if isinstance(entry, str) or (_is_conv(entry) and entry[2] > 1)]


def _last_downsample_index(architecture: Sequence[Any]) -> int:
    """Index of the last downsampling entry (-1 if none): the YOLOv2
    passthrough tap is the feature map just before it."""
    ds = _downsample_indices(architecture)
    return ds[-1] if ds else -1


class DarknetBackbone(nn.Module):
    """Walks an architecture table. ``blocks[i]`` is the i-th conv of the
    table in order, the JAX package's ``ConvBlock_{i}``.

    ``return_tap=True`` makes ``forward`` return ``(features, tap)``, the
    tap being the feature map just before the table's last downsample (the
    2x-resolution source of the YOLOv2 passthrough head). The tap starts a
    segment of its own (``tap_segment``), so a caller that runs
    ``segments()`` one by one (``remat``) takes it as that segment's input:
    the output of the segment before it, computed once."""

    def __init__(self, architecture: Sequence[Any] = ARCHITECTURE_CONFIG,
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, *, generator: torch.Generator,
                 return_tap: bool = False, return_taps: int = 0,
                 bn_mode: str = "flax"):
        super().__init__()
        if return_taps:
            raise NotImplementedError(
                "the FPN's pyramid taps are not ported yet (ROADMAP 1.11)")
        self.return_tap = return_tap
        self.blocks = nn.ModuleList()
        self.plan = []  # "M" or an index into self.blocks
        channels = in_channels
        tap_entry = _last_downsample_index(architecture) if return_tap else None
        if return_tap and tap_entry < 0:
            raise ValueError("1 taps need 1 downsamples; the table has 0")
        tap_step = None  # the plan position of the tap's downsample

        def conv(entry):
            nonlocal channels
            k, f, s, p = entry
            self.plan.append(len(self.blocks))
            self.blocks.append(ConvBlock(channels, f, k, s, p, activation,
                                         dtype, generator=generator,
                                         bn_mode=bn_mode))
            channels = f

        for i, entry in enumerate(architecture):
            if i == tap_entry:
                tap_step = len(self.plan)
                self.tap_channels = channels
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
        # pieces of the forward: a conv block with the pools that follow it,
        # the tap's downsample starting a piece of its own
        self._groups: List[list] = []
        self.tap_segment = None
        for i, step in enumerate(self.plan):
            if i == tap_step:
                self.tap_segment = len(self._groups)
            if step == "M" and self._groups and i != tap_step:
                self._groups[-1][1] += 1
            else:
                self._groups.append([step, 0])

    def segments(self) -> List[Callable]:
        """The forward as pieces in order, for ``remat`` (see the class
        docstring for the tap)."""
        return [functools.partial(self._segment, step, pools)
                for step, pools in self._groups]

    def _segment(self, step, pools: int, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_2x2(x) if step == "M" else self.blocks[step](x)
        for _ in range(pools):
            x = max_pool_2x2(x)
        return x

    def forward(self, x: torch.Tensor):
        tap = None
        for i, fn in enumerate(self.segments()):
            if i == self.tap_segment:
                tap = x
            x = fn(x)
        return (x, tap) if self.return_tap else x
