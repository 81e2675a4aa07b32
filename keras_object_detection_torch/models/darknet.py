"""Darknet-style YOLOv1 backbones driven by an architecture table
(counterpart of ``keras_object_detection_tpu/models/darknet.py``).

Table grammar: a tuple is ``(kernel_size, filters, stride, padding)``, ``"M"``
is a 2x2/2 max-pool, a list is ``[conv_a, conv_b, num_repeats]``. The
``("R", filters, repeats)`` entry is Darknet-53's residual stage: each repeat
a 1x1 (filters / 2) -> 3x3 (filters) bottleneck added back to its input.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Sequence

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

# Darknet-53 (YOLOv3's backbone, arXiv:1804.02767 Table 1): stride-2 convs
# downsample (no pools), residual stages between them; 52 feature convs (its
# 53rd is the classifier), stride 32. The features before the last two
# downsamples (stride 16 and 8) are the FPN head's pyramid taps.
DARKNET53_CONFIG: Sequence[Any] = (
    (3, 32, 1, 1),
    (3, 64, 2, 1),
    ("R", 64, 1),
    (3, 128, 2, 1),
    ("R", 128, 2),
    (3, 256, 2, 1),
    ("R", 256, 8),
    (3, 512, 2, 1),
    ("R", 512, 8),
    (3, 1024, 2, 1),
    ("R", 1024, 4),
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


# name -> architecture table
ARCHITECTURES = {
    "darknet24": ARCHITECTURE_CONFIG,
    "darknet19": DARKNET19_CONFIG,
    "darknet53": DARKNET53_CONFIG,
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


class DarknetBackbone(nn.Module):
    """Walks an architecture table. ``blocks[i]`` is the i-th conv of the
    table in order, the JAX package's ``ConvBlock_{i}`` (a residual unit's
    two convs take the next two indices).

    ``return_tap=True`` makes ``forward`` return ``(features, tap)``, the
    tap being the feature map just before the table's last downsample (the
    2x-resolution source of the YOLOv2 passthrough head). ``return_taps=N``
    instead returns ``(features, taps)``, the feature maps before each of
    the last N downsamples, coarse -> fine (the FPN head's pyramid). Each
    tap's downsample starts a segment of its own (``tap_segments``, coarse
    -> fine), so a caller that runs ``segments()`` one by one (``remat``)
    takes each tap as that segment's input: the output of the segment
    before it, computed once. ``tap_channels`` are the taps' channels."""

    def __init__(self, architecture: Sequence[Any] = ARCHITECTURE_CONFIG,
                 activation: str = "relu", dtype: torch.dtype = torch.float32,
                 in_channels: int = 3, *, generator: torch.Generator,
                 return_tap: bool = False, return_taps: int = 0,
                 bn_mode: str = "flax"):
        super().__init__()
        if return_tap and return_taps:
            raise ValueError("return_tap and return_taps are exclusive")
        self.return_tap = return_tap
        self.return_taps = return_taps
        n_taps = 1 if return_tap else return_taps
        self.blocks = nn.ModuleList()
        # "M", an index into self.blocks, or ("R", i): the residual unit of
        # blocks i and i + 1
        self.plan: list = []
        channels = in_channels
        tap_entries = {}  # table index -> tap (0 the coarsest)
        if n_taps:
            ds = _downsample_indices(architecture)
            if len(ds) < n_taps:
                raise ValueError(f"{n_taps} taps need {n_taps} downsamples; "
                                 f"the table has {len(ds)}")
            tap_entries = {idx: n_taps - 1 - j
                           for j, idx in enumerate(ds[-n_taps:])}
        tap_steps = {}  # plan position of a tap's downsample -> tap
        tap_channels = [0] * n_taps

        def conv(entry):
            nonlocal channels
            k, f, s, p = entry
            self.blocks.append(ConvBlock(channels, f, k, s, p, activation,
                                         dtype, generator=generator,
                                         bn_mode=bn_mode))
            channels = f

        for i, entry in enumerate(architecture):
            if i in tap_entries:
                tap_steps[len(self.plan)] = tap_entries[i]
                tap_channels[tap_entries[i]] = channels
            if isinstance(entry, str):
                if entry != "M":
                    raise ValueError(f"unknown table entry {entry!r}")
                self.plan.append("M")
            elif _is_conv(entry):
                self.plan.append(len(self.blocks))
                conv(entry)
            elif entry[0] == "R":
                _, f, repeats = entry
                for _ in range(repeats):
                    self.plan.append(("R", len(self.blocks)))
                    conv((1, f // 2, 1, 0))
                    conv((3, f, 1, 1))
            else:
                conv_a, conv_b, repeats = entry
                for _ in range(repeats):
                    self.plan.append(len(self.blocks))
                    conv(conv_a)
                    self.plan.append(len(self.blocks))
                    conv(conv_b)
        self.out_channels = channels
        self.tap_channels = (tap_channels[0] if return_tap
                             else tuple(tap_channels))
        # pieces of the forward: a conv block or residual unit with the pools
        # that follow it, each tap's downsample starting a piece of its own
        self._groups: List[list] = []
        segments = [0] * n_taps
        for i, step in enumerate(self.plan):
            if i in tap_steps:
                segments[tap_steps[i]] = len(self._groups)
            if step == "M" and self._groups and i not in tap_steps:
                self._groups[-1][1] += 1
            else:
                self._groups.append([step, 0])
        self.tap_segments = tuple(segments)

    def segments(self) -> List[Callable]:
        """The forward as pieces in order, for ``remat`` (see the class
        docstring for the taps)."""
        return [functools.partial(self._segment, step, pools)
                for step, pools in self._groups]

    def _segment(self, step, pools: int, x: torch.Tensor) -> torch.Tensor:
        if step == "M":
            x = max_pool_2x2(x)
        elif isinstance(step, tuple):  # residual unit: x + 3x3(1x1(x))
            x = x + self.blocks[step[1] + 1](self.blocks[step[1]](x))
        else:
            x = self.blocks[step](x)
        for _ in range(pools):
            x = max_pool_2x2(x)
        return x

    def forward(self, x: torch.Tensor,
                apply: Optional[Callable] = None):
        """``apply(segment, x)`` runs each segment (default: calls it), as
        ``YoloV1`` does under ``remat``."""
        taps = [None] * len(self.tap_segments)
        for i, fn in enumerate(self.segments()):
            for j, seg in enumerate(self.tap_segments):
                if seg == i:
                    taps[j] = x
            x = fn(x) if apply is None else apply(fn, x)
        if self.return_tap:
            return x, taps[0]
        return (x, tuple(taps)) if self.return_taps else x
