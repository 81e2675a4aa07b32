"""YOLOv1 conv head and the assembled model (counterpart of
``keras_object_detection_tpu/models/yolo.py`` ``ConvHead``, ``YoloV1`` with
``head="conv"`` and ``build_model``).

The model takes NHWC float images and returns the grid-shaped
``(B, S, S, C + 5B)`` output, like the JAX package; inside it runs NCHW.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.models.backbones import BACKBONES
from keras_object_detection_torch.models.layers import Conv2d, ConvBlock

# head -> the ROADMAP item that ports it
_HEADS_TO_PORT = {"gap_dense": "1.9", "flatten_dense": "1.9",
                  "anchor": "1.10", "fpn": "1.11"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ConvHead(nn.Module):
    """Conv1024 3x3 SAME -> BN -> ReLU -> Conv(C + 5B) 1x1 in float32.

    The stride is ``max(H // grid, 1)`` of the incoming features, as in the
    JAX head: 1 for darknet backbones that already emit the grid size, 2 for
    14x14 features (where SAME pads 0 low and 1 high)."""

    def __init__(self, in_channels: int, cell_depth: int, grid: int = 7,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        self.grid = grid
        self.block = ConvBlock(in_channels, 1024, 3, padding="SAME",
                               dtype=dtype, generator=generator,
                               bn_mode=bn_mode)
        self.conv = Conv2d(1024, cell_depth, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block(x, max(x.shape[2] // self.grid, 1))
        return self.conv(x.float())


class YoloV1(nn.Module):
    """Backbone + conv head. ``forward`` maps ``(B, H, W, 3)`` float images
    to ``(B, S, S, C + 5B)`` float32 grids."""

    def __init__(self, backbone: str = "darknet24", grid: int = 7,
                 num_classes: int = 20, num_boxes: int = 2,
                 compute_dtype: torch.dtype = torch.float32,
                 activation: str = "relu", *, generator: torch.Generator,
                 bn_mode: str = "flax"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = BACKBONES[backbone](compute_dtype, activation,
                                            generator=generator,
                                            bn_mode=bn_mode)
        self.head = ConvHead(self.backbone.out_channels,
                             num_classes + 5 * num_boxes, grid, compute_dtype,
                             generator=generator, bn_mode=bn_mode)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view: its strides are channels_last, which the convs keep
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        y = self.head(self.backbone(x))
        return y.permute(0, 2, 3, 1).contiguous()


def build_model(config: Config,
                generator: Optional[torch.Generator] = None) -> YoloV1:
    """Build the model of ``config`` on the CPU in eval mode (``.train()``
    for training-mode BatchNorm, by ``config.model.bn_mode``), its weights
    drawn from ``generator`` (default: seeded with ``config.train.seed``).
    Move it with ``.to(device)``."""
    m, g = config.model, config.grid
    if m.head != "conv":
        raise NotImplementedError(
            f"head {m.head!r} is not ported yet "
            f"(ROADMAP {_HEADS_TO_PORT.get(m.head, '1.9')})")
    if m.passthrough:
        raise NotImplementedError("passthrough is not ported yet (ROADMAP 1.10)")
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(config.train.seed)
    model = YoloV1(m.backbone, g.grid, g.num_classes, g.num_boxes,
                   _DTYPES[m.compute_dtype], m.activation, generator=generator,
                   bn_mode=m.bn_mode)
    return model.eval()
