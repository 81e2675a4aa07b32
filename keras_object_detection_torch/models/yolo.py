"""Detection heads and the assembled model (counterpart of
``keras_object_detection_tpu/models/yolo.py`` ``ConvHead``,
``PassthroughConvHead``, ``FPNHead``, ``GAPDenseHead``,
``MultiConvDenseHead``, ``YoloV1`` and ``build_model``).

The model takes NHWC float images and returns the grid-shaped
``(B, S, S, depth)`` output, like the JAX package (or, with
``flat_output``, ``(B, S*S*depth)``); inside it runs NCHW. ``depth`` is
``C + 5B`` for the v1 heads and ``B_anchors * (5 + C)`` for the anchor head.
The FPN head returns a tuple of such grids, one a scale, coarse -> fine.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.core.fpn import partition_anchors
from keras_object_detection_torch.models.backbones import BACKBONES
from keras_object_detection_torch.models.layers import (BatchNorm, Conv2d,
                                                        ConvBlock, Dense,
                                                        Dropout, remat,
                                                        space_to_depth)

HEADS = ("conv", "gap_dense", "flatten_dense", "anchor", "fpn")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# A training-mode dropout's keep mask, or the generator to draw it from
DropoutRng = Union[torch.Tensor, torch.Generator, None]


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

    def forward(self, x: torch.Tensor, dropout: DropoutRng = None) -> torch.Tensor:
        x = self.block(x, max(x.shape[2] // self.grid, 1))
        return self.conv(x.float()).permute(0, 2, 3, 1).contiguous()


class PassthroughConvHead(nn.Module):
    """The conv head with YOLOv2's passthrough connection: ``blocks[0]``
    (3x3 1024 SAME, stride ``max(H // grid, 1)``) on the features,
    ``blocks[1]`` (1x1 ``tap_filters``) on the 2x-resolution backbone tap,
    the tap folded to the grid by ``space_to_depth(block)``, the two
    concatenated as ``[x, tap]``, ``blocks[2]`` (3x3 1024 SAME) and a
    float32 1x1 conv (flax's ``ConvBlock_0..2`` and ``Conv_0``). The blocks
    use ReLU, as the JAX head's do, whatever the backbone's activation.

    ``block`` is the fold at the size the model was built for
    (``passthrough_block``); it fixes ``blocks[2]``'s input channels, and a
    tap that does not fold onto the features by it raises."""

    def __init__(self, in_channels: int, tap_channels: int, cell_depth: int,
                 block: int, grid: int = 7, tap_filters: int = 64,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        self.grid, self.block = grid, block
        kw = dict(dtype=dtype, generator=generator, bn_mode=bn_mode)
        self.blocks = nn.ModuleList([
            ConvBlock(in_channels, 1024, 3, padding="SAME", **kw),
            ConvBlock(tap_channels, tap_filters, 1, padding="SAME", **kw),
            ConvBlock(1024 + tap_filters * block * block, 1024, 3,
                      padding="SAME", **kw)])
        self.conv = Conv2d(1024, cell_depth, 1, generator)

    def forward(self, x: torch.Tensor, tap: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](x, max(x.shape[2] // self.grid, 1))
        tap = self.blocks[1](tap)
        block = tap.shape[2] // x.shape[2]
        if block != self.block or tap.shape[2] != x.shape[2] * block \
                or tap.shape[3] != x.shape[3] * block:
            raise ValueError(f"passthrough tap {tuple(tap.shape)} does not "
                             f"fold onto {tuple(x.shape)} by {self.block}")
        if block > 1:
            tap = space_to_depth(tap, block)
        x = torch.cat([x, tap.to(x.dtype)], dim=1)
        x = self.blocks[2](x.contiguous(memory_format=torch.channels_last))
        return self.conv(x.float()).permute(0, 2, 3, 1).contiguous()


class FPNHead(nn.Module):
    """YOLOv3's multi-scale head (arXiv:1804.02767 §2.3), fed the backbone's
    features and its ``num_scales - 1`` pyramid taps (coarse -> fine). Per
    scale at ``f`` channels (``base_filters``, halved a scale): a 5-conv
    1x1 / 3x3 trunk (``f``, ``2f``, ``f``, ``2f``, ``f``), a 3x3 ``2f``
    block and a float32 1x1 conv to ``cell_depth``; between scales a 1x1
    ``f / 2`` route block, a nearest 2x upsample and the concatenation
    ``[upsampled, tap]`` on channels. All blocks SAME, stride 1, in the
    model's ``activation``. ``blocks`` are flax's ``ConvBlock_0..`` in its
    creation order (per scale 5 trunk, the prediction block, the route
    block but after the last scale), ``convs[s]`` its ``Conv_s``.
    ``forward`` returns the per-scale NHWC float32 grids, coarse -> fine."""

    def __init__(self, in_channels: int, tap_channels: Sequence[int],
                 cell_depth: int, num_scales: int = 3, base_filters: int = 512,
                 activation: str = "leaky_relu",
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        if len(tap_channels) != num_scales - 1:
            raise ValueError(
                f"FPNHead with {num_scales} scales needs {num_scales - 1} "
                f"backbone taps, got {len(tap_channels)}")
        self.num_scales = num_scales
        kw = dict(padding="SAME", activation=activation, dtype=dtype,
                  generator=generator, bn_mode=bn_mode)
        self.blocks = nn.ModuleList()
        self.convs = nn.ModuleList()
        channels, f = in_channels, base_filters
        for s in range(num_scales):
            for k in (1, 3, 1, 3, 1):
                width = f if k == 1 else 2 * f
                self.blocks.append(ConvBlock(channels, width, k, **kw))
                channels = width
            self.blocks.append(ConvBlock(f, 2 * f, 3, **kw))
            self.convs.append(Conv2d(2 * f, cell_depth, 1, generator))
            if s + 1 < num_scales:
                f //= 2
                self.blocks.append(ConvBlock(channels, f, 1, **kw))
                channels = f + tap_channels[s]

    def forward(self, x: torch.Tensor, taps: Sequence[torch.Tensor]):
        if len(taps) != self.num_scales - 1:
            raise ValueError(
                f"FPNHead with {self.num_scales} scales needs "
                f"{self.num_scales - 1} backbone taps, got {len(taps)}")
        blocks = iter(self.blocks)
        outs = []
        for s in range(self.num_scales):
            for _ in range(5):
                x = next(blocks)(x)
            y = next(blocks)(x)
            outs.append(self.convs[s](y.float()).permute(0, 2, 3, 1)
                        .contiguous())
            if s + 1 < self.num_scales:
                # nearest 2x, as JAX's jnp.repeat twice: exact
                x = F.interpolate(next(blocks)(x), scale_factor=2,
                                  mode="nearest")
                tap = taps[s]
                if tap.shape[2:] != x.shape[2:]:
                    raise ValueError(
                        f"FPN tap {s} has spatial size {tap.shape[2]}, "
                        f"expected {x.shape[2]} (backbone taps must be "
                        "consecutive 2x-resolution steps)")
                x = torch.cat([x, tap.to(x.dtype)], dim=1).contiguous(
                    memory_format=torch.channels_last)
        return tuple(outs)


class GAPDenseHead(nn.Module):
    """Global average pool -> Dense(units) -> BN -> ReLU -> Dense(S*S*depth)
    in float32, reshaped to the grid. ``use_batchnorm=False`` is the
    reference's ``test_model`` head (no BN). The mean of bf16 features sums
    in float32 and rounds once, as ``jnp.mean`` does. ``denses[j]`` /
    ``bn`` are flax's ``Dense_j`` / ``BatchNorm_0``."""

    def __init__(self, in_channels: int, grid: int, cell_depth: int,
                 units: int = 4960, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        self.grid, self.cell_depth = grid, cell_depth
        self.denses = nn.ModuleList([
            Dense(in_channels, units, dtype, generator=generator),
            Dense(units, grid * grid * cell_depth, generator=generator)])
        self.bn = BatchNorm(units, bn_mode=bn_mode) if use_batchnorm else None

    def forward(self, x: torch.Tensor, dropout: DropoutRng = None) -> torch.Tensor:
        x = x.float().mean(dim=(2, 3)).to(x.dtype)
        x = self.denses[0](x)
        if self.bn is not None:
            x = self.bn(x)
        x = self.denses[1](F.relu(x).float())
        return x.reshape(x.shape[0], self.grid, self.grid, self.cell_depth)


class MultiConvDenseHead(nn.Module):
    """The VGG16 / MobileNetV2 variant head: 4x ConvBlock(1024, 3x3 SAME,
    stride 2 on the second) -> Flatten -> Dense stack (no activation between,
    as in the JAX head) -> Dropout(0.5) -> Dense(S*S*depth) in float32,
    reshaped to the grid. The NCHW features are flattened in NHWC order, as
    JAX flattens them, so converted Dense kernels line up. The rate is 0.5
    whatever ``ModelConfig.dropout_rate`` says: the JAX model never passes
    that field. ``blocks[i]`` / ``denses[j]`` are flax's ``ConvBlock_i`` /
    ``Dense_j``."""

    def __init__(self, in_channels: int, grid: int, cell_depth: int,
                 feature_size: int, dense_units: Sequence[int] = (512, 1024),
                 dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        self.grid, self.cell_depth = grid, cell_depth
        self.blocks = nn.ModuleList()
        channels, size = in_channels, feature_size
        for stride in (1, 2, 1, 1):
            self.blocks.append(ConvBlock(channels, 1024, 3, stride, "SAME",
                                         dtype=dtype, generator=generator,
                                         bn_mode=bn_mode))
            channels, size = 1024, -(-size // stride)
        widths = [channels * size * size, *dense_units]
        self.denses = nn.ModuleList(
            Dense(a, b, dtype, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        self.denses.append(Dense(widths[-1], grid * grid * cell_depth,
                                 generator=generator))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, dropout: DropoutRng = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        *stack, last = self.denses
        for dense in stack:
            x = dense(x)
        x = last(self.dropout(x, dropout).float())
        return x.reshape(x.shape[0], self.grid, self.grid, self.cell_depth)


@functools.lru_cache(maxsize=None)
def backbone_feature_size(backbone: str, image_size: int) -> int:
    """The side of the feature map ``backbone`` emits at ``image_size``,
    from a forward of a copy on PyTorch's ``meta`` device (shapes only, as
    JAX's ``eval_shape``), kept per (backbone, size)."""
    with torch.device("meta"):
        probe = BACKBONES[backbone](torch.float32, generator=torch.Generator())
        return probe.eval()(torch.empty(1, 3, image_size, image_size)).shape[-1]


@functools.lru_cache(maxsize=None)
def passthrough_block(backbone: str, image_size: int, grid: int) -> int:
    """The passthrough fold of a darknet ``backbone`` at ``image_size``: the
    tap's side over the side of the head's first block's output (stride
    ``max(feat // grid, 1)``, SAME), from a forward on the ``meta``
    device."""
    with torch.device("meta"):
        probe = BACKBONES[backbone](torch.float32, generator=torch.Generator(),
                                    return_tap=True)
        x, tap = probe.eval()(torch.empty(1, 3, image_size, image_size))
    feat = x.shape[-1]
    side = -(-feat // max(feat // grid, 1))
    return max(tap.shape[-1] // side, 1)


class YoloV1(nn.Module):
    """Backbone + head. ``forward`` maps ``(B, H, W, 3)`` float images to
    ``(B, S, S, C + 5B)`` float32 grids (``flat_output``: ``(B,
    S*S*(C + 5B))``).

    ``freeze_backbone`` is Keras's ``trainable=False``: the backbone stays in
    eval mode whatever ``train()`` says (its BatchNorms normalise with their
    running statistics and never update them) and runs without gradient, so
    its backward is never built. ``dropout`` of ``forward`` is the
    flatten_dense head's keep mask or the generator to draw it from; the
    other heads ignore it.

    ``remat_policy`` (``"full"`` or ``"dots"``, None for off) recomputes the
    activations of a training forward in the backward (``layers.remat``),
    segment by segment: each piece of ``backbone.segments()`` and the head.
    Values and running statistics are those of the forward without it.

    ``head="anchor"`` emits ``len(anchors) * (5 + C)`` a cell through
    ``ConvHead`` or, with ``passthrough`` (darknet backbones only),
    ``PassthroughConvHead`` fed the backbone's tap. ``head="fpn"`` (darknet
    backbones only) splits the anchors over ``fpn_scales`` scales
    (``core.fpn.partition_anchors``) and returns ``FPNHead``'s tuple of
    ``(B, S_s, S_s, B_s * (5 + C))`` grids, the backbone giving it its
    ``fpn_scales - 1`` pyramid taps."""

    def __init__(self, backbone: str = "darknet24", head: str = "conv",
                 grid: int = 7, num_classes: int = 20, num_boxes: int = 2,
                 compute_dtype: torch.dtype = torch.float32,
                 activation: str = "relu", *, generator: torch.Generator,
                 bn_mode: str = "flax", image_size: int = 448,
                 head_dense_units: int = 4960, head_batchnorm: bool = True,
                 flat_output: bool = False, freeze_backbone: bool = False,
                 remat_policy: Optional[str] = None, anchors: tuple = (),
                 passthrough: bool = False, fpn_scales: int = 3):
        super().__init__()
        self.remat_policy = remat_policy
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; options: {HEADS}")
        if head == "fpn":
            if not anchors:
                raise ValueError(
                    "head='fpn' requires GridConfig.anchors (fit "
                    "3*num_scales with python -m "
                    "keras_object_detection_torch.cli.kmeans_anchors)")
            per = len(partition_anchors(anchors, fpn_scales)[0])
            if passthrough:
                raise ValueError("passthrough is a YOLOv2 anchor-head knob; "
                                 "the fpn head has its own lateral taps")
            if not backbone.startswith("darknet"):
                raise ValueError(f"head='fpn' supports darknet backbones "
                                 f"only (pyramid taps), got {backbone!r}")
        if passthrough:
            if head != "anchor":
                raise ValueError("passthrough requires head='anchor'")
            if not backbone.startswith("darknet"):
                raise ValueError(f"passthrough supports darknet backbones "
                                 f"only, got {backbone!r}")
        if head == "anchor" and not anchors:
            raise ValueError("head='anchor' requires GridConfig.anchors (fit "
                             "with python -m "
                             "keras_object_detection_torch.cli.kmeans_anchors)")
        self.compute_dtype = compute_dtype
        self.flat_output = flat_output
        self.freeze_backbone = freeze_backbone
        self.passthrough = passthrough
        self.fpn = head == "fpn"
        taps = ({"return_tap": True} if passthrough else
                {"return_taps": fpn_scales - 1} if self.fpn else {})
        self.backbone = BACKBONES[backbone](
            compute_dtype, activation, generator=generator, bn_mode=bn_mode,
            **taps)
        depth = (len(anchors) * (5 + num_classes) if head == "anchor"
                 else per * (5 + num_classes) if self.fpn
                 else num_classes + 5 * num_boxes)
        channels = self.backbone.out_channels
        if self.fpn:
            self.head = FPNHead(channels, self.backbone.tap_channels, depth,
                                fpn_scales, activation=activation,
                                dtype=compute_dtype, generator=generator,
                                bn_mode=bn_mode)
        elif passthrough:
            self.head = PassthroughConvHead(
                channels, self.backbone.tap_channels, depth,
                passthrough_block(backbone, image_size, grid), grid,
                dtype=compute_dtype, generator=generator, bn_mode=bn_mode)
        elif head in ("conv", "anchor"):
            self.head = ConvHead(channels, depth, grid, compute_dtype,
                                 generator=generator, bn_mode=bn_mode)
        elif head == "gap_dense":
            self.head = GAPDenseHead(channels, grid, depth, head_dense_units,
                                     head_batchnorm, compute_dtype,
                                     generator=generator, bn_mode=bn_mode)
        else:
            units = (4096,) if backbone == "mobilenetv2" else (512, 1024)
            self.head = MultiConvDenseHead(
                channels, grid, depth,
                backbone_feature_size(backbone, image_size), units,
                dtype=compute_dtype, generator=generator, bn_mode=bn_mode)
        if freeze_backbone:
            self.backbone.eval()

    def draw_dropout(self, batch: int,
                     generator: torch.Generator) -> Optional[torch.Tensor]:
        """The keep mask of a training-mode forward at ``batch`` images,
        drawn on the CPU from ``generator``; None for a head without
        dropout."""
        if not isinstance(self.head, MultiConvDenseHead):
            return None
        units = self.head.denses[-1].weight.shape[1]
        return self.head.dropout.draw((batch, units), generator)

    def train(self, mode: bool = True) -> "YoloV1":
        super().train(mode)
        if self.freeze_backbone:
            self.backbone.eval()
        return self

    def forward(self, images: torch.Tensor, dropout: DropoutRng = None):
        # NHWC -> NCHW view: its strides are channels_last, which the convs keep
        x = images.to(self.compute_dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        policy = (self.remat_policy if self.training
                  and torch.is_grad_enabled() else None)
        if self.freeze_backbone:
            with torch.no_grad():
                feats = self.backbone(x)
        elif policy:
            # each segment recomputed in the backward; a tap is the input of
            # its segment: a remat boundary, kept once
            feats = self.backbone(x, lambda fn, x: remat(fn, self, policy, x))
        else:
            feats = self.backbone(x)
        # (x, tap) with passthrough, (x, taps) with the FPN head
        args = feats if self.passthrough or self.fpn else (feats, dropout)
        y = remat(self.head, self, policy, *args) if policy else self.head(*args)
        if self.flat_output and not self.fpn:
            return y.reshape(y.shape[0], -1)
        return y


def build_model(config: Config,
                generator: Optional[torch.Generator] = None) -> YoloV1:
    """Build the model of ``config`` on the CPU in eval mode (``.train()``
    for training-mode BatchNorm, by ``config.model.bn_mode``), its weights
    drawn from ``generator`` (default: seeded with ``config.train.seed``).
    Move it with ``.to(device)``."""
    m, g = config.model, config.grid
    if m.compute_dtype not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(config.train.seed)
    model = YoloV1(m.backbone, m.head, g.grid, g.num_classes, g.num_boxes,
                   _DTYPES[m.compute_dtype], m.activation, generator=generator,
                   bn_mode=m.bn_mode, image_size=m.image_size,
                   head_dense_units=m.head_dense_units,
                   head_batchnorm=m.head_batchnorm,
                   freeze_backbone=m.freeze_backbone,
                   remat_policy=(("dots" if m.remat_policy == "dots" else "full")
                                 if m.remat else None),
                   anchors=g.anchors, passthrough=m.passthrough,
                   fpn_scales=m.fpn_scales)
    return model.eval()
