"""Multi-scale anchor grids of the FPN family, YOLOv3 (counterpart of
``keras_object_detection_tpu/core/fpn.py``): ``fpn_grid_sizes``,
``partition_anchors``, ``encode_fpn_grids``, ``decode_fpn_grids`` and
``decode_fpn_targets``.

``GridConfig.grid`` is the coarsest grid (the stride-32 map, 13 at 416²);
scale ``s`` detects on an ``S * 2**s`` grid, so 3 scales give YOLOv3's
13 / 26 / 52. The priors are split by area, the largest third on the
coarsest grid. Per scale the slot layout, targets and decode are the anchor
family's (``core/anchors.py``): a box goes to the scale that owns its best
prior over all scales, then to that (cell, prior) slot within the scale.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from keras_object_detection_torch.core.anchors import (Anchors, _anchor_tensor,
                                                       _shape_iou,
                                                       decode_anchor_grid,
                                                       decode_anchor_targets,
                                                       encode_anchor_grid)


def fpn_grid_sizes(grid: int, num_scales: int = 3) -> Tuple[int, ...]:
    """Grid side per scale, coarse -> fine: ``(S, 2S, 4S, ...)``."""
    return tuple(grid * (2 ** s) for s in range(num_scales))


def partition_anchors(anchors: Anchors, num_scales: int = 3
                      ) -> Tuple[Tuple[Tuple[float, float], ...], ...]:
    """The priors in per-scale groups, coarse scale first: sorted by area,
    largest first (a stable sort: equal areas keep their order), and cut
    into ``num_scales`` equal chunks. Raises ``ValueError`` unless the count
    divides evenly."""
    anchors = tuple(tuple(a) for a in anchors)
    if not anchors or len(anchors) % num_scales:
        raise ValueError(
            f"FPN needs len(anchors) divisible by num_scales={num_scales}, "
            f"got {len(anchors)} (fit 3*num_scales with python -m "
            "keras_object_detection_torch.cli.kmeans_anchors)")
    per = len(anchors) // num_scales
    by_area = sorted(anchors, key=lambda a: -(a[0] * a[1]))
    return tuple(tuple(by_area[s * per:(s + 1) * per])
                 for s in range(num_scales))


def encode_fpn_grids(boxes: torch.Tensor, valid: torch.Tensor,
                     num_classes: int, anchors: Anchors, grid: int = 13,
                     num_scales: int = 3) -> Tuple[torch.Tensor, ...]:
    """Encode padded ``(batch, N, 5)`` boxes (``valid`` their ``(batch,
    N)`` mask) into per-scale ``(batch, S_s, S_s, B_s * (5 + C))`` anchor
    targets, coarse -> fine. A box goes to the scale of its best prior over
    all scales (``argmax`` over the partitioned priors: the first maximum),
    and within that scale ``encode_anchor_grid`` picks the same prior, the
    first maximum of the scale's own. The JAX version encodes one image and
    is vmapped; this one takes the batch."""
    parts = partition_anchors(anchors, num_scales)
    flat = _anchor_tensor([a for p in parts for a in p], boxes)
    per = flat.shape[0] // num_scales
    scale_of = torch.argmax(_shape_iou(boxes[..., 2:4], flat), dim=-1) // per
    valid = valid.bool()
    grids = fpn_grid_sizes(grid, num_scales)
    return tuple(encode_anchor_grid(boxes, valid & (scale_of == s),
                                    num_classes, parts[s], grids[s])
                 for s in range(num_scales))


def decode_fpn_grids(predictions: Sequence[torch.Tensor], num_classes: int,
                     anchors: Anchors, grid: int = 13,
                     num_scales: int = 3) -> torch.Tensor:
    """Per-scale raw head outputs -> one ``(batch, sum_s S_s² * B_s, 6)``
    candidate set of rows ``[class, conf, cx, cy, w, h]``, the scales
    concatenated coarse -> fine (``decode_anchor_grid`` each)."""
    parts = partition_anchors(anchors, num_scales)
    grids = fpn_grid_sizes(grid, num_scales)
    return torch.cat([decode_anchor_grid(p, num_classes, parts[s], grids[s])
                      for s, p in enumerate(predictions)], dim=1)


def decode_fpn_targets(targets: Sequence[torch.Tensor], num_classes: int,
                       anchors: Anchors, grid: int = 13,
                       num_scales: int = 3) -> torch.Tensor:
    """``encode_fpn_grids``'s targets -> ground-truth rows, as
    ``decode_fpn_grids`` lays them out (``decode_anchor_targets`` each)."""
    parts = partition_anchors(anchors, num_scales)
    grids = fpn_grid_sizes(grid, num_scales)
    return torch.cat([decode_anchor_targets(t, num_classes, parts[s],
                                            grids[s])
                      for s, t in enumerate(targets)], dim=1)
