"""Box geometry over ``[cx, cy, w, h]`` boxes, with the reference's quirks
kept for bit-comparable loss, NMS and mAP (counterpart of
``keras_object_detection_tpu/core/boxes.py``):

- corners are ``(c - s) / 2`` and ``(c + s) / 2`` (the centre is halved too),
- intersection side lengths are clipped to ``[0, 1]``,
- areas go through ``abs``,
- the union denominator is ``(area1 + area2) - inter + 1e-6``, in that order.

The CUDA NMS kernel (``ops/csrc/nms.cu``) repeats this operation order, so
its keep decisions are bit-equal to the plain version built on these.

``iou_cxcywh_exact`` and ``pairwise_iou_cxcywh_exact`` are the geometric IoU
(true corners ``c - s / 2``, no clip, ``max(union, 1e-6)``) that the anchor
loss's ignore mask and IoU objectness target use.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def cxcywh_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """``[cx, cy, w, h] -> [xmin, ymin, xmax, ymax]`` along the last axis."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [(cx - w) / 2.0, (cy - h) / 2.0, (cx + w) / 2.0, (cy + h) / 2.0], dim=-1)


def iou_cxcywh(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise (broadcasting) IoU: ``(..., 4) x (..., 4) -> (..., 1)``."""
    b1 = cxcywh_to_corners(boxes1)
    b2 = cxcywh_to_corners(boxes2)
    inter_w = torch.clamp(
        torch.minimum(b1[..., 2:3], b2[..., 2:3])
        - torch.maximum(b1[..., 0:1], b2[..., 0:1]), 0.0, 1.0)
    inter_h = torch.clamp(
        torch.minimum(b1[..., 3:4], b2[..., 3:4])
        - torch.maximum(b1[..., 1:2], b2[..., 1:2]), 0.0, 1.0)
    inter = inter_w * inter_h
    area1 = torch.abs((b1[..., 2:3] - b1[..., 0:1]) * (b1[..., 3:4] - b1[..., 1:2]))
    area2 = torch.abs((b2[..., 2:3] - b2[..., 0:1]) * (b2[..., 3:4] - b2[..., 1:2]))
    return inter / (area1 + area2 - inter + _EPS)


def pairwise_iou_cxcywh(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: ``(..., N, 4) x (..., M, 4) -> (..., N, M)``."""
    return iou_cxcywh(boxes1[..., :, None, :], boxes2[..., None, :, :])[..., 0]


def iou_cxcywh_exact(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Geometric elementwise (broadcasting) IoU: ``(..., 4) x (..., 4) ->
    (...)``, with true corners ``c -/+ s / 2`` and no clip."""
    x1 = torch.maximum(b1[..., 0] - b1[..., 2] / 2, b2[..., 0] - b2[..., 2] / 2)
    y1 = torch.maximum(b1[..., 1] - b1[..., 3] / 2, b2[..., 1] - b2[..., 3] / 2)
    x2 = torch.minimum(b1[..., 0] + b1[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2)
    y2 = torch.minimum(b1[..., 1] + b1[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2)
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    union = (torch.abs(b1[..., 2] * b1[..., 3])
             + torch.abs(b2[..., 2] * b2[..., 3]) - inter)
    return inter / torch.clamp_min(union, _EPS)


def pairwise_iou_cxcywh_exact(boxes1: torch.Tensor,
                              boxes2: torch.Tensor) -> torch.Tensor:
    """Geometric all-pairs IoU: ``(..., N, 4) x (..., M, 4) -> (..., N, M)``."""
    return iou_cxcywh_exact(boxes1[..., :, None, :], boxes2[..., None, :, :])
