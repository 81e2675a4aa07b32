"""The FPN-family (YOLOv3) loss (counterpart of
``keras_object_detection_tpu/losses/yolov3.py`` ``yolo_v3_loss_terms``):
each scale is the anchor-family loss (``losses/yolov2.py``) over that
scale's grid and priors, with the ignore mask against the full list of
ground-truth boxes, and the scales' terms are summed."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from keras_object_detection_torch.core.anchors import Anchors
from keras_object_detection_torch.core.fpn import partition_anchors
from keras_object_detection_torch.losses.yolov2 import yolo_v2_loss_terms


def yolo_v3_loss_terms(
    y_true: Sequence[torch.Tensor],
    y_pred: Sequence[torch.Tensor],
    num_classes: int,
    anchors: Anchors,
    num_scales: int = 3,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
    sample_weight: Optional[torch.Tensor] = None,
    ignore_threshold: Optional[float] = None,
    gt_boxes: Optional[torch.Tensor] = None,
    gt_valid: Optional[torch.Tensor] = None,
    obj_target: str = "one",
) -> Dict[str, torch.Tensor]:
    """Sum-reduced loss terms of per-scale ``(batch, S_s, S_s, B_s * (5 +
    C))`` grids, coarse -> fine (``FPNHead``'s order): the keys of
    ``yolo_v2_loss_terms``, each the sum over the scales. The arguments
    are ``yolo_v2_loss_terms``'s."""
    parts = partition_anchors(anchors, num_scales)
    if len(y_true) != num_scales or len(y_pred) != num_scales:
        raise ValueError(
            f"expected {num_scales} per-scale grids, got "
            f"{len(y_true)} targets / {len(y_pred)} predictions")
    total: Dict[str, torch.Tensor] = {}
    for s in range(num_scales):
        terms = yolo_v2_loss_terms(
            y_true[s], y_pred[s], num_classes, parts[s], lambda_coord,
            lambda_noobj, sample_weight=sample_weight,
            ignore_threshold=ignore_threshold, gt_boxes=gt_boxes,
            gt_valid=gt_valid, obj_target=obj_target)
        for k, v in terms.items():
            total[k] = total[k] + v if k in total else v
    return total
