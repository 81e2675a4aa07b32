"""The anchor-family (YOLOv2) loss in torch autograd (counterpart of
``keras_object_detection_tpu/losses/yolov2.py`` ``yolo_v2_loss_terms``).

Targets come from ``core.anchors.encode_anchor_grid`` (slot layout ``[obj,
tx*, ty*, tw*, th*, class one-hot]``); predictions are the raw head output
in the same layout. Terms, each summed over slots and weighted per image:

- box: ``lambda_coord`` x the squared error of ``sigmoid(tx, ty)`` against
  ``tx*, ty*`` and of the raw ``tw, th`` against ``tw*, th*`` on assigned
  slots;
- object: ``(sigmoid(obj) - target)^2`` on assigned slots, the target 1
  (``obj_target="one"``) or the exact IoU of the decoded prediction with its
  assigned box (``"iou"``), which takes no gradient (JAX's
  ``stop_gradient``);
- no-object: ``lambda_noobj`` x ``sigmoid(obj)^2`` on unassigned slots;
  with ``ignore_threshold`` a slot whose decoded prediction overlaps a valid
  ground-truth box by an exact IoU above it is exempt (``best <= thr``
  stays penalised);
- class: the softmax cross-entropy on assigned slots.

Everything is computed in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from keras_object_detection_torch.core.anchors import (decode_anchor_grid,
                                                       decode_anchor_targets)
from keras_object_detection_torch.core.boxes import (iou_cxcywh_exact,
                                                     pairwise_iou_cxcywh_exact)


def yolo_v2_loss_terms(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    num_classes: int,
    anchors: Sequence[Tuple[float, float]],
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
    sample_weight: Optional[torch.Tensor] = None,
    ignore_threshold: Optional[float] = None,
    gt_boxes: Optional[torch.Tensor] = None,
    gt_valid: Optional[torch.Tensor] = None,
    obj_target: str = "one",
) -> Dict[str, torch.Tensor]:
    """Sum-reduced anchor-loss terms of ``(batch, S, S, B * (5 + C))``
    grids: ``box_loss``, ``object_loss``, ``no_object_loss``,
    ``class_loss`` and their sum ``total``, 0-dim float32 tensors.

    ``sample_weight``: an optional ``(batch,)`` weight of each image.
    ``ignore_threshold`` needs ``gt_boxes`` ``(batch, N, 5)`` and
    ``gt_valid`` ``(batch, N)``, the padded boxes the targets were encoded
    from."""
    nb = len(anchors)
    depth = 5 + num_classes
    b = y_true.shape[0]
    t = y_true.reshape(b, -1, nb, depth).float()
    p = y_pred.reshape(b, -1, nb, depth).float()
    grid = int(round(t.shape[1] ** 0.5))
    obj = t[..., 0]
    noobj = 1.0 - obj
    pred_boxes = None

    def decoded_preds() -> torch.Tensor:
        # the slot boxes take no gradient: the mask compares them and the
        # IoU target is stopped
        with torch.no_grad():
            return decode_anchor_grid(p.reshape(b, grid, grid, nb * depth),
                                      num_classes, anchors, grid)[..., 2:6]

    if ignore_threshold is not None:
        if gt_boxes is None or gt_valid is None:
            raise ValueError("ignore_threshold needs gt_boxes/gt_valid (the "
                             "padded box list the targets were encoded from)")
        pred_boxes = decoded_preds()
        ious = pairwise_iou_cxcywh_exact(
            pred_boxes, gt_boxes[..., :4].to(pred_boxes))
        ious = torch.where(gt_valid[:, None, :].bool(), ious,
                           torch.zeros_like(ious))
        best = torch.amax(ious, dim=-1).reshape(obj.shape)
        noobj = noobj * (best <= ignore_threshold).to(noobj.dtype)

    def persum(x: torch.Tensor) -> torch.Tensor:  # all but the batch axis
        return torch.sum(x.reshape(b, -1), dim=-1)

    pxy = torch.sigmoid(p[..., 1:3])
    box_xy = persum(obj[..., None] * torch.square(pxy - t[..., 1:3]))
    box_wh = persum(obj[..., None] * torch.square(p[..., 3:5] - t[..., 3:5]))
    box_loss = lambda_coord * (box_xy + box_wh)

    pobj = torch.sigmoid(p[..., 0])
    if obj_target == "one":
        target = 1.0
    elif obj_target == "iou":
        if pred_boxes is None:
            pred_boxes = decoded_preds()
        true_boxes = decode_anchor_targets(
            t.reshape(b, grid, grid, nb * depth), num_classes, anchors,
            grid)[..., 2:6]
        target = iou_cxcywh_exact(pred_boxes, true_boxes).reshape(
            obj.shape).detach()
    else:
        raise ValueError(f"unknown obj_target {obj_target!r} "
                         "(expected 'one' or 'iou')")
    object_loss = persum(obj * torch.square(pobj - target))
    no_object_loss = lambda_noobj * persum(noobj * torch.square(pobj))

    logp = F.log_softmax(p[..., 5:], dim=-1)
    class_loss = -persum(obj[..., None] * t[..., 5:] * logp)

    w = (torch.ones(b, dtype=torch.float32, device=p.device)
         if sample_weight is None
         else torch.as_tensor(sample_weight).to(p.device, torch.float32))
    terms = {"box_loss": torch.sum(w * box_loss),
             "object_loss": torch.sum(w * object_loss),
             "no_object_loss": torch.sum(w * no_object_loss),
             "class_loss": torch.sum(w * class_loss)}
    terms["total"] = (terms["box_loss"] + terms["object_loss"]
                      + terms["no_object_loss"] + terms["class_loss"])
    return terms
