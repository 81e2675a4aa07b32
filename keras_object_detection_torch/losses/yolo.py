"""The four-term YOLOv1 loss in torch autograd (counterpart of
``keras_object_detection_tpu/losses/yolo.py`` ``yolo_v1_loss_terms``), the
plain default path of the train step (``TrainConfig.use_pallas_loss=False``).

The reference's quirks are kept: the responsible slot is the argmax of the
quirk IoU against the truth (ties to slot 0), the wh term is
``sign(p) * sqrt(|p| + 1e-6)``, the object target is the selected slot's
live IoU (its gradient flows), the no-object term takes the selected slot
(``"selected"``) or every slot (``"all"``), and the reduction is a sum.

Gradients are torch autograd's, which agree with ``jax.grad`` at generic
points. At ties they follow torch's conventions: ``torch.clamp`` passes the
whole gradient at a bound where ``jnp.clip`` passes half, and
``torch.maximum`` / ``torch.minimum`` split a tie 0.5 / 0.5 as JAX does.
The fused loss (``ops/yolo_loss.py``) has a third convention, its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from keras_object_detection_torch.core.boxes import iou_cxcywh


def yolo_v1_loss_terms(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    num_classes: int,
    num_boxes: int = 2,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
    noobj_mode: str = "selected",
    box_loss_mode: str = "mse",
    sample_weight: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-term sums over ``(batch, S, S, C + 5B)`` grids: ``box_loss``,
    ``object_loss``, ``no_object_loss``, ``class_loss`` and their weighted
    ``total``. ``sample_weight`` is an optional ``(batch,)`` per-image
    weight carried by both the object and the no-object masks."""
    if noobj_mode not in ("selected", "all"):
        raise ValueError(
            f"noobj_mode must be 'selected' or 'all', got {noobj_mode!r}")
    if box_loss_mode in ("diou", "ciou", "alpha_iou"):
        raise NotImplementedError(
            f"box_loss_mode {box_loss_mode!r} is not ported yet (ROADMAP 1.16)")
    if box_loss_mode != "mse":
        raise ValueError(f"unknown box_loss_mode {box_loss_mode!r}")
    c = num_classes
    true_box = y_true[..., c + 1:c + 5]
    obj = y_true[..., c:c + 1]
    noobj = 1.0 - obj
    if sample_weight is not None:
        w = sample_weight.to(y_true.dtype)[:, None, None, None]
        obj = obj * w
        noobj = noobj * w

    pred_slots = y_pred[..., c:].reshape(y_pred.shape[:-1] + (num_boxes, 5))
    pred_confs = pred_slots[..., 0]
    pred_boxes = pred_slots[..., 1:5]
    ious = iou_cxcywh(true_box[..., None, :], pred_boxes)[..., 0]

    best = torch.argmax(ious, dim=-1)  # the first maximum: ties to slot 0
    onehot = F.one_hot(best, num_boxes).to(y_pred.dtype)
    pred_box = torch.sum(onehot[..., None] * pred_boxes, dim=-2)
    pred_conf = torch.sum(onehot * pred_confs, dim=-1, keepdim=True)
    pred_iou = torch.sum(onehot * ious, dim=-1, keepdim=True)

    xy_loss = torch.sum(obj * torch.square(true_box[..., 0:2] - pred_box[..., 0:2]))
    wh_loss = torch.sum(obj * torch.square(
        torch.sqrt(true_box[..., 2:4])
        - torch.sign(pred_box[..., 2:4])
        * torch.sqrt(torch.abs(pred_box[..., 2:4]) + 1e-6)))
    box_loss = xy_loss + wh_loss
    object_loss = torch.sum(obj * torch.square(pred_iou - pred_conf))
    if noobj_mode == "selected":
        no_object_loss = torch.sum(noobj * torch.square(0.0 - pred_conf))
    else:
        no_object_loss = torch.sum(noobj * torch.square(0.0 - pred_confs))
    class_loss = torch.sum(obj * torch.square(y_true[..., :c] - y_pred[..., :c]))

    total = (lambda_coord * box_loss + object_loss
             + lambda_noobj * no_object_loss + class_loss)
    return {"box_loss": box_loss, "object_loss": object_loss,
            "no_object_loss": no_object_loss, "class_loss": class_loss,
            "total": total}
