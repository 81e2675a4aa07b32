"""The four-term YOLOv1 loss in torch autograd (counterpart of
``keras_object_detection_tpu/losses/yolo.py`` ``yolo_v1_loss_terms``), the
plain default path of the train step (``TrainConfig.use_pallas_loss=False``),
with its scalar ``yolo_v1_loss`` and the callable ``YoloV1Loss``.

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

``box_loss_mode`` ``"diou"``, ``"ciou"`` and ``"alpha_iou"`` swap the xy/wh
MSE terms for an IoU-family regression loss on the standard geometric IoU
(DIoU and CIoU: arXiv:1911.08287; alpha-DIoU with alpha = 3:
arXiv:2110.13675), in JAX's order of operations. Their gradients follow
``jax.grad`` at ties too: ``|w|`` and ``|h|`` of the prediction pass the
whole gradient at 0 (``jnp.abs``'s rule, where torch's ``abs`` passes none),
and CIoU's trade-off weight takes no gradient (``stop_gradient``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from keras_object_detection_torch.core.boxes import iou_cxcywh


class _JaxAbs(torch.autograd.Function):
    """``|x|`` whose gradient is ``jnp.abs``'s: ``g`` where ``x >= 0``
    (0.0 and -0.0 included), else ``-g``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _iou_geometry(true_box: torch.Tensor, pred_box: torch.Tensor):
    """``(iou, center_d2 / diag2, aspect_v)``, each ``(..., 1)``, of the
    standard geometric IoU with ``|w|``, ``|h|`` of the prediction."""
    tx, ty, tw, th = (true_box[..., k:k + 1] for k in range(4))
    px, py, pw, ph = (pred_box[..., k:k + 1] for k in range(4))
    pw = _JaxAbs.apply(pw)
    ph = _JaxAbs.apply(ph)
    tx1, ty1, tx2, ty2 = tx - tw / 2, ty - th / 2, tx + tw / 2, ty + th / 2
    px1, py1, px2, py2 = px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2
    zero = torch.zeros((), dtype=pred_box.dtype, device=pred_box.device)
    # torch.maximum / minimum split a tie's gradient 0.5 / 0.5, as JAX does
    iw = torch.maximum(torch.minimum(tx2, px2) - torch.maximum(tx1, px1), zero)
    ih = torch.maximum(torch.minimum(ty2, py2) - torch.maximum(ty1, py1), zero)
    inter = iw * ih
    union = tw * th + pw * ph - inter + 1e-9
    iou = inter / union
    center_d2 = (tx - px) ** 2 + (ty - py) ** 2
    cw = torch.maximum(tx2, px2) - torch.minimum(tx1, px1)
    ch = torch.maximum(ty2, py2) - torch.minimum(ty1, py1)
    diag2 = cw ** 2 + ch ** 2 + 1e-9
    v = (4.0 / math.pi ** 2) * torch.square(
        torch.arctan(tw / (th + 1e-9)) - torch.arctan(pw / (ph + 1e-9)))
    return iou, center_d2 / diag2, v


def _diou_loss(true_box: torch.Tensor, pred_box: torch.Tensor) -> torch.Tensor:
    iou, norm_d2, _ = _iou_geometry(true_box, pred_box)
    return 1.0 - iou + norm_d2


def _ciou_loss(true_box: torch.Tensor, pred_box: torch.Tensor) -> torch.Tensor:
    iou, norm_d2, v = _iou_geometry(true_box, pred_box)
    alpha = (v / (1.0 - iou + v + 1e-9)).detach()
    return 1.0 - iou + norm_d2 + alpha * v


def _alpha_iou_loss(true_box: torch.Tensor, pred_box: torch.Tensor,
                    alpha: float = 3.0) -> torch.Tensor:
    iou, norm_d2, _ = _iou_geometry(true_box, pred_box)
    return 1.0 - iou ** alpha + norm_d2 ** alpha


BOX_LOSSES = {"diou": _diou_loss, "ciou": _ciou_loss,
              "alpha_iou": _alpha_iou_loss}


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
    if box_loss_mode != "mse" and box_loss_mode not in BOX_LOSSES:
        raise ValueError(f"unknown box_loss_mode {box_loss_mode!r}; options: "
                         "mse, diou, ciou, alpha_iou")
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

    if box_loss_mode == "mse":
        xy_loss = torch.sum(obj * torch.square(
            true_box[..., 0:2] - pred_box[..., 0:2]))
        wh_loss = torch.sum(obj * torch.square(
            torch.sqrt(true_box[..., 2:4])
            - torch.sign(pred_box[..., 2:4])
            * torch.sqrt(torch.abs(pred_box[..., 2:4]) + 1e-6)))
        box_loss = xy_loss + wh_loss
    else:
        box_loss = torch.sum(obj * BOX_LOSSES[box_loss_mode](true_box, pred_box))
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


def yolo_v1_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    num_classes: int,
    num_boxes: int = 2,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
    noobj_mode: str = "selected",
) -> torch.Tensor:
    """The scalar YOLOv1 loss: ``yolo_v1_loss_terms(...)["total"]``
    (counterpart of JAX's ``yolo_v1_loss``)."""
    return yolo_v1_loss_terms(
        y_true, y_pred, num_classes, num_boxes, lambda_coord, lambda_noobj,
        noobj_mode)["total"]


class YoloV1Loss:
    """The loss bound to its settings, the reference's class surface:
    ``loss = YoloV1Loss(num_classes=3); loss(y_true, y_pred)``. A plain
    callable over ``yolo_v1_loss`` (counterpart of JAX's ``YoloV1Loss``),
    with no parameters and no kernel switch."""

    def __init__(self, num_classes: int = 20, num_boxes: int = 2,
                 lambda_coord: float = 5.0, lambda_noobj: float = 0.5,
                 noobj_mode: str = "selected"):
        self.num_classes = num_classes
        self.num_boxes = num_boxes
        self.lambda_coord = lambda_coord
        self.lambda_noobj = lambda_noobj
        self.noobj_mode = noobj_mode

    def __call__(self, y_true: torch.Tensor,
                 y_pred: torch.Tensor) -> torch.Tensor:
        return yolo_v1_loss(y_true, y_pred, self.num_classes, self.num_boxes,
                            self.lambda_coord, self.lambda_noobj,
                            self.noobj_mode)
