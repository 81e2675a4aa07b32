"""The two losses, in plain torch and float32, each a sum over the batch.

YOLOv1 (arXiv:1506.02640 with the reference repo's quirks): the slot whose
box overlaps the truth most answers for the cell (ties to slot 0, the
quirk IoU of ``iou``), ``lambda_coord`` x (the xy squared error + that of
``sqrt(w_true)`` against ``sign(w) sqrt(|w| + 1e-6)``), the object term
against the live IoU, ``lambda_noobj`` x the selected slot's squared
confidence in empty cells, and the class scores' squared error.

YOLOv3, per scale: ``lambda_coord`` x the squared error of ``sigmoid(tx,
ty)`` and of raw ``tw, th`` on assigned slots, ``(sigmoid(obj) - IoU)^2``
there (the IoU of the decoded prediction with its box, without gradient),
``lambda_noobj`` x ``sigmoid(obj)^2`` on the other slots except where the
decoded prediction overlaps a true box by more than the ignore threshold,
and the softmax cross-entropy of the classes; summed over the scales.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import grids


def _corners(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([(cx - w) / 2, (cy - h) / 2, (cx + w) / 2,
                        (cy + h) / 2], -1)


def iou(b1, b2):
    """The reference repo's IoU (corners ``(c -/+ s) / 2``, sides clipped
    to [0, 1]): ``(..., 4) x (..., 4) -> (..., 1)``."""
    a, b = _corners(b1), _corners(b2)
    iw = torch.clamp(torch.minimum(a[..., 2:3], b[..., 2:3])
                     - torch.maximum(a[..., 0:1], b[..., 0:1]), 0.0, 1.0)
    ih = torch.clamp(torch.minimum(a[..., 3:4], b[..., 3:4])
                     - torch.maximum(a[..., 1:2], b[..., 1:2]), 0.0, 1.0)
    inter = iw * ih
    area1 = torch.abs((a[..., 2:3] - a[..., 0:1]) * (a[..., 3:4] - a[..., 1:2]))
    area2 = torch.abs((b[..., 2:3] - b[..., 0:1]) * (b[..., 3:4] - b[..., 1:2]))
    return inter / (area1 + area2 - inter + 1e-6)


def iou_exact(b1, b2):
    """Geometric IoU (corners ``c -/+ s / 2``): ``(..., 4) x (..., 4) ->
    (...)``."""
    x1 = torch.maximum(b1[..., 0] - b1[..., 2] / 2, b2[..., 0] - b2[..., 2] / 2)
    y1 = torch.maximum(b1[..., 1] - b1[..., 3] / 2, b2[..., 1] - b2[..., 3] / 2)
    x2 = torch.minimum(b1[..., 0] + b1[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2)
    y2 = torch.minimum(b1[..., 1] + b1[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2)
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    union = (torch.abs(b1[..., 2] * b1[..., 3])
             + torch.abs(b2[..., 2] * b2[..., 3]) - inter)
    return inter / torch.clamp_min(union, 1e-6)


def v1_loss(y_true, y_pred, c: int, nbox: int, lc: float, ln: float):
    true_box = y_true[..., c + 1:c + 5]
    obj = y_true[..., c:c + 1]
    slots = y_pred[..., c:].reshape(y_pred.shape[:-1] + (nbox, 5))
    ious = iou(true_box[..., None, :], slots[..., 1:5])[..., 0]
    onehot = F.one_hot(torch.argmax(ious, dim=-1), nbox).float()
    box = torch.sum(onehot[..., None] * slots[..., 1:5], dim=-2)
    conf = torch.sum(onehot * slots[..., 0], dim=-1, keepdim=True)
    live = torch.sum(onehot * ious, dim=-1, keepdim=True)
    xy = torch.sum(obj * torch.square(true_box[..., :2] - box[..., :2]))
    wh = torch.sum(obj * torch.square(
        torch.sqrt(true_box[..., 2:4])
        - torch.sign(box[..., 2:4]) * torch.sqrt(torch.abs(box[..., 2:4])
                                                 + 1e-6)))
    return (lc * (xy + wh) + torch.sum(obj * torch.square(live - conf))
            + ln * torch.sum((1.0 - obj) * torch.square(conf))
            + torch.sum(obj * torch.square(y_true[..., :c] - y_pred[..., :c])))


def _anchor_loss(y_true, y_pred, c: int, anchors, lc: float, ln: float,
                 ignore: float, gt_boxes, gt_valid):
    nb, b = len(anchors), y_true.shape[0]
    grid = y_true.shape[1]
    t = y_true.reshape(b, -1, nb, 5 + c)
    p = y_pred.reshape(b, -1, nb, 5 + c)
    obj = t[..., 0]
    with torch.no_grad():
        pred = grids.decode_anchor(p.reshape(b, grid, grid, -1), c, anchors,
                                   grid)[..., 2:6]
        over = iou_exact(pred[:, :, None, :], gt_boxes[:, None, :, :4])
        over = torch.where(gt_valid[:, None, :].bool(), over,
                           torch.zeros_like(over))
        keep = (torch.amax(over, dim=-1).reshape(obj.shape) <= ignore).float()
        truth = grids.decode_anchor_targets(t.reshape(b, grid, grid, -1), c,
                                            anchors, grid)[..., 2:6]
        target = iou_exact(pred, truth).reshape(obj.shape)
    box = lc * (torch.sum(obj[..., None] * torch.square(
        torch.sigmoid(p[..., 1:3]) - t[..., 1:3]))
        + torch.sum(obj[..., None] * torch.square(p[..., 3:5] - t[..., 3:5])))
    pobj = torch.sigmoid(p[..., 0])
    cls = -torch.sum(obj[..., None] * t[..., 5:]
                     * F.log_softmax(p[..., 5:], dim=-1))
    return (box + torch.sum(obj * torch.square(pobj - target))
            + ln * torch.sum((1.0 - obj) * keep * torch.square(pobj)) + cls)


def loss(y_true, y_pred, boxes, valid, cfg: dict):
    """The configured head's total loss."""
    g, m, t = cfg["grid"], cfg["model"], cfg["train"]
    lc, ln = t["lambda_coord"], t["lambda_noobj"]
    if m["head"] != "fpn":
        return v1_loss(y_true, y_pred, g["num_classes"], g["num_boxes"], lc,
                       ln)
    if t["obj_target"] != "iou" or t["ignore_threshold"] is None:
        raise ValueError("the reference's v3 loss takes the IoU objectness "
                         "target and an ignore threshold")
    parts = grids.partition(g["anchors"], m["fpn_scales"])
    return sum(_anchor_loss(yt, yp, g["num_classes"], parts[s], lc, ln,
                            t["ignore_threshold"], boxes, valid)
               for s, (yt, yp) in enumerate(zip(y_true, y_pred)))
