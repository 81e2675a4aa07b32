"""VOC-style mAP, loop-free, on the device (counterpart of
``keras_object_detection_tpu/ops/map.py``).

The reference's greedy matcher has a closed form: a detection's best ground
truth (the first argmax of IoU within its image and class) does not depend
on which ground truths are already taken, and a detection is a true
positive iff its best IoU exceeds the threshold and it is the
highest-ranked detection claiming that ground truth. So TP assignment is a
segment minimum of confidence ranks keyed by (image, ground truth), here
``scatter_reduce("amin")``, and each class's AP a cumulative sum and a
trapezoid.

Kept from the reference: an absent class counts AP 0 in the mean, the PR
curve starts at (recall 0, precision 1), AP is the trapezoid integral,
epsilon 1e-6 in the recall and precision denominators, and detections are
ranked by a stable confidence-descending sort of the image-major stream.

``MeanAveragePrecision`` decodes each batch's grids, runs NMS on the targets
and the predictions (``auto_batched_non_max_suppression``: the NMS kernel on
a CUDA tensor) and keeps the box sets on the device until ``result``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from keras_object_detection_torch.core.anchors import (decode_anchor_grid,
                                                       decode_anchor_targets)
from keras_object_detection_torch.core.boxes import iou_cxcywh
from keras_object_detection_torch.core.fpn import (decode_fpn_grids,
                                                   decode_fpn_targets)
from keras_object_detection_torch.core.grid import decode_grid
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression
from keras_object_detection_torch.ops.error_analysis import error_analysis
from keras_object_detection_torch.ops.nms import top_k_candidates

#: COCO's IoU sweep 0.50:0.05:0.95
COCO_IOU_THRESHOLDS = tuple(round(0.50 + 0.05 * i, 2) for i in range(10))

_EPS = 1e-6


def _map_at_thresholds(true_boxes: torch.Tensor, true_valid: torch.Tensor,
                       pred_boxes: torch.Tensor, pred_valid: torch.Tensor,
                       num_classes: int, thresholds: Sequence[float],
                       return_curves: bool = False):
    """``(T, C)`` per-class APs, one row per IoU threshold, from one matcher
    pass. ``return_curves`` (one threshold) also returns the per-class PR
    curves ``(aps, recalls (C, N + 1), precisions (C, N + 1), total_true
    (C,))`` over the confidence-sorted detection stream.

    ``true_boxes`` ``(I, G, 6)`` and ``pred_boxes`` ``(I, D, 6)`` are rows
    ``[cls, conf, cx, cy, w, h]``; ``true_valid`` / ``pred_valid`` their
    masks."""
    dev = pred_boxes.device
    num_images, max_gt, _ = true_boxes.shape
    max_det = pred_boxes.shape[1]
    true_valid, pred_valid = true_valid.bool(), pred_valid.bool()

    det_cls = pred_boxes[..., 0]
    det_conf = torch.where(pred_valid, pred_boxes[..., 1],
                           torch.full_like(det_cls, float("-inf")))
    gt_cls = true_boxes[..., 0]

    # each detection's best ground truth in its image and class
    iou = iou_cxcywh(pred_boxes[:, :, None, 2:6], true_boxes[:, None, :, 2:6])[..., 0]
    match_ok = true_valid[:, None, :] & (gt_cls[:, None, :] == det_cls[:, :, None])
    iou = torch.where(match_ok, iou, torch.full_like(iou, -1.0))
    best_iou = torch.amax(iou, dim=-1)
    best_gt = torch.argmax(iou, dim=-1)  # the first maximum, as jnp.argmax

    # global rank: a stable sort of the image-major stream by -conf
    n = num_images * max_det
    order = torch.argsort(-det_conf.reshape(-1), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    rank = rank.reshape(num_images, max_det)

    cls_sorted = det_cls.reshape(-1)[order]
    valid_sorted = pred_valid.reshape(-1)[order]
    class_ids = torch.arange(num_classes, device=dev, dtype=det_cls.dtype)
    gt_cls_flat = torch.where(true_valid, gt_cls,
                              torch.full_like(gt_cls, -1.0)).reshape(-1)
    total_true = (gt_cls_flat[None, :] == class_ids[:, None]).sum(-1).float()
    in_class = ((cls_sorted[None, :] == class_ids[:, None])
                & valid_sorted[None, :]).float()  # (C, N)

    seg_base = torch.arange(num_images, device=dev)[:, None] * max_gt + best_gt
    spare = num_images * max_gt  # the segment that parks non-candidates
    aps = []
    for thr in thresholds:
        # first claimant wins: the least rank of each claimed ground truth
        cand = pred_valid & (best_iou > thr)
        seg = torch.where(cand, seg_base, torch.full_like(seg_base, spare))
        first = torch.full((spare + 1,), n, dtype=rank.dtype, device=dev)
        first = first.scatter_reduce(0, seg.reshape(-1), rank.reshape(-1),
                                     "amin", include_self=False)
        tp = cand & (rank == first[seg])
        fp = pred_valid & ~tp

        tp_sorted = tp.reshape(-1)[order].float()
        fp_sorted = fp.reshape(-1)[order].float()
        tp_cum = torch.cumsum(tp_sorted[None, :] * in_class, dim=-1)
        fp_cum = torch.cumsum(fp_sorted[None, :] * in_class, dim=-1)
        recalls = tp_cum / (total_true[:, None] + _EPS)
        # rows of other classes repeat the previous point (zero area); the
        # prefix before a class's first detection is the (0, 1) start
        precisions = torch.where(tp_cum + fp_cum > 0,
                                 tp_cum / (tp_cum + fp_cum + _EPS),
                                 torch.ones_like(tp_cum))
        recalls = torch.cat([torch.zeros_like(recalls[:, :1]), recalls], -1)
        precisions = torch.cat([torch.ones_like(precisions[:, :1]),
                                precisions], -1)
        ap = torch.sum((recalls[:, 1:] - recalls[:, :-1])
                       * (precisions[:, 1:] + precisions[:, :-1]) / 2.0, dim=-1)
        ap = torch.where(total_true > 0, ap, torch.zeros_like(ap))
        aps.append(ap)
        if return_curves:
            return torch.stack(aps), recalls, precisions, total_true
    return torch.stack(aps)


def mean_average_precision(true_boxes, true_valid, pred_boxes, pred_valid,
                           num_classes: int,
                           iou_threshold: float = 0.5) -> torch.Tensor:
    """mAP@``iou_threshold`` (a 0-dim tensor): the mean of the per-class APs
    of padded per-image box sets (see ``_map_at_thresholds``)."""
    return _map_at_thresholds(true_boxes, true_valid, pred_boxes, pred_valid,
                              num_classes, (iou_threshold,))[0].mean()


def mean_average_precision_multi(true_boxes, true_valid, pred_boxes,
                                 pred_valid, num_classes: int,
                                 thresholds: Sequence[float] = COCO_IOU_THRESHOLDS
                                 ) -> torch.Tensor:
    """``(T,)`` mAP at each IoU threshold, one matcher pass; the mean of the
    default sweep is COCO's mAP@[.50:.95]."""
    return _map_at_thresholds(true_boxes, true_valid, pred_boxes, pred_valid,
                              num_classes, tuple(thresholds)).mean(-1)


def average_precision_per_class(true_boxes, true_valid, pred_boxes,
                                pred_valid, num_classes: int,
                                iou_threshold: float = 0.5) -> torch.Tensor:
    """``(C,)`` per-class AP@``iou_threshold``; absent classes give 0."""
    return _map_at_thresholds(true_boxes, true_valid, pred_boxes, pred_valid,
                              num_classes, (iou_threshold,))[0]


class MeanAveragePrecision:
    """Streaming mAP: ``update_state(y_true, y_pred)`` per batch of
    ``(B, S, S, C + 5B)`` grids (with ``anchors``, ``(B, S, S, B_anchors *
    (5 + C))`` anchor grids, decoded by ``decode_anchor_targets`` and
    ``decode_anchor_grid``; with ``fpn_scales`` too, tuples of per-scale
    anchor grids, coarse -> fine with ``grid`` the coarsest, decoded by
    ``decode_fpn_targets`` and ``decode_fpn_grids`` into one candidate set),
    then ``result()``.

    ``update_state`` decodes both grids and runs NMS on the predictions and,
    with ``nms_on_targets`` (the reference's behaviour), on the targets too:
    two NMS calls a batch, each one launch of the NMS kernel on the GPU.
    Without it the targets are only filtered by ``conf > conf_threshold``.
    ``max_candidates`` cuts larger candidate sets to the top-K by confidence
    first. ``image_valid`` drops padded images of a partial batch. The box
    sets stay on the device; the ``result*`` methods read back once. As in
    JAX, a prior count that ``fpn_scales`` does not divide raises at the
    first update (``partition_anchors``).
    """

    def __init__(self, num_classes: int, num_boxes: int = 2, grid: int = 7,
                 iou_threshold: float = 0.5, conf_threshold: float = 0.4,
                 map_iou_threshold: float = 0.5, nms_on_targets: bool = True,
                 anchors: tuple = (), fpn_scales: int = 0,
                 max_candidates: int = 512):
        self._fpn_scales = fpn_scales
        self._anchors = tuple(tuple(a) for a in anchors or ())
        self._num_classes = num_classes
        self._num_boxes = num_boxes
        self._grid = grid
        self._iou_threshold = iou_threshold
        self._conf_threshold = conf_threshold
        self._map_iou_threshold = map_iou_threshold
        self._nms_on_targets = nms_on_targets
        self._max_candidates = max_candidates
        self.reset_states()

    def reset_states(self) -> None:
        self._true: list = []
        self._tvalid: list = []
        self._pred: list = []
        self._pvalid: list = []

    def _nms(self, boxes: torch.Tensor):
        return auto_batched_non_max_suppression(
            boxes, self._iou_threshold, self._conf_threshold,
            self._max_candidates)

    @torch.no_grad()
    def update_state(self, y_true, y_pred,
                     image_valid: Optional[torch.Tensor] = None) -> None:
        """Accumulate one batch. ``y_true`` and ``y_pred`` (tensors or
        arrays; with ``fpn_scales``, sequences of them) stay on their
        device; ``image_valid`` is an optional ``(batch,)`` mask of the real
        images."""
        c, b, s = self._num_classes, self._num_boxes, self._grid
        if self._fpn_scales:
            y_pred = [torch.as_tensor(p) for p in y_pred]
            y_true = [torch.as_tensor(t).to(y_pred[0].device) for t in y_true]
            tb = decode_fpn_targets(y_true, c, self._anchors, s,
                                    self._fpn_scales)
            pb = decode_fpn_grids(y_pred, c, self._anchors, s,
                                  self._fpn_scales)
        else:
            y_pred = torch.as_tensor(y_pred)
            y_true = torch.as_tensor(y_true).to(y_pred.device)
            if self._anchors:
                tb = decode_anchor_targets(y_true, c, self._anchors, s)
                pb = decode_anchor_grid(y_pred, c, self._anchors, s)
            else:
                tb = decode_grid(y_true, c, b, s)
                pb = decode_grid(y_pred, c, b, s)
        if self._nms_on_targets:
            tboxes, tvalid = self._nms(tb)
        else:
            if self._max_candidates and tb.shape[1] > self._max_candidates:
                tb = top_k_candidates(tb, self._max_candidates)
            tboxes, tvalid = tb, tb[..., 1] > self._conf_threshold
        pboxes, pvalid = self._nms(pb)
        if image_valid is not None:
            keep = torch.as_tensor(image_valid).to(pvalid.device).bool()[:, None]
            tvalid = tvalid & keep
            pvalid = pvalid & keep
        self._true.append(tboxes)
        self._tvalid.append(tvalid)
        self._pred.append(pboxes)
        self._pvalid.append(pvalid)

    def _sets(self):
        return (torch.cat(self._true), torch.cat(self._tvalid),
                torch.cat(self._pred), torch.cat(self._pvalid))

    def result(self) -> float:
        if not self._true:
            return 0.0
        return float(mean_average_precision(*self._sets(), self._num_classes,
                                            self._map_iou_threshold))

    def result_multi(self, thresholds: Sequence[float] = COCO_IOU_THRESHOLDS
                     ) -> Dict[str, float]:
        """``{"mAP@0.50": ..., ..., "mAP@[.50:.95]": mean}`` (the mean's key
        is ``"mAP@mean"`` for another sweep)."""
        thresholds = tuple(thresholds)
        mean_key = ("mAP@[.50:.95]" if thresholds == COCO_IOU_THRESHOLDS
                    else "mAP@mean")
        if not self._true:
            out = {f"mAP@{t:.2f}": 0.0 for t in thresholds}
            out[mean_key] = 0.0
            return out
        vals = mean_average_precision_multi(
            *self._sets(), self._num_classes, thresholds).cpu().numpy()
        out = {f"mAP@{t:.2f}": float(v) for t, v in zip(thresholds, vals)}
        out[mean_key] = float(vals.mean())
        return out

    def result_per_class(self, iou_threshold: Optional[float] = None
                         ) -> np.ndarray:
        """``(C,)`` per-class AP (default threshold: the mAP threshold);
        ``result()`` is its mean."""
        if not self._true:
            return np.zeros(self._num_classes, np.float32)
        thr = self._map_iou_threshold if iou_threshold is None else iou_threshold
        return average_precision_per_class(
            *self._sets(), self._num_classes, thr).cpu().numpy()

    def result_pr_curves(self, iou_threshold: Optional[float] = None) -> dict:
        """``{class: {"recall": [...], "precision": [...], "ap", "num_gt"}}``
        for every class with ground truths, repeated PR points dropped."""
        if not self._true:
            return {}
        thr = self._map_iou_threshold if iou_threshold is None else iou_threshold
        aps, recalls, precisions, total_true = (
            x.cpu().numpy() for x in _map_at_thresholds(
                *self._sets(), self._num_classes, (thr,), return_curves=True))
        out = {}
        for c in range(self._num_classes):
            if total_true[c] <= 0:
                continue
            r, p = recalls[c], precisions[c]
            keep = np.concatenate(
                [[True], (np.diff(r) != 0) | (np.diff(p) != 0)])
            out[c] = {"recall": [round(float(v), 6) for v in r[keep]],
                      "precision": [round(float(v), 6) for v in p[keep]],
                      "ap": round(float(aps[0][c]), 6),
                      "num_gt": int(total_true[c])}
        return out

    def result_error_analysis(self, iou_threshold: Optional[float] = None,
                              bg_threshold: float = 0.1) -> dict:
        """TIDE-style breakdown of the accumulated box sets
        (``ops/error_analysis.py``, on the host): every detection a tp /
        duplicate / classification / localization / both / background,
        and the missed ground truths, in all and per class, at
        ``iou_threshold`` (default: the mAP threshold). Its TPs are
        ``result()``'s matcher's."""
        if not self._true:
            return error_analysis(
                np.zeros((0, 1, 6)), np.zeros((0, 1), bool),
                np.zeros((0, 1, 6)), np.zeros((0, 1), bool),
                self._num_classes)
        thr = self._map_iou_threshold if iou_threshold is None else iou_threshold
        return error_analysis(*(x.cpu().numpy() for x in self._sets()),
                              self._num_classes, thr, bg_threshold)
