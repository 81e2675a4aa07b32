"""TIDE-style detection error analysis, numpy on the host (a copy of
``keras_object_detection_tpu/ops/error_analysis.py``, which imports no JAX;
the port keeps its own so that it imports nothing of the JAX package).

Every accumulated detection is categorized with the matcher's semantics of
``ops/map.py`` (the quirk IoU, the same-class best ground truth, the strict
``> threshold`` candidacy and first-claimant-by-confidence-rank TP
resolution), so the TP count equals ``MeanAveragePrecision.result()``'s
recall numerator. False positives split into the error types of Bolya et
al., "TIDE: A General Toolbox for Identifying Object Detection Errors"
(arXiv:2008.08115 §2.2; the taxonomy only):

- ``duplicate``       same-class IoU > t, but a higher-ranked detection
                      already claimed that ground truth
- ``classification``  IoU > t with a ground truth of ANOTHER class
- ``localization``    same-class IoU in (bg, t]: right class, poor box
- ``both``            other-class IoU in (bg, t]: wrong class AND poor box
- ``background``      no IoU > bg with any ground truth

plus ``missed_gt``: valid ground truths never claimed by a TP (the false
negatives). Claims never cross images, so per-image confidence order
reproduces the matcher's global-rank resolution; images are taken in
chunks.
"""

from __future__ import annotations

import numpy as np

CATEGORIES = ("tp", "duplicate", "classification", "localization", "both",
              "background")

_EPS = 1e-6


def _pairwise_iou(pred: np.ndarray, true: np.ndarray) -> np.ndarray:
    """(I, D, 4) x (I, G, 4) -> (I, D, G) reference-quirk IoU (the numpy twin
    of core/boxes.py iou_cxcywh: (c±s)/2 corners, [0,1] side clip, abs area,
    1e-6 union epsilon — ref utils.py:9-43)."""
    def corners(b):
        c, s = b[..., 0:2], b[..., 2:4]
        return (c - s) / 2.0, (c + s) / 2.0
    pmin, pmax = corners(pred[:, :, None, :])
    tmin, tmax = corners(true[:, None, :, :])
    side = np.clip(np.minimum(pmax, tmax) - np.maximum(pmin, tmin), 0.0, 1.0)
    inter = side[..., 0] * side[..., 1]
    parea = np.abs(np.prod(pmax - pmin, axis=-1))
    tarea = np.abs(np.prod(tmax - tmin, axis=-1))
    return inter / (parea + tarea - inter + _EPS)


def _analyze_chunk(true, tvalid, pred, pvalid, iou_threshold, bg_threshold):
    """One image chunk -> (per-detection category codes (I, D) int,
    claimed-GT mask (I, G)). Codes index CATEGORIES; invalid dets get -1."""
    det_cls, det_conf = pred[..., 0], pred[..., 1]
    gt_cls = true[..., 0]
    iou = _pairwise_iou(pred[..., 2:6], true[..., 2:6])  # (I, D, G)

    same = tvalid[:, None, :] & (gt_cls[:, None, :] == det_cls[:, :, None])
    other = tvalid[:, None, :] & ~(gt_cls[:, None, :] == det_cls[:, :, None])
    iou_same = np.where(same, iou, -1.0)
    iou_other = np.where(other, iou, -1.0)
    best_iou = iou_same.max(axis=-1)                     # (I, D)
    best_gt = iou_same.argmax(axis=-1)                   # first max, as matcher
    best_other = iou_other.max(axis=-1)

    # First-claimant-wins TP resolution (the matcher of ops/map.py):
    # every candidate claims its best same-class GT; the minimal confidence
    # rank per GT wins. Stable sort by -conf over the detection axis mirrors
    # the matcher's global image-major stable ranking within each image.
    n_img, max_det = det_cls.shape
    max_gt = gt_cls.shape[1]
    rank = np.argsort(
        np.argsort(np.where(pvalid, -det_conf, np.inf),
                   axis=-1, kind="stable"),
        axis=-1, kind="stable")                           # (I, D)
    cand = pvalid & (best_iou > iou_threshold)
    seg = np.where(cand,
                   np.arange(n_img)[:, None] * max_gt + best_gt,
                   n_img * max_gt).reshape(-1)
    first_rank = np.full(n_img * max_gt + 1, np.iinfo(np.int64).max)
    np.minimum.at(first_rank, seg, rank.reshape(-1))
    tp = cand & (rank == first_rank[seg].reshape(n_img, max_det))

    codes = np.full(det_cls.shape, -1, dtype=np.int64)
    codes[pvalid] = 5                                     # background default
    codes[pvalid & (best_other > bg_threshold)] = 4       # both
    codes[pvalid & (best_iou > bg_threshold)] = 3         # localization
    codes[pvalid & (best_other > iou_threshold)] = 2      # classification
    codes[cand] = 1                                       # duplicate (lost claim)
    codes[tp] = 0

    claimed = np.zeros((n_img, max_gt), bool)
    img_idx, det_idx = np.nonzero(tp)
    claimed[img_idx, best_gt[img_idx, det_idx]] = True
    return codes, claimed


def error_analysis(true_boxes, true_valid, pred_boxes, pred_valid,
                   num_classes: int, iou_threshold: float = 0.5,
                   bg_threshold: float = 0.1, chunk: int = 256) -> dict:
    """Categorize every detection and count missed GTs.

    Inputs are the accumulator layout: ``(I, G, 6)`` / ``(I, G)`` decoded
    ground truths + validity and ``(I, D, 6)`` / ``(I, D)`` detections, rows
    ``[cls, conf, cx, cy, w, h]``. Returns::

        {"counts": {category: int}, "num_detections": int, "num_gt": int,
         "missed_gt": int,
         "per_class": {cls: {category: int, "missed_gt": int, "num_gt": int}}}

    ``per_class`` buckets errors by the DETECTION's class (what the model
    said) and misses by the ground truth's class (what it failed to find).
    """
    true_boxes, true_valid, pred_boxes, pred_valid = (
        np.asarray(x) for x in (true_boxes, true_valid, pred_boxes, pred_valid))
    n_img = true_boxes.shape[0]

    cat_by_cls = np.zeros((num_classes, len(CATEGORIES)), np.int64)
    missed_by_cls = np.zeros(num_classes, np.int64)
    gt_by_cls = np.zeros(num_classes, np.int64)
    for lo in range(0, n_img, chunk):
        hi = min(lo + chunk, n_img)
        codes, claimed = _analyze_chunk(
            true_boxes[lo:hi], true_valid[lo:hi],
            pred_boxes[lo:hi], pred_valid[lo:hi],
            iou_threshold, bg_threshold)
        det_cls = pred_boxes[lo:hi, :, 0].astype(np.int64)
        ok = codes >= 0
        np.add.at(cat_by_cls, (det_cls[ok], codes[ok]), 1)
        gt_cls = true_boxes[lo:hi, :, 0].astype(np.int64)
        tv = true_valid[lo:hi]
        np.add.at(gt_by_cls, gt_cls[tv], 1)
        miss = tv & ~claimed
        np.add.at(missed_by_cls, gt_cls[miss], 1)

    totals = cat_by_cls.sum(axis=0)
    per_class = {}
    for c in range(num_classes):
        if gt_by_cls[c] == 0 and cat_by_cls[c].sum() == 0:
            continue
        per_class[c] = {k: int(v) for k, v in zip(CATEGORIES, cat_by_cls[c])}
        per_class[c]["missed_gt"] = int(missed_by_cls[c])
        per_class[c]["num_gt"] = int(gt_by_cls[c])
    return {
        "counts": {k: int(v) for k, v in zip(CATEGORIES, totals)},
        "num_detections": int(totals.sum()),
        "num_gt": int(gt_by_cls.sum()),
        "missed_gt": int(missed_by_cls.sum()),
        "per_class": per_class,
    }


def format_error_table(report: dict, names=None) -> str:
    """Human-readable table for the CLI (cli.evaluate --error-analysis)."""
    c = report["counts"]
    nd = max(report["num_detections"], 1)
    lines = ["detection error analysis "
             f"({report['num_detections']} detections, "
             f"{report['num_gt']} ground truths):"]
    for k in CATEGORIES:
        lines.append(f"  {k:>14s}  {c[k]:6d}  ({100.0 * c[k] / nd:5.1f}%)")
    lines.append(f"  {'missed_gt':>14s}  {report['missed_gt']:6d}  "
                 f"({100.0 * report['missed_gt'] / max(report['num_gt'], 1):5.1f}% of GTs)")
    if report["per_class"]:
        hdr = "  ".join(f"{k[:5]:>5s}" for k in CATEGORIES)
        lines.append(f"  {'class':>16s}  {hdr}  {'miss':>5s}  {'gts':>5s}")
        for cls, row in sorted(report["per_class"].items()):
            label = (names[cls] if names and cls < len(names) else str(cls))
            vals = "  ".join(f"{row[k]:5d}" for k in CATEGORIES)
            lines.append(f"  {label:>16s}  {vals}  {row['missed_gt']:5d}"
                         f"  {row['num_gt']:5d}")
    return "\n".join(lines)
