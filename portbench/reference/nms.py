"""Serving's post-processing in plain torch: the cut of each image's
candidates to the K most confident (a stable sort, ties to the lower
index) and class-aware greedy NMS (stable confidence-descending order,
``conf > conf_threshold`` strict, a survivor removing each later row of its
class with the reference repo's IoU at or above the threshold)."""

from __future__ import annotations

import torch

from portbench.reference.loss import iou


def _rows(boxes, idx):
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 6))


def _descending(boxes):
    return torch.sort(boxes[..., 1], dim=-1, descending=True,
                      stable=True).indices


def top_k_index(boxes, k: int):
    """``(B, K)`` indices of the cut: every row where there are ``k`` or
    fewer."""
    b, n = boxes.shape[:2]
    if not k or n <= k:
        return torch.arange(n, device=boxes.device).expand(b, n)
    return _descending(boxes)[:, :k]


def top_k(boxes, k: int):
    if not k or boxes.shape[1] <= k:
        return boxes
    return _rows(boxes, top_k_index(boxes, k))


def _survivors(sb, iou_threshold: float, conf_threshold: float):
    """The survivor mask of rows ``sb`` sorted by descending confidence."""
    n = sb.shape[1]
    alive = sb[..., 1] > conf_threshold
    over = iou(sb[..., :, None, 2:6], sb[..., None, :, 2:6])[..., 0]
    same = sb[..., :, None, 0] == sb[..., None, :, 0]
    later = torch.ones(n, n, dtype=torch.bool, device=sb.device).triu(1)
    kills = later & same & (over >= iou_threshold)
    for i in range(n):
        alive = alive & ~(alive[:, i:i + 1] & kills[:, i])
    return alive


def nms(boxes, iou_threshold: float, conf_threshold: float):
    """``(B, N, 6) -> (B, N, 6)`` rows, survivors first in descending
    confidence, and the ``(B, N)`` survivor mask."""
    sb = _rows(boxes, _descending(boxes))
    alive = _survivors(sb, iou_threshold, conf_threshold)
    compact = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True).indices
    return _rows(sb, compact), torch.gather(alive, 1, compact)


def kept(boxes, k: int, iou_threshold: float, conf_threshold: float):
    """``(B, N)``: which rows of ``boxes`` the cut to ``k`` and NMS keep, in
    the rows' own order."""
    cut = top_k_index(boxes, k)
    rows = _rows(boxes, cut)
    order = _descending(rows)
    alive = _survivors(_rows(rows, order), iou_threshold, conf_threshold)
    out = torch.zeros(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
    return out.scatter(1, torch.gather(cut, 1, order), alive)
