"""Class-aware greedy NMS, plain PyTorch (counterpart of
``keras_object_detection_tpu/ops/nms.py`` ``non_max_suppression``,
``batched_non_max_suppression`` and ``top_k_candidates``).

This is the reference the CUDA kernel (``ops/cuda_nms.py``) is held to, and
what the serving path runs on a CPU tensor. Semantics:

1. a stable confidence-descending sort (ties keep their input order),
2. ``conf > conf_threshold`` (strict) makes a row a candidate,
3. in sorted order, a surviving row removes every later row of the same
   class with ``iou >= iou_threshold`` (the reference's quirk IoU),
4. compaction that keeps the sorted order: survivors first, then the
   suppressed and filtered rows.

Outputs are ``(B, N, 6)`` rows and a ``(B, N)`` bool mask of survivors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from keras_object_detection_torch.core.boxes import pairwise_iou_cxcywh


def _gather_rows(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))


def batched_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a batch: ``(B, N, 6) -> ((B, N, 6), (B, N) bool)``."""
    n = boxes.shape[1]
    order = torch.sort(boxes[..., 1], dim=-1, descending=True, stable=True).indices
    sb = _gather_rows(boxes, order)
    alive = sb[..., 1] > conf_threshold

    iou = pairwise_iou_cxcywh(sb[..., 2:6], sb[..., 2:6])  # (B, N, N)
    same_class = sb[..., :, None, 0] == sb[..., None, :, 0]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # suppresses[b, i, j]: if i survives, it removes j
    suppresses = later & same_class & (iou >= iou_threshold)
    for i in range(n):
        alive = alive & ~(alive[:, i:i + 1] & suppresses[:, i])

    compact = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True).indices
    return _gather_rows(sb, compact), torch.gather(alive, 1, compact)


def non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: ``(N, 6) -> ((N, 6), (N,) bool)``; ``kept[valid]`` is the
    reference's NMS output in confidence-descending order."""
    out, valid = batched_non_max_suppression(boxes[None], iou_threshold,
                                             conf_threshold)
    return out[0], valid[0]


def top_k_candidates(boxes: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the K highest-confidence rows per image: ``(B, N, 6) ->
    (B, K, 6)``, in stable descending order (ties to the lower index, like
    ``lax.top_k``; ``torch.topk`` promises no tie order, so a stable sort is
    used). Exact for thresholded NMS whenever at most K rows pass the
    confidence filter."""
    if boxes.shape[-2] <= k:
        return boxes
    idx = torch.sort(boxes[..., 1], dim=-1, descending=True, stable=True).indices
    return _gather_rows(boxes, idx[..., :k])
