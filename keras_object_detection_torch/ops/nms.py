"""Class-aware greedy NMS, plain PyTorch (counterpart of
``keras_object_detection_tpu/ops/nms.py`` ``non_max_suppression``,
``batched_non_max_suppression`` and ``top_k_candidates``), and the opt-in
serving variants soft NMS and fast NMS (``batched_soft_non_max_suppression``
and ``batched_fast_non_max_suppression``, ``EvalConfig.nms_mode``; one
image's ``soft_non_max_suppression`` and ``fast_non_max_suppression`` are
row 0 of the batched ones).

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

import numpy as np
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


def batched_soft_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
    sigma: float = 0.5,
    method: str = "gaussian",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware soft NMS (Bodla et al. 2017) over a batch: ``(B, N, 6)
    -> ((B, N, 6), (B, N) bool)``.

    N selection steps, each on every image at once: the highest decayed
    confidence among the rows not yet selected (argmax, ties to the lower
    index, as ``jnp.argmax``) is taken if it is ``> conf_threshold``
    (strict), and decays the confidences of the other rows of its class:
    ``"gaussian"`` by ``exp(-iou**2 / sigma)``, ``"linear"`` by ``1 - iou``
    where ``iou >= iou_threshold`` (quirk IoU). Slots fill in selection
    order, each row carrying its decayed confidence in column 1; slots
    after the last pick are zero rows. Once no image takes a pick the
    remaining steps change nothing; all N run, as in JAX, without a sync
    with the host."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    b, n, _ = boxes.shape
    iou = pairwise_iou_cxcywh(boxes[..., 2:6], boxes[..., 2:6])  # (B, N, N)
    same_class = boxes[..., :, None, 0] == boxes[..., None, :, 0]
    idx = torch.arange(n, device=boxes.device)
    conf = boxes[..., 1].float()
    selected = torch.zeros((b, n), dtype=torch.bool, device=boxes.device)
    slots = torch.full((b, n), n, dtype=torch.long, device=boxes.device)
    slot_conf = torch.zeros((b, n), dtype=torch.float32, device=boxes.device)
    # XLA turns the division by the constant sigma into a multiply by its
    # float32 reciprocal
    inv_sigma = float(np.float32(1.0) / np.float32(sigma))
    neg_inf = torch.tensor(-float("inf"), device=boxes.device)
    for i in range(n):
        cand = torch.where(selected, neg_inf, conf)
        j = cand.argmax(dim=1, keepdim=True)  # (B, 1)
        take = cand.gather(1, j) > conf_threshold
        picked = (idx == j) & take
        selected = selected | picked
        slots[:, i] = torch.where(take, j, n)[:, 0]
        slot_conf[:, i] = torch.where(take, conf.gather(1, j), 0.0)[:, 0]
        rows = j[..., None].expand(-1, 1, n)
        iou_j = iou.gather(1, rows)[:, 0]
        if method == "gaussian":
            decay = torch.exp(-(iou_j * iou_j) * inv_sigma)
        else:
            decay = torch.where(iou_j >= iou_threshold, 1.0 - iou_j, 1.0)
        decay = torch.where(same_class.gather(1, rows)[:, 0] & ~picked & take,
                            decay, 1.0)
        conf = conf * decay
    valid = slots < n
    out = _gather_rows(boxes, slots.clamp(max=n - 1)).clone()
    out[..., 1] = slot_conf.to(out.dtype)
    return torch.where(valid[..., None], out, 0.0), valid


def soft_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
    sigma: float = 0.5,
    method: str = "gaussian",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft NMS of one image: ``(N, 6) -> ((N, 6), (N,) bool)``, rows in
    selection order carrying their decayed confidences."""
    out, valid = batched_soft_non_max_suppression(
        boxes[None], iou_threshold, conf_threshold, sigma, method)
    return out[0], valid[0]


def batched_fast_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast NMS (YOLACT, arXiv:1904.02689 §3.5) over a batch: ``(B, N, 6)
    -> ((B, N, 6), (B, N) bool)``, with ``batched_non_max_suppression``'s
    I/O. In the stable confidence-descending order a row is dropped by any
    earlier row of its class with ``iou >= iou_threshold`` that passes the
    confidence filter, whether or not that row itself survives: one matrix
    reduction, no sequential chain. The keep set is a subset of greedy's."""
    n = boxes.shape[1]
    order = torch.sort(boxes[..., 1], dim=-1, descending=True, stable=True).indices
    sb = _gather_rows(boxes, order)
    alive = sb[..., 1] > conf_threshold
    iou = pairwise_iou_cxcywh(sb[..., 2:6], sb[..., 2:6])
    same_class = sb[..., :, None, 0] == sb[..., None, :, 0]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # suppressed_by[b, i, j]: the higher-ranked i drops j
    suppressed_by = later & same_class & (iou >= iou_threshold) & alive[..., None]
    keep = alive & ~suppressed_by.any(dim=1)
    compact = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    return _gather_rows(sb, compact), torch.gather(keep, 1, compact)


def fast_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast NMS of one image: ``(N, 6) -> ((N, 6), (N,) bool)``, with
    ``non_max_suppression``'s I/O."""
    out, valid = batched_fast_non_max_suppression(boxes[None], iou_threshold,
                                                  conf_threshold)
    return out[0], valid[0]
