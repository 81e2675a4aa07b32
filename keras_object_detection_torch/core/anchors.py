"""Anchor grids of the YOLOv2 family (counterpart of
``keras_object_detection_tpu/core/anchors.py``): ``encode_anchor_grid``,
``decode_anchor_grid`` and ``decode_anchor_targets``.

Slot layout along the last axis, per anchor (depth ``B * (5 + C)``):
``[obj, tx, ty, tw, th, class logits (C)]``. A prediction decodes as
``cx = (sigmoid(tx) + col) / S`` and ``w = anchor_w * exp(tw)``; a target
holds the inverse, ``tx* = S * cx - col`` and ``tw* = log(w / anchor_w)``.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

Anchors = Sequence[Tuple[float, float]]


def _shape_iou(wh: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """IoU of box sizes against anchor priors with the centres aligned:
    ``(..., N, 2) x (B, 2) -> (..., N, B)``."""
    inter = (torch.minimum(wh[..., :, None, 0], anchors[:, 0])
             * torch.minimum(wh[..., :, None, 1], anchors[:, 1]))
    union = ((wh[..., 0] * wh[..., 1])[..., None]
             + anchors[:, 0] * anchors[:, 1] - inter)
    return inter / torch.clamp_min(union, 1e-12)


@functools.lru_cache(maxsize=None)
def _anchor_table(anchors: Tuple[Tuple[float, float], ...], dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    return torch.tensor(anchors, dtype=dtype).to(device)


def _anchor_tensor(anchors: Anchors, like: torch.Tensor) -> torch.Tensor:
    """The ``(B, 2)`` priors on ``like``'s device and dtype, made once per
    (priors, dtype, device): a host-to-device copy of a Python list waits
    for the device's queue, which a step or a request should not."""
    return _anchor_table(tuple((float(w), float(h)) for w, h in anchors),
                         like.dtype, like.device)


def encode_anchor_grid(boxes: torch.Tensor, valid: torch.Tensor,
                       num_classes: int, anchors: Anchors,
                       grid: int = 7) -> torch.Tensor:
    """Encode padded YOLO boxes into ``(batch, S, S, B * (5 + C))`` anchor
    targets. ``boxes`` is ``(batch, N, 5)`` rows ``[cx, cy, w, h,
    class_id]`` in image ratios, ``valid`` the ``(batch, N)`` mask of real
    rows. The JAX version encodes one image and is vmapped; this one takes
    the batch.

    A box goes to its centre cell ``clip(floor(S * c), 0, S - 1)`` and to
    the anchor of the highest shape IoU (``argmax``: ties to the lower
    index). Of the valid boxes that land on one (cell, anchor) slot the
    earliest row wins, by a scatter-min of row indices keyed by slot, with
    the padding rows parked in an extra out-of-range slot."""
    a = _anchor_tensor(anchors, boxes)
    nb = a.shape[0]
    b, n, _ = boxes.shape
    nslots = grid * grid * nb
    dev = boxes.device
    col = torch.clamp(torch.floor(grid * boxes[..., 0]).long(), 0, grid - 1)
    row = torch.clamp(torch.floor(grid * boxes[..., 1]).long(), 0, grid - 1)
    best = torch.argmax(_shape_iou(boxes[..., 2:4], a), dim=-1)
    seg = torch.where(valid.bool(), (row * grid + col) * nb + best, nslots)
    idx = torch.arange(n, device=dev).expand(b, n)
    winner = torch.full((b, nslots + 1), n, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(1, seg, idx, "amin")[:, :nslots]
    has_box = winner < n
    winner = torch.where(has_box, winner, 0)
    wb = torch.gather(boxes, 1, winner[..., None].expand(b, nslots, 5))

    slot = torch.arange(nslots, device=dev)
    scol = ((slot // nb) % grid).to(boxes.dtype)
    srow = (slot // (nb * grid)).to(boxes.dtype)
    aw = a[slot % nb]  # (nslots, 2) the prior of each slot
    tx = grid * wb[..., 0] - scol
    ty = grid * wb[..., 1] - srow
    tw = torch.log(torch.clamp_min(wb[..., 2], 1e-9) / aw[:, 0])
    th = torch.log(torch.clamp_min(wb[..., 3], 1e-9) / aw[:, 1])
    # one-hot as jax.nn.one_hot has it: an out-of-range class gives zeros
    classes = torch.arange(num_classes, device=dev)
    onehot = (wb[..., 4].to(torch.int32)[..., None] == classes).to(boxes.dtype)

    fmask = has_box.to(boxes.dtype)[..., None]
    out = torch.cat([torch.ones_like(fmask), torch.stack([tx, ty, tw, th], -1),
                     onehot], dim=-1) * fmask
    return out.reshape(b, grid, grid, nb * (5 + num_classes))


def _offsets(grid: int, like: torch.Tensor):
    cols = torch.arange(grid, dtype=like.dtype, device=like.device)
    return cols[None, None, :, None], cols[None, :, None, None]


def decode_anchor_grid(predictions: torch.Tensor, num_classes: int,
                       anchors: Anchors, grid: int = 7) -> torch.Tensor:
    """Decode ``(batch, S, S, B * (5 + C))`` raw model output to ``(batch,
    S * S * B, 6)`` rows ``[class_idx, confidence, cx, cy, w, h]``: sigmoid
    offsets, ``anchor * exp(clip(t, -9, 9))`` sizes, softmax class
    probabilities, confidence ``sigmoid(obj) * max p``, class = argmax (ties
    to the lower index). Every anchor slot emits a row; NMS prunes them."""
    a = _anchor_tensor(anchors, predictions)
    nb = a.shape[0]
    b = predictions.shape[0]
    p = predictions.reshape(b, grid, grid, nb, 5 + num_classes)
    cols, rows = _offsets(grid, p)
    obj = torch.sigmoid(p[..., 0])
    cx = (torch.sigmoid(p[..., 1]) + cols) / grid
    cy = (torch.sigmoid(p[..., 2]) + rows) / grid
    w = a[:, 0] * torch.exp(torch.clamp(p[..., 3], -9.0, 9.0))
    h = a[:, 1] * torch.exp(torch.clamp(p[..., 4], -9.0, 9.0))
    probs = torch.softmax(p[..., 5:], dim=-1)
    cls = torch.argmax(probs, dim=-1).to(p.dtype)
    conf = obj * torch.amax(probs, dim=-1)
    out = torch.stack([cls, conf, cx, cy, w, h], dim=-1)
    return out.reshape(b, grid * grid * nb, 6)


def decode_anchor_targets(targets: torch.Tensor, num_classes: int,
                          anchors: Anchors, grid: int = 7) -> torch.Tensor:
    """Decode ``encode_anchor_grid`` output back to ``(batch, S * S * B,
    6)`` ground-truth rows (no sigmoid: targets hold the inverse transform;
    obj is already 0/1). Empty slots are zero rows."""
    a = _anchor_tensor(anchors, targets)
    nb = a.shape[0]
    b = targets.shape[0]
    t = targets.reshape(b, grid, grid, nb, 5 + num_classes)
    cols, rows = _offsets(grid, t)
    obj = t[..., 0]
    cx = (t[..., 1] + cols) / grid
    cy = (t[..., 2] + rows) / grid
    w = a[:, 0] * torch.exp(t[..., 3])
    h = a[:, 1] * torch.exp(t[..., 4])
    cls = torch.argmax(t[..., 5:], dim=-1).to(t.dtype)
    out = torch.stack([cls, obj, cx, cy, w, h], dim=-1)
    out = torch.where(obj[..., None] > 0, out, torch.zeros_like(out))
    return out.reshape(b, grid * grid * nb, 6)
