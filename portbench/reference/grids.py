"""Targets and decoding of the two heads, in plain torch and float32.

YOLOv1 grid cells hold ``[C class scores][conf, x, y, w, h] x B`` with
cell-relative ``x = S cx - col``; only slot 0 of a cell's target is
written, by the first valid box that lands in it. YOLOv3 slots hold ``[obj,
tx, ty, tw, th, C class logits]`` per prior; a box goes to the scale of its
best prior over all scales (shape IoU, first maximum), then to its centre
cell and that prior, the first box winning a slot. Decoding gives rows
``[class, conf, cx, cy, w, h]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _first_winner(seg, nslots, n, b, dev):
    """Of the rows keyed to each slot, the earliest; ``n`` where none."""
    idx = torch.arange(n, device=dev).expand(b, n)
    winner = torch.full((b, nslots + 1), n, dtype=torch.long, device=dev)
    return winner.scatter_reduce(1, seg, idx, "amin")[:, :nslots]


def encode_v1(boxes, valid, c: int, nbox: int, grid: int):
    b, n, _ = boxes.shape
    dev = boxes.device
    cells = grid * grid
    col = torch.clamp(torch.floor(grid * boxes[..., 0]).long(), 0, grid - 1)
    row = torch.clamp(torch.floor(grid * boxes[..., 1]).long(), 0, grid - 1)
    seg = torch.where(valid.bool(), row * grid + col, cells)
    winner = _first_winner(seg, cells, n, b, dev)
    has = winner < n
    wb = torch.gather(boxes, 1, torch.where(has, winner, 0)[..., None]
                      .expand(b, cells, 5))
    cell = torch.arange(cells, device=dev)
    x = grid * wb[..., 0] - (cell % grid).float()
    y = grid * wb[..., 1] - (cell // grid).float()
    m = has.float()[..., None]
    out = torch.zeros((b, cells, c + 5 * nbox), device=dev)
    out[..., :c] = (wb[..., 4].long()[..., None]
                    == torch.arange(c, device=dev)).float() * m
    out[..., c:c + 1] = m
    out[..., c + 1:c + 5] = torch.stack([x, y, wb[..., 2], wb[..., 3]], -1) * m
    return out.reshape(b, grid, grid, -1)


def decode_v1(p, c: int, nbox: int, grid: int):
    b = p.shape[0]
    cls = torch.argmax(p[..., :c], dim=-1).float()
    rest = p[..., c:].reshape(b, grid, grid, nbox, 5)
    best = torch.argmax(rest[..., 0], dim=-1)
    onehot = F.one_hot(best, nbox).float()
    conf = torch.sum(onehot * rest[..., 0], dim=-1)
    box = torch.sum(onehot[..., None] * rest[..., 1:5], dim=-2)
    cols = torch.arange(grid, device=p.device).float()
    cx = (box[..., 0] + cols[None, None, :]) / grid
    cy = (box[..., 1] + cols[None, :, None]) / grid
    out = torch.stack([cls, conf, cx, cy, box[..., 2], box[..., 3]], dim=-1)
    return out.reshape(b, grid * grid, 6)


def shape_iou(wh, anchors):
    """IoU of box sizes against priors, centres aligned: ``(..., N, 2) x
    (A, 2) -> (..., N, A)``."""
    inter = (torch.minimum(wh[..., :, None, 0], anchors[:, 0])
             * torch.minimum(wh[..., :, None, 1], anchors[:, 1]))
    union = ((wh[..., 0] * wh[..., 1])[..., None]
             + anchors[:, 0] * anchors[:, 1] - inter)
    return inter / torch.clamp_min(union, 1e-12)


def partition(anchors: Sequence, scales: int):
    """Priors sorted by area, largest first, cut into ``scales`` groups."""
    per = len(anchors) // scales
    by_area = sorted((tuple(a) for a in anchors), key=lambda a: -(a[0] * a[1]))
    return [by_area[s * per:(s + 1) * per] for s in range(scales)]


def encode_anchor(boxes, valid, c: int, anchors, grid: int):
    a = torch.tensor(anchors, dtype=torch.float32, device=boxes.device)
    nb = a.shape[0]
    b, n, _ = boxes.shape
    dev = boxes.device
    nslots = grid * grid * nb
    col = torch.clamp(torch.floor(grid * boxes[..., 0]).long(), 0, grid - 1)
    row = torch.clamp(torch.floor(grid * boxes[..., 1]).long(), 0, grid - 1)
    best = torch.argmax(shape_iou(boxes[..., 2:4], a), dim=-1)
    seg = torch.where(valid.bool(), (row * grid + col) * nb + best, nslots)
    winner = _first_winner(seg, nslots, n, b, dev)
    has = winner < n
    wb = torch.gather(boxes, 1, torch.where(has, winner, 0)[..., None]
                      .expand(b, nslots, 5))
    slot = torch.arange(nslots, device=dev)
    prior = a[slot % nb]
    tx = grid * wb[..., 0] - ((slot // nb) % grid).float()
    ty = grid * wb[..., 1] - (slot // (nb * grid)).float()
    tw = torch.log(torch.clamp_min(wb[..., 2], 1e-9) / prior[:, 0])
    th = torch.log(torch.clamp_min(wb[..., 3], 1e-9) / prior[:, 1])
    onehot = (wb[..., 4].to(torch.int32)[..., None]
              == torch.arange(c, device=dev)).float()
    m = has.float()[..., None]
    out = torch.cat([torch.ones_like(m), torch.stack([tx, ty, tw, th], -1),
                     onehot], dim=-1) * m
    return out.reshape(b, grid, grid, nb * (5 + c))


def encode_fpn(boxes, valid, c: int, anchors, grid: int, scales: int):
    parts = partition(anchors, scales)
    flat = torch.tensor([a for p in parts for a in p], dtype=torch.float32,
                        device=boxes.device)
    per = flat.shape[0] // scales
    scale_of = torch.argmax(shape_iou(boxes[..., 2:4], flat), dim=-1) // per
    return tuple(encode_anchor(boxes, valid.bool() & (scale_of == s), c,
                               parts[s], grid * 2 ** s)
                 for s in range(scales))


def _anchor_parts(p, c: int, anchors, grid: int):
    """``(a, p)``: priors and the raw slots ``(b, S, S, A, 5 + C)``."""
    a = torch.tensor(anchors, dtype=torch.float32, device=p.device)
    return a, p.reshape(p.shape[0], grid, grid, a.shape[0], 5 + c)


def decode_anchor(p, c: int, anchors, grid: int):
    a, p = _anchor_parts(p, c, anchors, grid)
    cols = torch.arange(grid, device=p.device).float()
    cx = (torch.sigmoid(p[..., 1]) + cols[None, None, :, None]) / grid
    cy = (torch.sigmoid(p[..., 2]) + cols[None, :, None, None]) / grid
    w = a[:, 0] * torch.exp(torch.clamp(p[..., 3], -9.0, 9.0))
    h = a[:, 1] * torch.exp(torch.clamp(p[..., 4], -9.0, 9.0))
    probs = torch.softmax(p[..., 5:], dim=-1)
    conf = torch.sigmoid(p[..., 0]) * torch.amax(probs, dim=-1)
    out = torch.stack([torch.argmax(probs, dim=-1).float(), conf, cx, cy, w,
                       h], dim=-1)
    return out.reshape(p.shape[0], -1, 6)


def decode_anchor_targets(t, c: int, anchors, grid: int):
    a, t = _anchor_parts(t, c, anchors, grid)
    cols = torch.arange(grid, device=t.device).float()
    out = torch.stack([
        torch.argmax(t[..., 5:], dim=-1).float(), t[..., 0],
        (t[..., 1] + cols[None, None, :, None]) / grid,
        (t[..., 2] + cols[None, :, None, None]) / grid,
        a[:, 0] * torch.exp(t[..., 3]), a[:, 1] * torch.exp(t[..., 4])], -1)
    out = torch.where(t[..., :1] > 0, out, torch.zeros_like(out))
    return out.reshape(t.shape[0], -1, 6)


def decode_fpn(preds, c: int, anchors, grid: int, scales: int):
    parts = partition(anchors, scales)
    return torch.cat([decode_anchor(p, c, parts[s], grid * 2 ** s)
                      for s, p in enumerate(preds)], dim=1)


def choices(preds, cfg: dict):
    """Every row that decoding could give with another argmax: ``(rows,
    margin)``, rows ``(B, M, 6)`` over each (cell or slot, box slot, class)
    and ``margin`` ``(B, M)`` how far below the decode's own choice its
    scores lie (0 for the row decoding gives). A served row of the system
    whose own rounding tipped an argmax is a row here with a small margin."""
    g, m = cfg["grid"], cfg["model"]
    c = g["num_classes"]
    if m["head"] == "fpn":
        parts = partition(g["anchors"], m["fpn_scales"])
        rows, margins = zip(*(_anchor_choices(p, c, parts[s],
                                              g["grid"] * 2 ** s)
                              for s, p in enumerate(preds)))
        return torch.cat(rows, 1), torch.cat(margins, 1)
    p = preds
    b, s, nb = p.shape[0], g["grid"], g["num_boxes"]
    scores = p[..., :c]                                   # (b, S, S, C)
    rest = p[..., c:].reshape(b, s, s, nb, 5)
    cols = torch.arange(s, device=p.device).float()
    cx = (rest[..., 1] + cols[None, None, :, None]) / s   # (b, S, S, nb)
    cy = (rest[..., 2] + cols[None, :, None, None]) / s
    box = torch.stack([rest[..., 0], cx, cy, rest[..., 3], rest[..., 4]], -1)
    cls = torch.arange(c, device=p.device).float()
    rows = torch.cat([
        cls[None, None, None, None, :, None].expand(b, s, s, nb, c, 1),
        box[..., None, :].expand(b, s, s, nb, c, 5)], -1)
    class_margin = scores.amax(-1, keepdim=True) - scores       # (b,S,S,C)
    slot_margin = rest[..., 0].amax(-1, keepdim=True) - rest[..., 0]
    margin = torch.maximum(class_margin[..., None, :], slot_margin[..., None])
    return rows.reshape(b, -1, 6), margin.reshape(b, -1)


def _anchor_choices(p, c: int, anchors, grid: int):
    a, p = _anchor_parts(p, c, anchors, grid)
    b, na = p.shape[0], a.shape[0]
    cols = torch.arange(grid, device=p.device).float()
    cx = (torch.sigmoid(p[..., 1]) + cols[None, None, :, None]) / grid
    cy = (torch.sigmoid(p[..., 2]) + cols[None, :, None, None]) / grid
    w = a[:, 0] * torch.exp(torch.clamp(p[..., 3], -9.0, 9.0))
    h = a[:, 1] * torch.exp(torch.clamp(p[..., 4], -9.0, 9.0))
    probs = torch.softmax(p[..., 5:], dim=-1)                   # (b,S,S,A,C)
    conf = torch.sigmoid(p[..., 0])[..., None] * probs
    cls = torch.arange(c, device=p.device).float()
    geo = torch.stack([cx, cy, w, h], -1)[..., None, :].expand(
        b, grid, grid, na, c, 4)
    rows = torch.cat([cls.expand(b, grid, grid, na, c)[..., None],
                      conf[..., None], geo], -1)
    margin = probs.amax(-1, keepdim=True) - probs
    return rows.reshape(b, -1, 6), margin.reshape(b, -1)
