"""SxS grid encoding and decoding (counterpart of
``keras_object_detection_tpu/core/grid.py`` ``encode_grid`` and
``decode_grid``).

Cell layout along the last axis (depth ``C + 5*B``):
``[class scores (C)] [conf_0, x, y, w, h] [conf_1, x, y, w, h] ...``
where ``x = S*cx - col`` and ``y = S*cy - row`` are cell-relative offsets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def encode_grid(boxes: torch.Tensor, valid: torch.Tensor, num_classes: int,
                num_boxes: int = 2, grid: int = 7) -> torch.Tensor:
    """Encode padded YOLO boxes into ``(batch, S, S, C + 5B)`` targets.

    ``boxes`` is ``(batch, N, 5)`` rows ``[cx, cy, w, h, class_id]`` in image
    ratios, ``valid`` the ``(batch, N)`` mask of real rows. The JAX version
    encodes one image and is vmapped; this one takes the batch.

    First box wins: of the valid boxes that land in one cell, the earliest
    row claims it, by a scatter-min of row indices keyed by cell, with the
    padding rows parked in an extra out-of-range cell. The cell is
    ``floor(S * c)`` clipped to ``[0, S - 1]``, so ``cx == 1.0`` lands in
    the last column. Only box slot 0 is written.
    """
    b, n, _ = boxes.shape
    cells = grid * grid
    depth = num_classes + 5 * num_boxes
    dev = boxes.device
    col = torch.clamp(torch.floor(grid * boxes[..., 0]).long(), 0, grid - 1)
    row = torch.clamp(torch.floor(grid * boxes[..., 1]).long(), 0, grid - 1)
    seg = torch.where(valid.bool(), row * grid + col, cells)
    idx = torch.arange(n, device=dev).expand(b, n)
    winner = torch.full((b, cells + 1), n, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(1, seg, idx, "amin")[:, :cells]
    has_box = winner < n
    winner = torch.where(has_box, winner, 0)
    wboxes = torch.gather(boxes, 1, winner[..., None].expand(b, cells, 5))
    wcls = wboxes[..., 4].long()

    cell_id = torch.arange(cells, device=dev)
    x_off = grid * wboxes[..., 0] - (cell_id % grid).to(boxes.dtype)
    y_off = grid * wboxes[..., 1] - (cell_id // grid).to(boxes.dtype)
    fmask = has_box.to(boxes.dtype)[..., None]
    # one-hot as jax.nn.one_hot has it: an out-of-range class gives zeros
    classes = torch.arange(num_classes, device=dev)
    class_part = (wcls[..., None] == classes).to(boxes.dtype) * fmask
    box_part = torch.stack([x_off, y_off, wboxes[..., 2], wboxes[..., 3]],
                           dim=-1) * fmask

    out = torch.zeros((b, cells, depth), dtype=boxes.dtype, device=dev)
    out[..., :num_classes] = class_part
    out[..., num_classes:num_classes + 1] = fmask
    out[..., num_classes + 1:num_classes + 5] = box_part
    return out.reshape(b, grid, grid, depth)


def decode_grid(predictions: torch.Tensor, num_classes: int,
                num_boxes: int = 2, grid: int = 7) -> torch.Tensor:
    """Decode ``(batch, S, S, C + 5B)`` model output to ``(batch, S*S, 6)``
    rows ``[class_idx, confidence, cx, cy, w, h]`` in image ratios.

    Per cell: class = argmax over the C class scores; box and confidence come
    from the slot with the highest confidence. ``torch.argmax`` returns the
    first maximal index, so ties go to the lower index as in the reference.
    The slot is selected by a one-hot multiply-sum, the reference's
    arithmetic, not by indexing.
    """
    p = predictions
    b = p.shape[0]

    class_idx = torch.argmax(p[..., :num_classes], dim=-1).to(p.dtype)

    rest = p[..., num_classes:].reshape(b, grid, grid, num_boxes, 5)
    confs = rest[..., 0]
    best = torch.argmax(confs, dim=-1)
    onehot = F.one_hot(best, num_boxes).to(p.dtype)
    best_conf = torch.sum(onehot * confs, dim=-1)
    best_box = torch.sum(onehot[..., None] * rest[..., 1:5], dim=-2)

    cols = torch.arange(grid, dtype=p.dtype, device=p.device)[None, None, :]
    rows = torch.arange(grid, dtype=p.dtype, device=p.device)[None, :, None]
    cx = (best_box[..., 0] + cols) / grid
    cy = (best_box[..., 1] + rows) / grid

    out = torch.stack(
        [class_idx, best_conf, cx, cy, best_box[..., 2], best_box[..., 3]], dim=-1)
    return out.reshape(b, grid * grid, 6)
