"""SxS grid decoding (counterpart of ``keras_object_detection_tpu/core/grid.py``
``decode_grid``; encoding belongs to the training slice, ROADMAP 1.2).

Cell layout along the last axis (depth ``C + 5*B``):
``[class scores (C)] [conf_0, x, y, w, h] [conf_1, x, y, w, h] ...``
where ``x = S*cx - col`` and ``y = S*cy - row`` are cell-relative offsets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
