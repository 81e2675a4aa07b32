"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each beside its limit. A cell's limits file
(``limits/<cell>.json``) names the numbers it compares; the others are
computed for ``calibrate.py`` and PERF.md.

Training, over the first three steps of the object the window drives
(leaves whose reference gradient is under ``LEAF_FLOOR`` of the median
moving leaf's, a conv bias under BatchNorm, are left out: their gradient is
nought but for rounding, and under Adam they move by round-off alone; the
median moving leaf is the median of the leaves at or above ``LEAF_FLOOR``
of the median of all, since the leaves left out would pull a median of all
down toward them):

- ``loss_gap.<i>``: ``|loss - reference| / |reference|`` of step i;
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient as the optimizer got it (its first moment over
  ``1 - b1``) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's; ``grad_gap.median_leaf`` and
  ``grad_gap.upper_quartile``: the median and the upper quartile
  (``statistics.quantiles``) of ``|norm - reference| / reference`` over the
  leaves;
- ``change_gap`` and ``change_gap.median_leaf``: the same of the norm of
  each leaf's change over the three steps.

Serving, over a sample of the window's calls drawn from the seed:

- ``box_gap``: over every box served, the distance to the nearest row of
  its class that the reference's decoding could give: the largest
  difference of confidence and coordinates (absolute, relative where the
  reference's value is above 1, as a YOLOv3 box side can be), or, where
  larger, how far that row's scores lie below the reference's own choice;
- ``box_gap.median``: the median over the served boxes of the same
  distance, steady where a few boxes swing the largest;
- ``kept_missed``: the number of the boxes that the reference's cut and NMS
  keep, and that no rounding can tip (``robust_kept``), which are not
  served: no served box of their image and class lies within ``MATCH`` of
  them (``kept_robust``, how many there are, is not compared);
- ``served_overlap``: the largest IoU (the NMS's own) between two served
  boxes of one image and class, which NMS keeps under its threshold;
- ``served_under``: the number of served boxes whose confidence is not
  above the confidence threshold.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable

import torch

LEAF_FLOOR = 1e-3
BOX_ROWS = 64  # served boxes compared at once against the choices
# A kept box is one that no rounding can tip (``robust_kept``) when it lies
# DELTA_CONF above the confidence threshold and the cut, every other row
# decoding could give at its place lies DELTA_MARGIN below decoding's
# choice, and no candidate that could take its class lies within DELTA_IOU
# of the IoU threshold or above it. MATCH: the largest ``box_gap``-like
# distance at which a served box stands for it.
DELTA_CONF = 0.1
DELTA_MARGIN = 0.1
DELTA_IOU = 0.15
MATCH = 0.3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              leaves) -> float:
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


def _median_leaf_gap(prog, ref, leaves) -> float:
    return statistics.median(abs(prog[k] - ref[k]) / ref[k] for k in leaves)


def _upper_quartile_gap(prog, ref, leaves) -> float:
    return statistics.quantiles(
        [abs(prog[k] - ref[k]) / ref[k] for k in leaves], n=4)[2]


def moving_leaves(grad: Dict[str, float]):
    """The leaves whose reference gradient is at or above ``LEAF_FLOOR`` of
    the median moving leaf's."""
    first = statistics.median(grad.values())
    median = statistics.median(g for g in grad.values()
                               if g >= LEAF_FLOOR * first)
    return [k for k, g in grad.items() if g >= LEAF_FLOOR * median]


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number of a train run (``prog`` and ``ref`` as
    ``reference.steps.train`` returns them): each step's loss gap, and the
    worst, the median and the upper quartile leaf's gap of the first
    gradient, and the worst and the median leaf's gap of the change."""
    moving = moving_leaves(ref["grad"])
    out = {f"loss_gap.{i}": abs(p - r) / abs(r)
           for i, (p, r) in enumerate(zip(prog["loss"], ref["loss"]))}
    out.update({
        "grad_gap": _leaf_gap(prog["grad"], ref["grad"], moving),
        "grad_gap.median_leaf": _median_leaf_gap(prog["grad"], ref["grad"],
                                                 moving),
        "grad_gap.upper_quartile": _upper_quartile_gap(
            prog["grad"], ref["grad"], moving),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moving),
        "change_gap.median_leaf": _median_leaf_gap(prog["change"],
                                                   ref["change"], moving)})
    return out


def _distance(served, ref):
    """``(S, R)``: the largest difference of confidence and coordinates
    between served rows and reference rows (relative where the reference's
    value is above 1), infinite between different classes."""
    diff = (served[:, None, 1:6] - ref[None, :, 1:6]).abs()
    dist = (diff / ref[None, :, 1:6].abs().clamp_min(1.0)).amax(-1)
    other = served[:, None, 0] != ref[None, :, 0]
    return torch.where(other, torch.full_like(dist, float("inf")), dist)


def box_gaps(rows: torch.Tensor, valid: torch.Tensor, choices: torch.Tensor,
             margin: torch.Tensor) -> torch.Tensor:
    """``box_gap`` of each served box of one call, in the image's order:
    ``rows``/``valid`` served ``(B, N, 6)`` / ``(B, N)``; ``choices``/
    ``margin`` the reference's ``(B, M, 6)`` / ``(B, M)``."""
    out = []
    for b in range(rows.shape[0]):
        served = rows[b][valid[b]]
        for lo in range(0, served.shape[0], BOX_ROWS):
            dist = torch.maximum(
                _distance(served[lo:lo + BOX_ROWS], choices[b]),
                margin[b][None, :])
            out.append(dist.amin(-1))
    return torch.cat(out) if out else rows.new_zeros(0)


def robust_kept(ref: Dict, e: Dict) -> torch.Tensor:
    """``(B, N)``: the candidates that the reference keeps and that no
    rounding of the served model can tip: confidence ``DELTA_CONF`` above
    the threshold and above the cut's last; every other row that decoding
    could give at the candidate's place ``DELTA_MARGIN`` below decoding's
    choice; and no row that decoding could give elsewhere, within
    ``DELTA_MARGIN`` of being chosen, of the same class and within
    ``DELTA_CONF`` of the threshold or above, overlapping it by the IoU
    threshold less ``DELTA_IOU`` or more. ``ref`` as ``reference.steps.serve``
    yields it; ``e`` the configuration's ``eval``."""
    from portbench.reference.loss import iou

    dec, kept = ref["decoded"], ref["kept"]
    choices, margin = ref["choices"], ref["margin"]
    b, n = kept.shape
    group = choices.shape[1] // n
    conf = dec[..., 1]
    ok = kept & (conf >= e["conf_threshold"] + DELTA_CONF)
    k = e["max_candidates"]
    if k and n > k:
        last = conf.topk(k, dim=1).values[:, -1:]
        ok &= conf >= last + DELTA_CONF
    ok &= margin.view(b, n, group).sort(-1).values[..., 1] >= DELTA_MARGIN
    for i in range(b):
        idx = ok[i].nonzero()[:, 0]
        if not idx.numel():
            continue
        near = ((margin[i] < DELTA_MARGIN)
                & (choices[i][:, 1] > e["conf_threshold"] - DELTA_CONF))
        rows = choices[i][near]
        place = near.nonzero()[:, 0] // group
        mine = dec[i][idx]
        clash = ((mine[:, None, 0] == rows[None, :, 0])
                 & (idx[:, None] != place[None, :])
                 & (iou(mine[:, None, 2:6], rows[None, :, 2:6])[..., 0]
                    >= e["iou_threshold"] - DELTA_IOU)).any(1)
        ok[i, idx[clash]] = False
    return ok


def served_set(rows: torch.Tensor, valid: torch.Tensor, ref: Dict,
               e: Dict) -> Dict[str, float]:
    """Of one call: the robust kept boxes (``kept_robust``) and how many of
    them were not served (``missed``), the largest IoU between two served
    boxes of one image and class (``served_overlap``) and the served boxes
    not above the confidence threshold (``served_under``)."""
    from portbench.reference.loss import iou

    robust = robust_kept(ref, e)
    out = {"kept_robust": 0, "missed": 0, "served_overlap": 0.0,
           "served_under": 0}
    for b in range(rows.shape[0]):
        served = rows[b][valid[b]]
        want = ref["decoded"][b][robust[b]]
        out["kept_robust"] += want.shape[0]
        if want.shape[0]:
            near = (_distance(served, want) <= MATCH).any(0) \
                if served.shape[0] else torch.zeros(
                    want.shape[0], dtype=torch.bool, device=want.device)
            out["missed"] += int((~near).sum())
        out["served_under"] += int((served[:, 1] <= e["conf_threshold"])
                                   .sum())
        if served.shape[0] > 1:
            over = iou(served[:, None, 2:6], served[None, :, 2:6])[..., 0]
            same = served[:, None, 0] == served[None, :, 0]
            pair = same & torch.ones_like(same).triu(1)
            if bool(pair.any()):
                out["served_overlap"] = max(out["served_overlap"],
                                            float(over[pair].max()))
    return out


def serve_readings(calls: Iterable[Dict], e: Dict) -> Dict[str, float]:
    """``calls``: per sampled call, the served ``rows``/``valid`` and
    ``ref``, what ``reference.steps.serve`` yields for it; ``e`` the
    configuration's ``eval``."""
    gaps, robust, missed, overlap, under = [], 0, 0, 0.0, 0
    for c in calls:
        ref = c["ref"]
        gaps.append(box_gaps(c["rows"], c["valid"], ref["choices"],
                             ref["margin"]))
        s = served_set(c["rows"], c["valid"], ref, e)
        robust += s["kept_robust"]
        missed += s["missed"]
        overlap = max(overlap, s["served_overlap"])
        under += s["served_under"]
    gaps = torch.cat(gaps)
    return {"box_gap": float(gaps.max()) if gaps.numel() else 0.0,
            "box_gap.median": (float(gaps.median()) if gaps.numel()
                               else 0.0),
            "kept_missed": missed, "kept_robust": robust,
            "served_overlap": overlap, "served_under": under}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each reading beside its limit; a reading that is missing or not a
    number fails."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit,
                     "ok": bool(value == value and value <= limit)}
    return out


def report(checked: Dict) -> None:
    """The compared numbers as the last lines on standard error."""
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr, flush=True)
