"""The plain reference against the system at a tiny size on the CPU, with
the configurations' compute in float32 (so the two agree to float32's
rounding): the train step's first three steps and a serving call."""

import pytest

from portbench import check, run
from portbench.tests import tiny

F32 = {"model": {"compute_dtype": "float32"}}


@pytest.mark.parametrize("workload", ["yolov1-train-b64", "yolov3-train-b64"])
def test_train_steps_match_the_reference(workload):
    cell = tiny.cell(workload, over=F32)
    run.run_cell(cell, run.benchmark())
    d = check.train_readings(cell.compared["prog"], cell.compared["ref"])
    assert d["loss_gap.0"] < 1e-5
    assert d["grad_gap"] < 1e-2
    assert d["grad_gap.median_leaf"] < 1e-4


@pytest.mark.parametrize("workload", ["yolov1-serve-b32", "yolov3-serve-b32"])
def test_serving_matches_the_reference(workload):
    from portbench.reference import steps as reference

    cell = tiny.cell(workload, over=F32)
    assert run.run_cell(cell, run.benchmark())["correct"]
    c = cell.compared
    refs = reference.serve(cell.config, c["weights"], c["batches"])
    d = check.serve_readings(
        ({"rows": rows, "valid": valid, "ref": r}
         for (rows, valid), r in zip(c["served"], refs)),
        cell.config["eval"])
    assert d["box_gap"] < 1e-4
    assert d["kept_robust"] > 0 and d["kept_missed"] == 0
    assert d["served_overlap"] < 0.5
    assert d["served_under"] == 0


def test_kept_marks_the_rows_nms_serves():
    import torch

    from portbench.reference import nms

    gen = torch.Generator().manual_seed(3)
    boxes = torch.rand(4, 300, 6, generator=gen)
    boxes[..., 0] = torch.randint(0, 3, (4, 300), generator=gen).float()
    boxes[..., 4:] *= 0.4
    rows, valid = nms.nms(nms.top_k(boxes, 128), 0.5, 0.4)
    kept = nms.kept(boxes, 128, 0.5, 0.4)
    for b in range(4):
        served = rows[b][valid[b]]
        mine = boxes[b][kept[b]]
        assert served.shape[0] > 5
        order = torch.sort(mine[:, 1], descending=True, stable=True).indices
        assert torch.equal(served, mine[order])


def test_robust_kept_leaves_out_what_rounding_can_tip():
    import torch

    e = {"conf_threshold": 0.4, "iou_threshold": 0.5, "max_candidates": 0}
    # two candidates of one class, one place each (two choices a place: the
    # decode's own and one other class)
    decoded = torch.tensor([[[0, 0.9, 0.3, 0.3, 0.2, 0.2],
                             [0, 0.8, 0.7, 0.7, 0.2, 0.2]]])
    choices = torch.tensor([[[0, 0.9, 0.3, 0.3, 0.2, 0.2],
                             [1, 0.9, 0.3, 0.3, 0.2, 0.2],
                             [0, 0.8, 0.7, 0.7, 0.2, 0.2],
                             [1, 0.8, 0.7, 0.7, 0.2, 0.2]]])
    ref = {"decoded": decoded, "kept": torch.tensor([[True, True]]),
           "choices": choices,
           "margin": torch.tensor([[0.0, 0.5, 0.0, 0.5]])}
    assert check.robust_kept(ref, e).tolist() == [[True, True]]
    # the second place's other class within rounding: that box is not robust
    ref["margin"] = torch.tensor([[0.0, 0.5, 0.0, 0.05]])
    assert check.robust_kept(ref, e).tolist() == [[True, False]]
    # the second box moved onto the first, both of one class: neither is
    # robust
    ref["margin"] = torch.tensor([[0.0, 0.5, 0.0, 0.5]])
    ref["decoded"] = decoded.clone()
    ref["choices"] = choices.clone()
    ref["decoded"][0, 1, 2:4] = 0.32
    ref["choices"][0, 2:, 2:4] = 0.32
    assert check.robust_kept(ref, e).tolist() == [[False, False]]
    # a confidence within DELTA_CONF of the threshold: not robust
    ref = dict(ref, decoded=decoded.clone(), choices=choices)
    ref["decoded"][0, 1, 1] = 0.45
    assert check.robust_kept(ref, e).tolist() == [[True, False]]


def test_moving_leaves_leave_out_what_rounding_alone_moves():
    # 60 leaves that move, spread from 10 to 1000 (their median 100), and
    # 20 conv biases under BatchNorm whose gradient is round-off: one of
    # them at 6e-4 of the moving median, above a thousandth of the median
    # of all 80 leaves, which the biases pull down to about 47
    grad = {f"w{i}": 10.0 ** (1 + 2 * i / 59) for i in range(60)}
    grad.update({f"b{i}": 1e-4 for i in range(19)})
    grad["b19"] = 0.06
    assert sorted(check.moving_leaves(grad)) == sorted(
        f"w{i}" for i in range(60))
