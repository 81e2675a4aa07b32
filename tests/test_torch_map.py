"""The port's mAP (``ops/map.py``) against the JAX package's: the matcher on
seeded random box sets (PR curves, hence TP/FP counts, and AP within
1e-6), the reference goldens, the cases of ``tests/test_map.py``, and the
``MeanAveragePrecision`` accumulator on the same grids (with and without
``image_valid``, NMS on the targets or not, a top-K cut). On the CPU the
accumulator's NMS is the plain version; on the card it is the NMS kernel
(``tests/test_torch_gpu.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.ops import map as jmap
from keras_object_detection_torch.ops import map as tmap


def _pad(rows, n):
    rows = np.asarray(rows, np.float32).reshape(-1, 6)
    out = np.zeros((n, 6), np.float32)
    out[:len(rows)] = rows
    valid = np.zeros(n, bool)
    valid[:len(rows)] = True
    return out, valid


def random_sets(seed: int, images: int = 6, gts: int = 5, dets: int = 9,
                classes: int = 3):
    """Padded GT and detection sets: jittered copies of the GTs (some
    exact, some duplicated, confidences with ties) plus random boxes."""
    rng = np.random.RandomState(seed)
    sets = []
    for _ in range(images):
        g = [[float(rng.randint(classes)), 1.0, *rng.uniform(0.2, 0.8, 2),
              *rng.uniform(0.05, 0.3, 2)] for _ in range(rng.randint(0, gts + 1))]
        d = []
        for r in g:
            for _ in range(rng.randint(0, 3)):
                r2 = list(r)
                r2[1] = float(rng.choice([0.5, 0.75, rng.uniform(0.3, 1.0)]))
                if rng.rand() < 0.7:
                    r2[2:6] = list(np.asarray(r[2:6]) + rng.uniform(-0.04, 0.04, 4))
                if rng.rand() < 0.15:
                    r2[0] = float(rng.randint(classes))
                d.append(r2)
        while len(d) < dets and rng.rand() < 0.6:
            d.append([float(rng.randint(classes)), float(rng.uniform(0.3, 1.0)),
                      *rng.uniform(0.2, 0.8, 2), *rng.uniform(0.05, 0.3, 2)])
        gp, gv = _pad(g, gts)
        dp, dv = _pad(d[:dets], dets)
        sets.append((gp, gv, dp, dv))
    return tuple(np.stack(x) for x in zip(*sets))


def _both(fn_name, sets, *args):
    got = getattr(tmap, fn_name)(*(torch.from_numpy(x) for x in sets), *args)
    want = getattr(jmap, fn_name)(*(jnp.asarray(x) for x in sets), *args)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", range(6))
def test_matcher_matches_jax_on_random_sets(seed):
    sets = random_sets(seed)
    for thr in (0.3, 0.5, 0.75):
        got, want = _both("mean_average_precision", sets, 3, thr)
        np.testing.assert_allclose(got, want, atol=1e-6)
        got, want = _both("average_precision_per_class", sets, 3, thr)
        np.testing.assert_allclose(got, want, atol=1e-6)
    got, want = _both("mean_average_precision_multi", sets, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the PR curves are the TP / FP cumulative counts over the sorted
    # stream, so equal curves mean equal TP / FP assignments
    t = tmap._map_at_thresholds(*(torch.from_numpy(x) for x in sets), 3, (0.5,),
                                return_curves=True)
    j = jmap._map_at_thresholds(*(jnp.asarray(x) for x in sets), 3, (0.5,),
                                return_curves=True)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    for a, b in zip(t[1:3], j[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    tp = np.rint(t[1].numpy()[:, 1:] * (t[3].numpy()[:, None] + 1e-6))
    want_tp = np.rint(np.asarray(j[1])[:, 1:] * (np.asarray(j[3])[:, None] + 1e-6))
    np.testing.assert_array_equal(tp, want_tp)


def test_accumulator_matches_reference_goldens(goldens):
    for case in goldens["map"]:
        ours = tmap.MeanAveragePrecision(case["num_classes"], case["num_boxes"])
        theirs = jmap.MeanAveragePrecision(case["num_classes"], case["num_boxes"])
        for yt, yp in zip(case["y_true"], case["y_pred"]):
            yt, yp = np.asarray(yt, np.float32), np.asarray(yp, np.float32)
            ours.update_state(torch.from_numpy(yt), torch.from_numpy(yp))
            theirs.update_state(yt, yp)
        assert np.isclose(ours.result(), case["map"], rtol=1e-4, atol=1e-5)
        assert abs(ours.result() - theirs.result()) <= 1e-6


def _one(rows_gt, rows_det, n=4):
    gt, gv = _pad(rows_gt, n)
    det, dv = _pad(rows_det, n)
    return gt[None], gv[None], det[None], dv[None]


BOX = [0.5, 0.5, 0.2, 0.2]
MAP_CASES = {
    # test_map.py's cases: (sets, classes, expected mAP)
    "perfect detection is 1": (_one([[0, 1.0, *BOX]], [[0, 0.9, *BOX]]), 1, 1.0),
    "absent class counts 0": (_one([[0, 1.0, *BOX]], [[0, 0.9, *BOX]]), 2, 0.5),
    "duplicate detection is an FP": (
        _one([[0, 1.0, *BOX]], [[0, 0.9, *BOX], [0, 0.8, *BOX]]), 1, 1.0),
    "detection in another image": (
        tuple(np.concatenate(x) for x in zip(_one([[0, 1.0, *BOX]], []),
                                             _one([], [[0, 0.9, *BOX]]))), 1, 0.0),
    "low IoU is an FP": (_one([[0, 1.0, 0.2, 0.2, 0.1, 0.1]],
                              [[0, 0.9, 0.8, 0.8, 0.1, 0.1]]), 1, 0.0),
}


@pytest.mark.parametrize("name", MAP_CASES)
def test_map_cases(name):
    sets, classes, expected = MAP_CASES[name]
    got, want = _both("mean_average_precision", sets, classes)
    assert np.isclose(got, expected, atol=1e-3)
    assert abs(got - want) <= 1e-6
    aps, _ = _both("average_precision_per_class", sets, classes)
    assert np.isclose(aps.mean(), got, atol=1e-6)


def test_multi_is_each_threshold_alone_and_non_increasing():
    sets = random_sets(7)
    sweep, _ = _both("mean_average_precision_multi", sets, 3)
    assert sweep.shape == (len(tmap.COCO_IOU_THRESHOLDS),)
    for t, got in zip(tmap.COCO_IOU_THRESHOLDS, sweep):
        single, _ = _both("mean_average_precision", sets, 3, t)
        assert np.isclose(got, single, atol=1e-6)
    assert np.all(np.diff(sweep) <= 1e-6)


def grids(seed: int, batch: int = 4, classes: int = 3, objects: int = 3):
    """(y_true, y_pred) grids: a few objects an image, predictions near
    them, plus noise."""
    rng = np.random.RandomState(seed)
    yt = np.zeros((batch, 7, 7, classes + 10), np.float32)
    for b in range(batch):
        for _ in range(objects):
            i, j = rng.randint(7), rng.randint(7)
            yt[b, i, j, :classes] = 0
            yt[b, i, j, rng.randint(classes)] = 1
            yt[b, i, j, classes] = 1
            yt[b, i, j, classes + 1:classes + 5] = rng.uniform(
                [0, 0, 0.05, 0.05], [1, 1, 0.5, 0.5])
    yp = (0.8 * yt + 0.3 * rng.uniform(-0.2, 1, yt.shape)).astype(np.float32)
    return yt, yp


@pytest.mark.parametrize("masked,nms_on_targets,max_candidates",
                         [(False, True, 512), (True, True, 20),
                          (True, False, 512), (False, False, 20)])
def test_accumulator_matches_jax(masked, nms_on_targets, max_candidates):
    kw = dict(conf_threshold=0.3, nms_on_targets=nms_on_targets,
              max_candidates=max_candidates)
    ours = tmap.MeanAveragePrecision(3, 2, **kw)
    theirs = jmap.MeanAveragePrecision(3, 2, **kw)
    for seed in range(3):
        yt, yp = grids(seed)
        weight = np.array([1, 1, seed != 1, seed == 0], bool) if masked else None
        ours.update_state(torch.from_numpy(yt), torch.from_numpy(yp),
                          None if weight is None else torch.from_numpy(weight))
        theirs.update_state(yt, yp, weight)
    assert abs(ours.result() - theirs.result()) <= 1e-6
    assert 0.0 < ours.result() <= 1.0
    np.testing.assert_allclose(ours.result_per_class(),
                               theirs.result_per_class(), atol=1e-6)
    multi, jmulti = ours.result_multi(), theirs.result_multi()
    assert multi.keys() == jmulti.keys()
    for k in multi:
        assert abs(multi[k] - jmulti[k]) <= 1e-6, k
    curves, jcurves = ours.result_pr_curves(), theirs.result_pr_curves()
    assert curves.keys() == jcurves.keys()
    for c in curves:
        assert curves[c]["num_gt"] == jcurves[c]["num_gt"]
        for k in ("recall", "precision"):
            np.testing.assert_allclose(curves[c][k], jcurves[c][k], atol=2e-6)
        assert abs(curves[c]["ap"] - jcurves[c]["ap"]) <= 2e-6


def test_masked_images_equal_dropping_them():
    yt, yp = grids(4)
    yp[3] = np.random.RandomState(0).uniform(1.1, 2.0, yp[3].shape)
    masked = tmap.MeanAveragePrecision(3, 2)
    masked.update_state(yt, yp, torch.tensor([1, 1, 1, 0], dtype=torch.bool))
    real = tmap.MeanAveragePrecision(3, 2)
    real.update_state(yt[:3], yp[:3])
    plain = tmap.MeanAveragePrecision(3, 2)
    plain.update_state(yt, yp)
    assert masked.result() == pytest.approx(real.result(), abs=1e-7)
    assert plain.result() != pytest.approx(real.result(), abs=1e-7)


def test_ground_truth_as_prediction_gives_one():
    """1 up to the reference's 1e-6 in the recall and precision
    denominators, and JAX's value."""
    yt, _ = grids(5)
    metric = tmap.MeanAveragePrecision(3, 2)
    metric.update_state(yt, yt)
    theirs = jmap.MeanAveragePrecision(3, 2)
    theirs.update_state(yt, yt)
    assert 1.0 - 1e-5 <= metric.result() <= 1.0
    assert abs(metric.result() - theirs.result()) <= 1e-7


def test_empty_accumulator_and_unported_layouts():
    metric = tmap.MeanAveragePrecision(3, 2)
    assert metric.result() == 0.0
    assert metric.result_pr_curves() == {}
    assert metric.result_multi()["mAP@[.50:.95]"] == 0.0
    np.testing.assert_array_equal(metric.result_per_class(), np.zeros(3))
    # the error analysis (ROADMAP 1.13, ported): JAX's empty report
    assert metric.result_error_analysis() == \
        jmap.MeanAveragePrecision(3, 2).result_error_analysis()
    # one prior over 3 scales: as in JAX, the constructor takes it and
    # partition_anchors raises at the first update
    grids = [np.zeros((1, s, s, 8), np.float32) for s in (7, 14, 28)]
    for metric, arr in ((jmap.MeanAveragePrecision, jnp.asarray),
                        (tmap.MeanAveragePrecision, torch.from_numpy)):
        odd = metric(3, 2, anchors=((0.1, 0.1),), fpn_scales=3)
        with pytest.raises(ValueError, match="divisible by num_scales=3"):
            odd.update_state([arr(g) for g in grids], [arr(g) for g in grids])
