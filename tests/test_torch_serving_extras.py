"""The port's serving extras against the JAX package on the CPU: soft NMS
(gaussian and linear) and fast NMS (``ops/nms.py``) on the same rows,
batched and of one image, the ``nms_mode`` serving of ``InferenceModel``,
the staged latency variant, and the TIDE error analysis
(``ops/error_analysis.py`` and
``MeanAveragePrecision.result_error_analysis``).

Tolerances: keep sets, their order, classes and boxes exact; soft NMS's
decayed confidences to 1e-6 relative (a gaussian decay is one ``exp``, whose
last bit may differ between the two libraries, times the confidence, as
often as a same-class pick overlaps the row); the error analysis's counts
exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (identical_rows, nms_rows, signed_zero_rows,
                        threshold_tie_rows, with_conf)
from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_tpu.ops import error_analysis as jea
from keras_object_detection_tpu.ops import nms as jnms
from keras_object_detection_tpu.ops.map import \
    MeanAveragePrecision as JMeanAveragePrecision
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.eval.evaluator import InferenceModel
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.ops import error_analysis as tea
from keras_object_detection_torch.ops import nms as tnms
from keras_object_detection_torch.ops.map import MeanAveragePrecision

from test_torch_model import jax_model_and_variables
from test_torch_serving import near_boundary

# name -> (rows, iou_threshold, conf_threshold): N = 49 (a v1 grid), 98 (its
# hflip union), 512 (the top-K cut), argmax ties, identical boxes, pairs at
# the IoU threshold and one ulp off, 0.0 against -0.0 (few shapes: JAX
# compiles soft NMS once a shape)
CASES = {
    "3x49": lambda: (nms_rows(1, 3, 49), 0.5, 0.4),
    "3x98": lambda: (nms_rows(2, 3, 98), 0.5, 0.4),
    "2x512": lambda: (nms_rows(3, 2, 512), 0.5, 0.4),
    "one class 3x98": lambda: (nms_rows(4, 3, 98, num_classes=1), 0.5, 0.4),
    "tied 3x49": lambda: (with_conf(nms_rows(5, 3, 49), 0.9), 0.5, 0.4),
    "identical boxes 3x49": lambda: (identical_rows(6, 3, 49), 0.5, 0.4),
    "identical boxes, tied 3x49": lambda: (identical_rows(7, 3, 49, True),
                                           0.5, 0.4),
    "iou tie 0.5": lambda: (threshold_tie_rows(0.5), 0.5, 0.4),
    "iou tie 0.3": lambda: (threshold_tie_rows(0.3), 0.3, 0.4),
    "signed zeros": lambda: (signed_zero_rows(), 0.5, -0.5),
}


def _assert_rows(got, want, conf_rtol):
    got_rows, got_valid = (x.numpy() for x in got)
    want_rows, want_valid = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got_valid, want_valid)
    for col in (0, 2, 3, 4, 5):
        np.testing.assert_array_equal(got_rows[..., col], want_rows[..., col])
    np.testing.assert_allclose(got_rows[..., 1], want_rows[..., 1],
                               rtol=conf_rtol, atol=0)


def _one_image(rows, iou_thr, conf_thr, mode):
    """The last image of ``rows`` through the port's and JAX's one-image
    soft or fast NMS; the port's is also row -1 of its batched twin, bit
    for bit."""
    method = mode.removesuffix(" one image")
    x = torch.from_numpy(rows)
    if method == "fast":
        got = tnms.fast_non_max_suppression(x[-1], iou_thr, conf_thr)
        batched = tnms.batched_fast_non_max_suppression(x, iou_thr, conf_thr)
        want = jnms.fast_non_max_suppression(jnp.asarray(rows[-1]), iou_thr,
                                             conf_thr)
    else:
        got = tnms.soft_non_max_suppression(x[-1], iou_thr, conf_thr, 0.5,
                                            method)
        batched = tnms.batched_soft_non_max_suppression(x, iou_thr, conf_thr,
                                                        0.5, method)
        want = jnms.soft_non_max_suppression(jnp.asarray(rows[-1]), iou_thr,
                                             conf_thr, 0.5, method)
    assert all(torch.equal(a, b[-1]) for a, b in zip(got, batched))
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["gaussian", "linear", "fast",
                                  "gaussian one image", "linear one image",
                                  "fast one image"])
def test_soft_and_fast_nms_match_jax(case, mode):
    rows, iou_thr, conf_thr = CASES[case]()
    if mode.endswith(" one image"):
        got, want = _one_image(rows, iou_thr, conf_thr, mode)
        _assert_rows(got, want, 0.0 if mode.startswith("fast") else 1e-6)
    elif mode == "fast":
        got = tnms.batched_fast_non_max_suppression(
            torch.from_numpy(rows), iou_thr, conf_thr)
        want = jnms.batched_fast_non_max_suppression(
            jnp.asarray(rows), iou_thr, conf_thr)
        _assert_rows(got, want, 0.0)
    else:
        got = tnms.batched_soft_non_max_suppression(
            torch.from_numpy(rows), iou_thr, conf_thr, 0.5, mode)
        want = jnms.batched_soft_non_max_suppression(
            jnp.asarray(rows), iou_thr, conf_thr, 0.5, mode)
        _assert_rows(got, want, 1e-6)
    assert 0 < np.asarray(want[1]).sum() or case == "signed zeros"


def test_soft_nms_takes_the_first_of_tied_maxima_and_other_sigmas():
    """Two rows of one box and one confidence: argmax takes the lower index
    (JAX's jnp.argmax); a sigma whose reciprocal is inexact in float32."""
    rows = np.zeros((1, 4, 6), np.float32)
    rows[0, :, 0] = [1, 1, 2, 1]
    rows[0, :, 1] = [0.8, 0.8, 0.8, 0.7]
    rows[0, :, 2:] = [[0.5, 0.5, 0.3, 0.3], [0.5, 0.5, 0.3, 0.3],
                      [0.52, 0.5, 0.3, 0.3], [0.55, 0.52, 0.3, 0.3]]
    for sigma in (0.5, 0.3):
        got = tnms.batched_soft_non_max_suppression(
            torch.from_numpy(rows), 0.5, 0.1, sigma)
        want = jnms.batched_soft_non_max_suppression(
            jnp.asarray(rows), 0.5, 0.1, sigma)
        _assert_rows(got, want, 1e-6)
    # the first of the tied pair is slot 0, the second decays below it
    assert got[0][0, 0, 2] == 0.5 and got[0][0, 0, 1] == np.float32(0.8)
    with pytest.raises(ValueError, match="soft-NMS method"):
        tnms.batched_soft_non_max_suppression(torch.from_numpy(rows),
                                              method="box")


def _micro(nms_mode="hard", tta="none"):
    cfg = jconfig.tiny_cpu_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone="darknet_micro",
                                       image_size=56),
        eval=dataclasses.replace(cfg.eval, nms_mode=nms_mode, tta=tta))


@pytest.mark.parametrize("nms_mode,tta", [("soft_gaussian", "none"),
                                          ("soft_linear", "hflip"),
                                          ("fast", "none")])
def test_inference_model_nms_modes_match_jax(nms_mode, tta):
    """``predict`` under each non-hard mode against JAX's on the same
    weights (the first seed whose candidates sit 1e-5 clear of every
    decision, as test_torch_serving.py picks them): masks exact, rows to
    1e-4 (the forwards' float32 sums differ in order); the plain-torch modes
    launch no NMS kernel."""
    jcfg = _micro(nms_mode, tta)
    _, v = jax_model_and_variables(jcfg, 2)
    jm = JInferenceModel(jcfg, v["params"], v["batch_stats"])
    tm = InferenceModel(tconfig.Config.from_json(jcfg.to_json()),
                        flax_to_torch(v["params"], v["batch_stats"]),
                        device="cpu")
    for seed in range(20, 30):
        images = np.random.RandomState(seed).randint(0, 256, (3, 56, 56, 3),
                                                     np.uint8)
        if not near_boundary(np.asarray(jm.predict_decoded(images)),
                             jcfg.eval):
            break
    else:
        pytest.fail("no clean seed")
    want_rows, want_valid = jm.predict(images)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = tm.predict(images)
    assert cuda_nms.LAUNCHES == before
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0 < want_valid.sum()
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("nms_mode,tta", [("hard", "none"), ("hard", "hflip"),
                                          ("soft_gaussian", "hflip"),
                                          ("fast", "none")])
def test_staged_latency_has_fused_keys_and_predicts_the_same(nms_mode, tta):
    cfg = tconfig.Config.from_json(_micro(nms_mode, tta).to_json())
    from keras_object_detection_torch.models import build_model

    sd = build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    model = InferenceModel(cfg, sd, device="cpu")
    images = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, 56, 56, 3), np.uint8))
    fused = model.benchmark_latency(images, runs=1, pipeline_k=1)
    staged = model.benchmark_latency(images, runs=1, staged=True,
                                     pipeline_k=1)
    assert set(staged) == set(fused) == {"p50_ms", "min_ms", "mean_ms",
                                         "batch", "pipelined_per_call_ms"}
    assert staged["batch"] == 2 and staged["p50_ms"] > 0
    rows, valid = model.predict(images)
    staged_rows, staged_valid = model._staged(images)
    assert torch.equal(staged_rows, rows) and torch.equal(staged_valid, valid)


def _soup(seed, n_img=12, n_gt=6, n_det=10, n_cls=4):
    """GT and detection sets where every error type occurs: detections that
    perturb a GT's box (some relabelled), duplicates, random boxes."""
    rng = np.random.RandomState(seed)
    tb = np.zeros((n_img, n_gt, 6), np.float32)
    tb[..., 0] = rng.randint(0, n_cls, (n_img, n_gt))
    tb[..., 1] = 1.0
    tb[..., 2:6] = rng.uniform(0.05, 0.6, (n_img, n_gt, 4))
    tv = rng.rand(n_img, n_gt) < 0.8
    pb = np.zeros((n_img, n_det, 6), np.float32)
    pb[..., 0] = rng.randint(0, n_cls, (n_img, n_det))
    pb[..., 1] = rng.choice([0.5, 0.7, 0.9], (n_img, n_det))  # rank ties
    for i in range(n_img):
        for j in range(n_det // 2):
            g = rng.randint(n_gt)
            pb[i, j, 2:6] = tb[i, g, 2:6] + rng.normal(0, 0.03, 4)
            pb[i, j, 0] = tb[i, g, 0] if rng.rand() < 0.8 else rng.randint(n_cls)
    pb[:, n_det // 2:, 2:6] = rng.uniform(0.05, 0.6,
                                          (n_img, n_det - n_det // 2, 4))
    pv = rng.rand(n_img, n_det) < 0.9
    return tb, tv, pb, pv


@pytest.mark.parametrize("iou,bg,chunk", [(0.5, 0.1, 256), (0.3, 0.05, 5),
                                          (0.7, 0.2, 1)])
def test_error_analysis_matches_jax(iou, bg, chunk):
    sets = _soup(11)
    got = tea.error_analysis(*sets, 4, iou, bg, chunk)
    want = jea.error_analysis(*sets, 4, iou, bg, chunk)
    assert got == want
    assert all(got["counts"][k] for k in tea.CATEGORIES if k != "both") \
        or iou != 0.5
    assert tea.format_error_table(got, ["a", "b", "c", "d"]) == \
        jea.format_error_table(want, ["a", "b", "c", "d"])


def test_error_analysis_through_the_accumulator_matches_jax():
    """The same grids through both ``MeanAveragePrecision``s: the reports
    equal, at the accumulator's mAP threshold by default (0.6 here) and at
    an explicit one, and for an empty accumulator; the TP count is the
    matcher's (recall x ground truths at the last PR point, per class)."""
    rng = np.random.RandomState(5)
    y_true = np.zeros((4, 7, 7, 13), np.float32)
    y_true[:, :, :, 3] = rng.rand(4, 7, 7) < 0.3
    y_true[..., 4:8] = rng.uniform(0.1, 0.9, (4, 7, 7, 4))
    y_true[..., :3] = np.eye(3)[rng.randint(0, 3, (4, 7, 7))]
    y_pred = y_true + rng.normal(0, 0.15, y_true.shape).astype(np.float32)
    kw = dict(num_classes=3, map_iou_threshold=0.6)
    tm, jm = MeanAveragePrecision(**kw), JMeanAveragePrecision(**kw)
    assert tm.result_error_analysis() == jm.result_error_analysis()
    for half in (slice(0, 2), slice(2, 4)):
        tm.update_state(torch.from_numpy(y_true[half]),
                        torch.from_numpy(y_pred[half]))
        jm.update_state(jnp.asarray(y_true[half]), jnp.asarray(y_pred[half]))
    got = tm.result_error_analysis()
    assert got == jm.result_error_analysis()
    assert tm.result_error_analysis(0.4, 0.2) == jm.result_error_analysis(0.4,
                                                                          0.2)
    tp = sum(round(c["recall"][-1] * c["num_gt"])
             for c in tm.result_pr_curves().values())
    assert got["counts"]["tp"] == tp > 0
