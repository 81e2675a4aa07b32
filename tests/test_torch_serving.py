"""The PyTorch port's serving path (``InferenceModel`` on the CPU) against
the JAX package's ``InferenceModel`` on the same carried weights and
images: raw grids and decoded boxes to 1e-4 (float32 convs sum in another
order), NMS survivor masks exact.

An exact mask needs inputs whose decisions do not sit on a threshold, so
the test picks the first seed whose detections keep every confidence, every
same-class IoU and every confidence gap at least 1e-5 away from a decision
boundary, and says which seeds it passed over."""

import dataclasses

import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.eval.evaluator import InferenceModel
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.parallel import Mesh

from test_torch_model import jax_model_and_variables

MARGIN = 1e-5


def _quirk_pairwise_iou(b):
    lo, hi = (b[:, :2] - b[:, 2:]) / 2, (b[:, :2] + b[:, 2:]) / 2
    side = np.clip(np.minimum(hi[:, None], hi[None]) - np.maximum(lo[:, None],
                                                                  lo[None]),
                   0, 1)
    inter = side[..., 0] * side[..., 1]
    area = np.abs((hi - lo)[:, 0] * (hi - lo)[:, 1])
    return inter / (area[:, None] + area[None] - inter + 1e-6)


def near_boundary(decoded, e):
    """Why this input's NMS decisions could flip under 1e-6 noise, or ''."""
    for img in np.asarray(decoded, np.float64):
        conf = img[:, 1]
        if np.any(np.abs(conf - e.conf_threshold) < MARGIN):
            return "a confidence within 1e-5 of conf_threshold"
        live = img[conf > e.conf_threshold - MARGIN]
        gaps = np.abs(live[:, 1][:, None] - live[:, 1][None])
        if np.any(gaps[np.triu_indices(len(live), 1)] < MARGIN):
            return "two candidate confidences within 1e-5 (sort order)"
        iou = _quirk_pairwise_iou(live[:, 2:6])
        same = live[:, 0][:, None] == live[:, 0][None]
        close = same & (np.abs(iou - e.iou_threshold) < MARGIN)
        if np.any(np.triu(close, 1)):
            return "a same-class IoU within 1e-5 of iou_threshold"
    return ""


def _config(tta):
    cfg = jconfig.tiny_cpu_config()
    return dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, tta=tta))


def _images(seed, n=3):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3),
                                               dtype=np.uint8)


def _pair(tta, seed=1):
    jcfg = _config(tta)
    _, v = jax_model_and_variables(jcfg, seed)
    jm = JInferenceModel(jcfg, v["params"], v["batch_stats"])
    tm = InferenceModel(tconfig.Config.from_json(jcfg.to_json()),
                        flax_to_torch(v["params"], v["batch_stats"]),
                        device="cpu")
    return jcfg, jm, tm


@pytest.mark.parametrize("tta", ["none", "hflip"])
def test_serving_matches_jax(tta):
    jcfg, jm, tm = _pair(tta)
    passed_over = []
    for seed in range(10, 20):
        images = _images(seed)
        decoded = np.asarray(jm.predict_decoded(images))
        why = near_boundary(decoded, jcfg.eval)
        if not why:
            break
        passed_over.append(f"seed {seed}: {why}")
    else:
        pytest.fail(f"no clean seed: {passed_over}")
    if passed_over:
        print("passed over:", passed_over)

    np.testing.assert_allclose(tm.predict_raw(images).numpy(),
                               np.asarray(jm.predict_raw(images)),
                               rtol=1e-4, atol=1e-4)
    got_decoded = tm.predict_decoded(images)
    n = 2 * 49 if tta == "hflip" else 49
    assert got_decoded.shape == (3, n, 6)
    np.testing.assert_allclose(got_decoded.numpy(), decoded,
                               rtol=1e-4, atol=1e-4)

    want_rows, want_valid = jm.predict(images)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = tm.predict(images)
    assert cuda_nms.LAUNCHES == before  # CPU tensors take the plain NMS
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0 < want_valid.sum() < want_valid.size
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=1e-4,
                               atol=1e-4)

    single = tm.predict_single(images[0])
    np.testing.assert_allclose(single.numpy(), want_rows[0][want_valid[0]],
                               rtol=1e-4, atol=1e-4)


def test_default_device_is_the_gpu():
    jcfg, _, tm = _pair("none")
    cfg = tconfig.Config.from_json(jcfg.to_json())
    sd = tm.model.state_dict()
    if torch.cuda.is_available():
        assert InferenceModel(cfg, sd).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            InferenceModel(cfg, sd)


# a mesh over the data axis serves (tests/test_torch_sharded_serving.py);
# a model axis, tensor parallelism, stays in ROADMAP 1.15
@pytest.mark.parametrize("eval_override,kwargs,match", [
    ({}, {"mesh": Mesh(1, 2, (torch.device("cpu"),) * 2)}, "ROADMAP 1.15"),
])
def test_unported_serving_options_raise(eval_override, kwargs, match):
    cfg = tconfig.tiny_cpu_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval,
                                                            **eval_override))
    with pytest.raises(NotImplementedError, match=match):
        InferenceModel(cfg, {}, device="cpu", **kwargs)


# the serving options the port refused before its serving extras were
# ported: predict is the mode's NMS of predict_decoded (JAX's
# forward_decode_nms; tests/test_torch_serving_extras.py holds them
# against JAX)
@pytest.mark.parametrize("nms_mode", ["soft_gaussian", "fast"])
def test_once_unported_serving_options_serve(nms_mode):
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.ops import nms as tnms

    cfg = tconfig.tiny_cpu_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, nms_mode=nms_mode))
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    tm = InferenceModel(cfg, sd, device="cpu")
    images = _images(1, n=2)
    e = cfg.eval
    want = (tnms.batched_fast_non_max_suppression(
        tm.predict_decoded(images), e.iou_threshold, e.conf_threshold)
        if nms_mode == "fast" else tnms.batched_soft_non_max_suppression(
            tm.predict_decoded(images), e.iou_threshold, e.conf_threshold,
            e.soft_nms_sigma, "gaussian"))
    got = tm.predict(images)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_benchmark_latency_reports_and_refuses_staged():
    cfg = tconfig.tiny_cpu_config()
    from keras_object_detection_torch.models import build_model
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    tm = InferenceModel(cfg, sd, device="cpu")
    out = tm.benchmark_latency(_images(0, n=1), runs=2, pipeline_k=2)
    assert set(out) == {"p50_ms", "min_ms", "mean_ms", "batch",
                        "pipelined_per_call_ms"}
    assert out["batch"] == 1 and out["min_ms"] > 0
    # staged (ROADMAP 1.13, ported): the same keys
    staged = tm.benchmark_latency(_images(0, n=1), runs=2, staged=True,
                                  pipeline_k=2)
    assert set(staged) == set(out) and staged["batch"] == 1


def test_unknown_tta_raises():
    cfg = _config("vflip")
    with pytest.raises(ValueError, match="tta"):
        InferenceModel(tconfig.Config.from_json(cfg.to_json()), {},
                       device="cpu")

