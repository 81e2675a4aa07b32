"""The port's FPN-family (YOLOv3) training, evaluation and serving against
the JAX package's, on JAX's FPN tests' model: ``darknet_micro`` @56 + the
FPN head over 2 scales (S = 7, 14), their 6 priors, C = 3, float32, with
``ignore_threshold`` 0.5 and ``obj_target="iou"`` (YOLOv3's settings),
JAX's weights through ``flax_to_torch``:

- a train step (SGD, the JAX step's own draws), with the plain and the
  fused BatchNorm: loss terms 1e-4, running statistics 1e-5, each
  parameter's update 2e-2 of its norm (``_assert_step_matches`` says why);
- an eval step with image weights: loss 1e-5, targets to a rounding, grids
  1e-5 of their scale;
- ``MeanAveragePrecision``'s FPN layout (tuples of per-scale grids): mAP,
  per-class AP and the COCO sweep to 1e-6, with ``max_candidates`` 100
  below the 735 candidates, and a prior count the scales do not divide
  raising at the first update, as in JAX;
- ``InferenceModel``: per-scale raw grids and decoded rows to 1e-5 of their
  scale, NMS keep sets exact behind the top-k cut; hflip TTA's 1,470
  candidates;
- the train CLI's ``--preset yolov3`` and ``--head fpn --anchors`` (9
  priors) equal to the JAX CLI's config.

The training run and multiscale are in ``test_torch_fpn_fit.py``."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.core.fpn import encode_fpn_grids as jencode
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_tpu.ops import map as jmap
from keras_object_detection_tpu.ops import nms as jnms
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import train as cli_train
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.ops import map as tmap
from keras_object_detection_torch.train import make_eval_step, make_train_step
from test_torch_cli import _jax_cli
from test_torch_model import randomized_variables
from test_torch_serving import near_boundary
from test_torch_train import _batch, _jax_draws, _port_state

ANCHORS6 = ((0.8, 0.7), (0.5, 0.6), (0.35, 0.3),
            (0.2, 0.25), (0.12, 0.1), (0.05, 0.06))
# 7 * 7 * 3 + 14 * 14 * 3 candidates an image
CANDIDATES = 735


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def fpn_jcfg(bn_mode="flax", ignore=0.5, obj="iou", lr=1e-4, data=None,
             eval_=None, **train):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3,
                                anchors=ANCHORS6),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="fpn",
                                  fpn_scales=2, image_size=56,
                                  compute_dtype="float32",
                                  activation="leaky_relu", bn_mode=bn_mode),
        data=jconfig.DataConfig(batch_size=4, **(data or {})),
        train=jconfig.TrainConfig(
            optimizer="sgd", ignore_threshold=ignore, obj_target=obj,
            schedule=jconfig.ScheduleConfig(kind="constant", base_lr=lr),
            **train),
        eval=jconfig.EvalConfig(**(eval_ or {})),
        mesh=jconfig.MeshConfig(data_parallel=1))


def jax_variables(jcfg, seed):
    """Seeded variables of ``jcfg``'s JAX model: ``randomized_variables``
    over the init's shapes (``eval_shape`` compiles nothing)."""
    size = jcfg.model.image_size
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))
    return randomized_variables(shapes, seed)


def jax_state(jcfg, seed):
    v = jax_variables(jcfg, seed)
    t = jcfg.train
    return jloop.TrainState.create(
        apply_fn=jbuild(jcfg).apply, params=v["params"],
        batch_stats=v["batch_stats"], ema_params=None,
        tx=jloop._make_optimizer(t.optimizer, t.schedule.base_lr,
                                 t.weight_decay))


def _assert_step_matches(jstate0, jstate, state0, state, jmetrics, metrics):
    """Loss terms to 1e-4 relative (the IoU objectness target follows the
    decoded boxes: 4.8e-5 measured), running statistics to 1e-5, and each
    parameter's SGD update (lr x gradient) to 2e-2 of its norm. The 1024-wide
    prediction blocks' BatchNorm backward at 196 rows a channel cancels
    three to four digits: from JAX's own init, against a float64 step,
    JAX's float32 gradients part by 0.4-0.8 % and the port's by 0.05-0.1 %
    in the trunks, and the two float32 gradients by up to 1.3 %."""
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    before = flax_to_torch(*jax.device_get((jstate0.params,
                                            jstate0.batch_stats)))
    after = flax_to_torch(*jax.device_get((jstate.params, jstate.batch_stats)),
                          state.model)
    for k, t in state.model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), after[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        elif not k.endswith("conv.bias"):  # BatchNorm follows: ~0 gradient
            want = (after[k] - before[k]).double()
            got = (t - state0[k]).double()
            assert torch.linalg.norm(got - want) <= \
                2e-2 * torch.linalg.norm(want), k


def test_train_step_matches_jax():
    """JAX's step with the ignore mask and IoU objectness, against the
    port's with the plain and with the fused BatchNorm (bn_mode "fused":
    the statistics kernels' plain versions on the CPU)."""
    jcfg = fpn_jcfg()
    jstate0 = jax_state(jcfg, 0)
    images, boxes, valid = _batch()
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(jcfg, rng, 0, 1, 4)
    jstate, jmetrics = jax.jit(jloop.make_train_step(jcfg))(
        jstate0, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        rng)
    for bn_mode in ("flax", "fused"):
        tcfg, state = _port_state(fpn_jcfg(bn_mode), jstate0)
        state0 = {k: t.clone() for k, t in state.model.state_dict().items()}
        state, metrics = make_train_step(tcfg)(state, images, boxes, valid,
                                               seed=0, draws=draws)
        _assert_step_matches(jstate0, jstate, state0, state, jmetrics,
                             metrics)


def test_eval_step_matches_jax():
    jcfg = fpn_jcfg()
    jstate = jax_state(jcfg, 1)
    tcfg, state = _port_state(jcfg, jstate)
    images, boxes, valid = _batch(3)
    weight = np.array([1, 1, 1, 0], bool)
    want = jax.jit(jloop.make_eval_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(weight))
    got = make_eval_step(tcfg)(state, images, boxes, valid,
                               torch.from_numpy(weight))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    assert [tuple(t.shape) for t in got[1]] == [(4, 7, 7, 24),
                                                (4, 14, 14, 24)]
    for g, w in zip(got[1], want[1]):
        # the jitted encode may fuse S * cx - col into one FMA
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    for g, w in zip(got[2], want[2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def fpn_grids(seed, batch=4, objects=4):
    """(y_true, y_pred) tuples: encoded random boxes and logits near them
    (an objectness logit of about +2 on assigned slots, noise elsewhere)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, objects, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.05, 0.95, (batch, objects, 2))
    boxes[..., 2:4] = rng.uniform(0.03, 0.7, (batch, objects, 2))
    boxes[..., 4] = rng.randint(0, 3, (batch, objects))
    yts = jax.jit(jax.vmap(lambda b, v: jencode(b, v, 3, ANCHORS6, 7, 2)))(
        jnp.asarray(boxes), jnp.ones((batch, objects), bool))
    yts, yps = [np.asarray(y) for y in yts], []
    for yt in yts:
        t = yt.reshape(*yt.shape[:3], 3, 8)
        p = np.empty_like(t)
        p[..., 0] = np.where(t[..., 0] > 0, 2.0, -1.0) + rng.normal(
            0, 0.8, t[..., 0].shape)
        xy = np.clip(t[..., 1:3], 0.02, 0.98)
        p[..., 1:3] = np.log(xy / (1 - xy)) + rng.normal(0, 0.3, xy.shape)
        p[..., 3:5] = t[..., 3:5] + rng.normal(0, 0.3, xy.shape)
        p[..., 5:] = 3.0 * t[..., 5:] + rng.normal(0, 1.0, t[..., 5:].shape)
        yps.append(p.reshape(yt.shape).astype(np.float32))
    return yts, yps


@pytest.mark.parametrize("nms_on_targets,masked", [(True, False),
                                                   (False, True)])
def test_map_fpn_layout_matches_jax(nms_on_targets, masked):
    kw = dict(conf_threshold=0.3, nms_on_targets=nms_on_targets,
              max_candidates=100, anchors=ANCHORS6, fpn_scales=2)
    ours = tmap.MeanAveragePrecision(3, 2, 7, **kw)
    theirs = jmap.MeanAveragePrecision(3, 2, 7, **kw)
    for seed in range(3):
        yt, yp = fpn_grids(seed)
        weight = np.array([1, 1, seed != 1, 1], bool) if masked else None
        ours.update_state([torch.from_numpy(t) for t in yt],
                          [torch.from_numpy(p) for p in yp],
                          None if weight is None else torch.from_numpy(weight))
        theirs.update_state(yt, yp, weight)
    assert ours._pred[0].shape == (4, 100, 6)  # cut from 735
    assert abs(ours.result() - theirs.result()) <= 1e-6
    assert 0.0 < ours.result() < 1.0
    np.testing.assert_allclose(ours.result_per_class(),
                               theirs.result_per_class(), atol=1e-6)
    multi, jmulti = ours.result_multi(), theirs.result_multi()
    for k in jmulti:
        assert abs(multi[k] - jmulti[k]) <= 1e-6, k
    # a prior count that 2 scales do not divide: JAX's constructor takes it
    # and partition_anchors raises at the first update, here as there
    for metric, arr in ((jmap.MeanAveragePrecision, np.asarray),
                        (tmap.MeanAveragePrecision, torch.from_numpy)):
        odd = metric(3, 2, 7, anchors=ANCHORS6[:5], fpn_scales=2)
        with pytest.raises(ValueError, match="divisible by num_scales=2"):
            odd.update_state([arr(t) for t in yt], [arr(p) for p in yp])


def test_serving_matches_jax():
    """Without the cut (735 candidates, max_candidates 1024) against JAX's
    InferenceModel; with it (max_candidates 100) against JAX's top-k and
    NMS of JAX's decoded rows. conf_threshold 0.6 leaves few enough live
    rows that an input clear of the thresholds' 1e-5 margins exists."""
    jcfg = fpn_jcfg(eval_=dict(conf_threshold=0.6, max_candidates=1024))
    v = jax_variables(jcfg, 3)
    jm = JInferenceModel(jcfg, v["params"], v["batch_stats"])
    for seed in range(10, 40):
        images = np.random.RandomState(seed).randint(0, 256, (2, 56, 56, 3),
                                                     dtype=np.uint8)
        decoded = np.asarray(jm.predict_decoded(images))
        if not near_boundary(decoded, jcfg.eval):
            break
    else:
        pytest.fail("no seed clear of the NMS thresholds")
    raw = [np.asarray(r) for r in jm.predict_raw(images)]
    e = jcfg.eval
    cut = jax.jit(lambda d: jnms.batched_non_max_suppression(
        jnms.top_k_candidates(d, 100), e.iou_threshold, e.conf_threshold))(
            jnp.asarray(decoded))
    for max_candidates, (want_rows, want_valid) in (
            (1024, jm.predict(images)), (100, cut)):
        tcfg = tconfig.Config.from_json(jcfg.to_json())
        tcfg = dataclasses.replace(tcfg, eval=dataclasses.replace(
            tcfg.eval, max_candidates=max_candidates))
        tm = InferenceModel(tcfg, flax_to_torch(v["params"],
                                                v["batch_stats"]),
                            device="cpu")
        for g, w in zip(tm.predict_raw(images), raw):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())
        got = tm.predict_decoded(images)
        assert got.shape == (2, CANDIDATES, 6)
        np.testing.assert_allclose(got.numpy(), decoded, rtol=1e-5,
                                   atol=1e-5 * np.abs(decoded).max())
        before = cuda_nms.LAUNCHES
        rows, valid = tm.predict(images)
        assert cuda_nms.LAUNCHES == before  # CPU tensors take the plain NMS
        assert rows.shape == (2, min(CANDIDATES, max_candidates), 6)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        assert 0 < valid.sum() < valid.numel()
        want_rows = np.asarray(want_rows)
        np.testing.assert_allclose(rows.numpy(), want_rows, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_rows).max())


def test_hflip_tta_doubles_the_fpn_candidates_before_the_cut():
    """tta="hflip": the mirror's 735 decoded rows, cx mirrored back, join
    the image's own; NMS then takes the top max_candidates of the 1,470."""
    cfg = tconfig.Config.from_json(fpn_jcfg(
        eval_=dict(tta="hflip", max_candidates=200)).to_json())
    from keras_object_detection_torch.models import build_model

    sd = build_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    tm = InferenceModel(cfg, sd, device="cpu")
    images = np.random.RandomState(4).randint(0, 256, (2, 56, 56, 3),
                                              dtype=np.uint8)
    both = tm.predict_decoded(images)
    assert both.shape == (2, 2 * CANDIDATES, 6)
    plain = tm._decode(tm.predict_raw(images))
    mirror = tm._decode(tm.predict_raw(images[:, :, ::-1].copy()))
    mirror[..., 2] = 1.0 - mirror[..., 2]
    assert torch.equal(both, torch.cat([plain, mirror], dim=1))
    rows, valid = tm.predict(images)
    assert rows.shape == (2, 200, 6) and valid.shape == (2, 200)


NINE = ("0.0240,0.0313;0.0385,0.0721;0.0793,0.0553;0.0721,0.1466;"
        "0.1490,0.1082;0.1418,0.2861;0.2788,0.2163;0.375,0.476;0.8966,0.7837")


@pytest.mark.parametrize("flags", [
    ["--preset", "yolov3"],
    ["--preset", "yolov3", "--image-size", "320", "--batch-size", "8",
     "--multiscale", "320,416,608"],
    ["--preset", "tiny", "--backbone", "darknet53", "--head", "fpn",
     "--image-size", "416", "--anchors", NINE, "--ignore-threshold", "0.5",
     "--obj-target", "iou"]])
def test_train_cli_fpn_configs_match_jax(flags, tmp_path, monkeypatch):
    argv = ["--data-dir", str(tmp_path), *flags]
    jax_cli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jax_json = jax_cli.build_config(jax_cli.parse_args()).to_json()
    ours = cli_train.build_config(cli_train.parse_args(argv))
    assert tconfig.Config.from_json(jax_json) == tconfig.Config.from_json(
        ours.to_json())
    assert ours.model.head == "fpn" and len(ours.grid.anchors) == 9
    assert json.loads(ours.to_json())["model"]["backbone"] == "darknet53"
