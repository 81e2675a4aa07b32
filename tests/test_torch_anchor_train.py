"""The port's anchor-family training, evaluation and serving against the JAX
package's, ``darknet_micro`` @56 (S = 7, the JAX tests' three anchors,
C = 3, float32) with the passthrough head, ``ignore_threshold`` 0.6 and
``obj_target="iou"`` (darknet v2's settings) unless a case says otherwise:

- a train step (SGD, the JAX step's own draws): loss terms and every
  parameter and running statistic to 1e-5, with the plain and the fused
  BatchNorm;
- an eval step with image weights: loss 1e-5, targets 1e-6, grids 1e-5;
- ``MeanAveragePrecision``'s anchor layout: mAP, per-class AP and the COCO
  sweep to 1e-6, also with ``max_candidates`` 60 below S·S·B = 147, so the
  top-k cut acts on both sides;
- ``InferenceModel``: raw grids and decoded rows to 1e-5 of their scale,
  survivor masks exact, with and without the top-k cut; hflip TTA's 294
  candidates cut to ``max_candidates``;
- a 2-epoch ``Trainer.fit``: each epoch's train loss, val loss and val mAP
  to 1e-4 relative, the final parameters to 1e-4; a run's checkpoint
  served by ``cli.evaluate`` from its ``config.json``;
- ``multiscale_grid`` equal to JAX's (and a step at another size, the
  passthrough fold there too), ``steps_per_dispatch`` 2 bit-equal to 1 with
  mosaic and mixup on, the train CLI's ``--head anchor --anchors
  --ignore-threshold --obj-target`` equal to the JAX CLI's config."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.core.anchors import \
    encode_anchor_grid as jencode
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_tpu.ops import map as jmap
from keras_object_detection_tpu.ops import nms as jnms
from keras_object_detection_tpu.parallel.mesh import create_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import evaluate as cli_evaluate
from keras_object_detection_torch.cli import train as cli_train
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.ops import map as tmap
from keras_object_detection_torch.train import (Trainer, create_train_state,
                                                make_eval_step,
                                                make_train_step)
from keras_object_detection_torch.train import loop as tloop
from test_torch_cli import _jax_cli
from test_torch_data import write_dataset
from test_torch_fit import NO_AUGMENT, _load, _logs
from test_torch_model import randomized_variables
from test_torch_serving import near_boundary
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _batch, _jax_draws, _port_state)

ANCHORS = ((0.1, 0.15), (0.4, 0.3), (0.8, 0.8))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def anchor_jcfg(passthrough=True, bn_mode="flax", ignore=0.6, obj="iou",
                lr=1e-4, data=None, eval_=None, **train):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3,
                                anchors=ANCHORS),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="anchor",
                                  image_size=56, compute_dtype="float32",
                                  passthrough=passthrough, bn_mode=bn_mode),
        data=jconfig.DataConfig(batch_size=4, **(data or {})),
        train=jconfig.TrainConfig(
            optimizer="sgd", ignore_threshold=ignore, obj_target=obj,
            schedule=jconfig.ScheduleConfig(kind="constant", base_lr=lr),
            **train),
        eval=jconfig.EvalConfig(**(eval_ or {})),
        mesh=jconfig.MeshConfig(data_parallel=1))


def jax_state(jcfg, seed):
    """``jloop.create_train_state`` with the model's ``init`` jitted (its
    eager init compiles every operation on its own, for seconds)."""
    model = jbuild(jcfg)
    size = jcfg.model.image_size
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False)
    t = jcfg.train
    return jloop.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables["batch_stats"], ema_params=None,
        tx=jloop._make_optimizer(t.optimizer, t.schedule.base_lr,
                                 t.weight_decay))


@pytest.mark.parametrize("passthrough,bn_mode,ignore,obj", [
    (True, "flax", 0.6, "iou"), (False, "fused", None, "one")])
def test_train_step_matches_jax(passthrough, bn_mode, ignore, obj):
    jcfg = anchor_jcfg(passthrough, bn_mode, ignore, obj)
    jstate = jax_state(jcfg, 0)
    tcfg, state = _port_state(jcfg, jstate)
    images, boxes, valid = _batch()
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(jcfg, rng, 0, 1, 4)
    jstate, jmetrics = jax.jit(jloop.make_train_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        rng)
    state, metrics = make_train_step(tcfg)(state, images, boxes, valid,
                                           seed=0, draws=draws)
    _assert_metrics_match(jmetrics, metrics, kernels=False)
    _assert_state_matches(jstate, state)


def test_eval_step_matches_jax():
    jcfg = anchor_jcfg()
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
    assert got[1].shape == (4, 7, 7, 24)
    # the jitted encode may fuse S * cx - col into one FMA
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


def anchor_grids(seed, batch=4, objects=4):
    """(y_true, y_pred): encoded random boxes and logits near them (an
    objectness logit of about +2 on assigned slots, noise elsewhere)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, objects, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.05, 0.95, (batch, objects, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.7, (batch, objects, 2))
    boxes[..., 4] = rng.randint(0, 3, (batch, objects))
    yt = np.asarray(jax.vmap(lambda b, v: jencode(b, v, 3, ANCHORS, 7))(
        jnp.asarray(boxes), jnp.ones((batch, objects), bool)))
    t = yt.reshape(batch, 7, 7, 3, 8)
    p = np.empty_like(t)
    p[..., 0] = np.where(t[..., 0] > 0, 2.0, -1.0) + rng.normal(0, 0.8,
                                                               t[..., 0].shape)
    xy = np.clip(t[..., 1:3], 0.02, 0.98)
    p[..., 1:3] = np.log(xy / (1 - xy)) + rng.normal(0, 0.3, xy.shape)
    p[..., 3:5] = t[..., 3:5] + rng.normal(0, 0.3, xy.shape)
    p[..., 5:] = 3.0 * t[..., 5:] + rng.normal(0, 1.0, t[..., 5:].shape)
    return yt, p.reshape(yt.shape).astype(np.float32)


@pytest.mark.parametrize("nms_on_targets,max_candidates,masked", [
    (True, 512, False), (True, 60, True), (False, 60, False)])
def test_map_anchor_layout_matches_jax(nms_on_targets, max_candidates,
                                       masked):
    kw = dict(conf_threshold=0.3, nms_on_targets=nms_on_targets,
              max_candidates=max_candidates, anchors=ANCHORS)
    ours = tmap.MeanAveragePrecision(3, 2, 7, **kw)
    theirs = jmap.MeanAveragePrecision(3, 2, 7, **kw)
    for seed in range(3):
        yt, yp = anchor_grids(seed)
        weight = np.array([1, 1, seed != 1, 1], bool) if masked else None
        ours.update_state(torch.from_numpy(yt), torch.from_numpy(yp),
                          None if weight is None else torch.from_numpy(weight))
        theirs.update_state(yt, yp, weight)
    n = min(147, max_candidates)
    assert ours._pred[0].shape == (4, n, 6)  # the cut acted below 147
    assert abs(ours.result() - theirs.result()) <= 1e-6
    assert 0.0 < ours.result() < 1.0
    np.testing.assert_allclose(ours.result_per_class(),
                               theirs.result_per_class(), atol=1e-6)
    multi, jmulti = ours.result_multi(), theirs.result_multi()
    for k in jmulti:
        assert abs(multi[k] - jmulti[k]) <= 1e-6, k
    # ground truth as prediction: 1 (up to the matcher's 1e-6 epsilons)
    gt = tmap.MeanAveragePrecision(3, 2, 7, anchors=ANCHORS,
                                   max_candidates=max_candidates)
    logits = yt.reshape(4, 7, 7, 3, 8).copy()
    logits[..., 0] = np.where(logits[..., 0] > 0, 20.0, -20.0)
    xy = np.clip(logits[..., 1:3], 1e-6, 1 - 1e-6)
    logits[..., 1:3] = np.log(xy / (1 - xy))
    logits[..., 5:] *= 30.0
    gt.update_state(yt, logits.reshape(yt.shape))
    assert gt.result() == pytest.approx(1.0, abs=1e-4)


def test_serving_matches_jax():
    """Without the cut (147 candidates, max_candidates 512) against JAX's
    InferenceModel; with it (max_candidates 100) against JAX's top-k and
    NMS of JAX's decoded rows."""
    jcfg = anchor_jcfg(eval_=dict(conf_threshold=0.3))
    jmodel = jbuild(jcfg)
    v = randomized_variables(jax.device_get(jax.jit(
        jmodel.init, static_argnames="train")(
            jax.random.PRNGKey(3), jnp.zeros((1, 56, 56, 3)), train=False)), 3)
    jm = JInferenceModel(jcfg, v["params"], v["batch_stats"])
    for seed in range(10, 30):
        images = np.random.RandomState(seed).randint(0, 256, (3, 56, 56, 3),
                                                     dtype=np.uint8)
        decoded = np.asarray(jm.predict_decoded(images))
        if not near_boundary(decoded, jcfg.eval):
            break
    else:
        pytest.fail("no seed clear of the NMS thresholds")
    raw = np.asarray(jm.predict_raw(images))
    e = jcfg.eval
    cut = jax.jit(lambda d: jnms.batched_non_max_suppression(
        jnms.top_k_candidates(d, 100), e.iou_threshold, e.conf_threshold))(
            jnp.asarray(decoded))
    for max_candidates, (want_rows, want_valid) in (
            (512, jm.predict(images)), (100, cut)):
        tcfg = tconfig.Config.from_json(jcfg.to_json())
        tcfg = dataclasses.replace(tcfg, eval=dataclasses.replace(
            tcfg.eval, max_candidates=max_candidates))
        tm = InferenceModel(tcfg, flax_to_torch(v["params"],
                                                v["batch_stats"]),
                            device="cpu")
        np.testing.assert_allclose(tm.predict_raw(images).numpy(), raw,
                                   rtol=1e-5, atol=1e-5 * np.abs(raw).max())
        got = tm.predict_decoded(images)
        assert got.shape == (3, 147, 6)
        np.testing.assert_allclose(got.numpy(), decoded, rtol=1e-5,
                                   atol=1e-5 * np.abs(decoded).max())
        before = cuda_nms.LAUNCHES
        rows, valid = tm.predict(images)
        assert cuda_nms.LAUNCHES == before  # CPU tensors take the plain NMS
        assert rows.shape == (3, min(147, max_candidates), 6)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
        assert 0 < valid.sum() < valid.numel()
        np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows),
                                   rtol=1e-5, atol=1e-5)


def test_hflip_tta_doubles_the_anchor_candidates_before_the_cut():
    """tta="hflip": the mirror's 147 decoded rows, cx mirrored back, join
    the image's own; NMS then takes the top max_candidates of the 294."""
    jcfg = anchor_jcfg(eval_=dict(tta="hflip", max_candidates=200))
    cfg = tconfig.Config.from_json(jcfg.to_json())
    from keras_object_detection_torch.models import build_model

    sd = build_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    tm = InferenceModel(cfg, sd, device="cpu")
    images = np.random.RandomState(4).randint(0, 256, (2, 56, 56, 3),
                                              dtype=np.uint8)
    both = tm.predict_decoded(images)
    assert both.shape == (2, 294, 6)
    plain = tm._decode(tm.predict_raw(images))
    mirror = tm._decode(tm.predict_raw(images[:, :, ::-1].copy()))
    mirror[..., 2] = 1.0 - mirror[..., 2]
    assert torch.equal(both, torch.cat([plain, mirror], dim=1))
    rows, valid = tm.predict(images)
    assert rows.shape == (2, 200, 6) and valid.shape == (2, 200)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """4 images: one batch an epoch (each of JAX's step and eval step
    compiles once)."""
    return write_dataset(tmp_path_factory.mktemp("four"), 4, seed=1)


def _fit_jcfg(tmp, **kw):
    return anchor_jcfg(lr=1e-6, data=dict(max_boxes_per_image=8, **NO_AUGMENT),
                       eval_=dict(mask_padded_images=True, conf_threshold=0.0,
                                  map_iou_threshold=0.1),
                       epochs=2, map_eval_start_epoch=0,
                       checkpoint_dir=os.path.join(tmp, "ckpt"),
                       log_dir=os.path.join(tmp, "logs"), **kw)


def test_fit_matches_jax_fit(tmp_path, four):
    jcfg = _fit_jcfg(str(tmp_path / "jax"))
    jtrainer = jloop.Trainer(jcfg, mesh=create_mesh(
        data_parallel=1, devices=jax.devices()[:1]), use_tensorboard=False)
    jstate = jax_state(jcfg, 0)
    init = jax.device_get((jstate.params, jstate.batch_stats))
    ds_kw = dict(max_boxes=8, shuffle=True, seed=0)
    jstate = jtrainer.fit(JaxDataset(four, 56, 4, **ds_kw),
                          JaxDataset(four, 56, 4, max_boxes=8), state=jstate,
                          verbose=False)
    jtrainer.ckpt.close()

    cfg = tconfig.Config.from_json(_fit_jcfg(str(tmp_path / "torch")).to_json())
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = _load(trainer.init_state(), *init)
    state = trainer.fit(YoloDataset(four, 56, 4, **ds_kw),
                        YoloDataset(four, 56, 4, max_boxes=8), state=state,
                        verbose=False)
    trainer.close()

    got, want = _logs(str(tmp_path / "torch")), _logs(str(tmp_path / "jax"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("total", "box_loss", "object_loss", "no_object_loss",
                  "class_loss", "val_loss", "val_mAP"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert got[-1]["val_mAP"] > 0
    assert trainer.ckpt.all_steps == jtrainer.ckpt.all_steps
    want_sd = flax_to_torch(*jax.device_get((jstate.params,
                                             jstate.batch_stats)))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_cli_evaluate_serves_an_anchor_run(tmp_path, four, capsys,
                                           monkeypatch):
    """A one-epoch passthrough run's checkpoint, served by cli.evaluate
    from its config.json (anchors, passthrough, the v2 loss switches)."""
    cfg = tconfig.Config.from_json(_fit_jcfg(str(tmp_path)).to_json())
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    trainer.fit(YoloDataset(four, 56, 4, max_boxes=8),
                YoloDataset(four, 56, 4, max_boxes=8), epochs=1,
                verbose=False)
    trainer.close()
    ckpt = cfg.train.checkpoint_dir
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        f.write(cfg.to_json())
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    capsys.readouterr()
    cli_evaluate.main(["--checkpoint-dir", ckpt, "--data-dir", four,
                       "--device", "cpu", "--coco-map"])
    cli_evaluate.main(["--checkpoint-dir", ckpt, "--device", "cpu", "--image",
                       os.path.join(four, "img000.jpg"), "--latency-runs", "1"])
    out = capsys.readouterr().out
    evaluation = next(x for x in out.splitlines()
                      if x.startswith("evaluation:"))
    assert "'mAP'" in evaluation and "'mAP@[.50:.95]'" in evaluation
    assert '"detections"' in out


def test_multiscale_grid_matches_jax():
    for jcfg, sizes in (
            (anchor_jcfg(), (40, 48, 56, 64, 72)),
            (dataclasses.replace(anchor_jcfg(), grid=dataclasses.replace(
                anchor_jcfg().grid, grid=13), model=dataclasses.replace(
                    anchor_jcfg().model, backbone="darknet19",
                    image_size=416)), (320, 352, 416, 544, 608))):
        cfg = tconfig.Config.from_json(jcfg.to_json())
        assert [tloop.multiscale_grid(cfg, s) for s in sizes] == \
            [jloop.multiscale_grid(jcfg, s) for s in sizes]
    for fn, c in ((jloop.multiscale_grid, anchor_jcfg()),
                  (tloop.multiscale_grid,
                   tconfig.Config.from_json(anchor_jcfg().to_json()))):
        with pytest.raises(ValueError, match="multiple of the backbone"):
            fn(c, 60)


def _device_fit(tmp, data, k):
    cfg = tconfig.Config.from_json(anchor_jcfg(
        lr=1e-3, data=dict(max_boxes_per_image=8, mosaic_prob=1.0,
                           mixup_prob=0.5, device_cache=True),
        eval_=dict(conf_threshold=0.0), epochs=2, multiscale_sizes=(48, 64),
        steps_per_dispatch=k, map_eval_start_epoch=0,
        checkpoint_dir=os.path.join(tmp, "ckpt"),
        log_dir=os.path.join(tmp, "logs")).to_json())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer="adam"))
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = trainer.fit(YoloDataset(data, 64, 4, max_boxes=8, shuffle=True,
                                    seed=0),
                        YoloDataset(data, 56, 4, max_boxes=8), verbose=False)
    trainer.close()
    return state, _logs(tmp)


def test_recipe_arms_and_dispatch_run_with_the_anchor_encode(tmp_path):
    """Mosaic, mixup, multiscale (48², 64²: the passthrough fold at each)
    and steps_per_dispatch 2 over the device cache: bit-equal to K = 1."""
    data = write_dataset(tmp_path / "eight", 8, seed=2)
    one, logs1 = _device_fit(str(tmp_path / "k1"), data, 1)
    two, logs2 = _device_fit(str(tmp_path / "k2"), data, 2)
    for a, b in zip(logs1, logs2):
        for k in ("total", "val_loss", "val_mAP", "train_size"):
            assert a[k] == b[k], k
    assert {r["train_size"] for r in logs1} <= {48, 64}
    assert np.isfinite(logs1[-1]["total"])
    want = one.model.state_dict()
    for k, v in two.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_train_cli_anchor_flags_match_jax(tmp_path, monkeypatch):
    argv = ["--data-dir", str(tmp_path), "--preset", "tiny", "--backbone",
            "darknet19", "--head", "anchor", "--image-size", "416",
            "--anchors", "0.1017,0.1332;0.2456,0.3084;0.3889,0.623",
            "--ignore-threshold", "0.6", "--obj-target", "iou"]
    jax_cli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jax_json = jax_cli.build_config(jax_cli.parse_args()).to_json()
    ours = cli_train.build_config(cli_train.parse_args(argv))
    assert tconfig.Config.from_json(jax_json) == tconfig.Config.from_json(
        ours.to_json())
    assert ours.grid.anchors == ((0.1017, 0.1332), (0.2456, 0.3084),
                                 (0.3889, 0.623))
    assert json.loads(ours.to_json())["train"]["obj_target"] == "iou"


@pytest.mark.parametrize("override,match", [
    (dict(use_pallas_loss=True), "use_pallas_loss implements the v1 loss"),
    (dict(box_loss_mode="ciou"), "box_loss_mode applies to the v1 loss")])
def test_anchor_head_refuses_v1_loss_switches_as_jax(override, match):
    jcfg = anchor_jcfg(**override)
    with pytest.raises(ValueError, match=match):
        jloop.make_train_step(jcfg)
    cfg = tconfig.Config.from_json(jcfg.to_json())
    with pytest.raises(ValueError, match=match):
        make_train_step(cfg)
    with pytest.raises(ValueError, match=match):
        create_train_state(cfg, device="cpu")
