"""The port's evaluation and training run against the JAX package's:
``make_eval_step`` (loss within 1e-5, with and without image weights and
the EMA), ``run_dataset_eval``'s masked loss and mAP, and the whole
``Trainer.fit`` against JAX's ``Trainer.fit``: the same images and initial
weights (``flax_to_torch``), ``darknet_micro`` @56, float32, SGD, batch 4
over 6 images, augmentation switched off (as in
``tests/test_data.py::test_augment_identity_when_disabled``), one device.
Each epoch's train ``total``, ``val_loss`` and ``val_mAP`` agree within
1e-4 relative, mAP is evaluated and checkpoints kept on the same epochs,
the plateau LR scale and the early stop agree, and the final parameters
agree within 1e-4.

The learning rates are small (1e-6 descending, -1e-5 ascending) because at
a random init this network amplifies float32 rounding: on one of these
shuffled batches the two packages' first-step losses part by ~1e-5, and at
lr 1e-5 two SGD steps of descent turn that into 5e-4 of val loss."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.ops.map import \
    MeanAveragePrecision as JaxMeanAveragePrecision
from keras_object_detection_tpu.parallel.mesh import create_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.eval import Evaluator
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.ops.map import MeanAveragePrecision
from keras_object_detection_torch.train import (Trainer, create_train_state,
                                                make_eval_step,
                                                make_train_step,
                                                run_dataset_eval)
from test_torch_data import write_dataset

NO_AUGMENT = dict(hflip_prob=0.0, color_jitter=(0.0,) * 4,
                  crop_scale=(1.0, 1.0), crop_ratio=(1.0, 1.0))


def _jcfg(tmp, lr=1e-6, epochs=2, ema=None, coco_map=False, **kw):
    train = dict(epochs=epochs, optimizer="sgd", ema_decay=ema,
                 schedule=jconfig.ScheduleConfig(kind="constant", base_lr=lr),
                 checkpoint_dir=os.path.join(tmp, "ckpt"),
                 log_dir=os.path.join(tmp, "logs"))
    train.update(kw)
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="conv",
                                  image_size=56, compute_dtype="float32"),
        data=jconfig.DataConfig(batch_size=4, max_boxes_per_image=8,
                                **NO_AUGMENT),
        train=jconfig.TrainConfig(**train),
        eval=jconfig.EvalConfig(mask_padded_images=True, conf_threshold=0.0,
                                map_iou_threshold=0.1, coco_map=coco_map),
        mesh=jconfig.MeshConfig(data_parallel=1))


def _port(jcfg, tmp=None):
    cfg = tconfig.Config.from_json(jcfg.to_json())
    if tmp is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=os.path.join(tmp, "ckpt"),
            log_dir=os.path.join(tmp, "logs")))
    return cfg


def _load(state, params, batch_stats, ema=None):
    state.model.load_state_dict(flax_to_torch(params, batch_stats, state.model))
    if ema is not None:
        state.ema = {k: v for k, v in flax_to_torch(ema, batch_stats).items()
                     if k in state.ema}
    return state


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    """6 images, batch 4: the second batch holds 2 real and 2 padded."""
    return write_dataset(tmp_path_factory.mktemp("six"), 6, seed=1)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ema", [False, True])
def test_eval_step_matches_jax(tmp_path, six, weighted, ema):
    jcfg = _jcfg(str(tmp_path), ema=0.9 if ema else None)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    if ema:  # EMA weights clearly unlike the live ones
        jstate = jstate.replace(ema_params=jax.tree_util.tree_map(
            lambda p: p * 0.5, jstate.params))
    cfg = _port(jcfg)
    state = _load(create_train_state(cfg, device="cpu"),
                  *jax.device_get((jstate.params, jstate.batch_stats,
                                   jstate.ema_params)))
    images, boxes, valid = next(YoloDataset(six, 56, 4, max_boxes=8).epoch())
    weight = np.array([1, 1, 1, 0], bool) if weighted else None
    want = jax.jit(jloop.make_eval_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        None if weight is None else jnp.asarray(weight))
    got = make_eval_step(cfg)(state, images, boxes, valid,
                              None if weight is None else torch.from_numpy(weight))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
    # the jitted encode may fuse S * cx - col into one FMA
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)
    assert not state.model.training  # the next train step sets it back
    if ema:  # the override: the live weights
        live = make_eval_step(cfg, use_ema=False)(state, images, boxes, valid)
        assert abs(float(live[0]) - float(got[0])) > 1e-3
        assert state.ema["head.conv.weight"].data_ptr() != \
            state.model.head.conv.weight.data_ptr()


@pytest.mark.parametrize("masked", [False, True])
def test_run_dataset_eval_matches_jax(tmp_path, six, masked):
    jcfg = _jcfg(str(tmp_path))
    jcfg = dataclasses.replace(jcfg, eval=dataclasses.replace(
        jcfg.eval, mask_padded_images=masked))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(1))
    cfg = _port(jcfg)
    state = _load(create_train_state(cfg, device="cpu"),
                  *jax.device_get((jstate.params, jstate.batch_stats)))
    e = cfg.eval
    kw = dict(conf_threshold=e.conf_threshold,
              map_iou_threshold=e.map_iou_threshold)
    want = jloop.run_dataset_eval(
        jcfg, jax.jit(jloop.make_eval_step(jcfg)),
        JaxMeanAveragePrecision(3, 2, **kw), jstate,
        JaxDataset(six, 56, 4, max_boxes=8))
    got = run_dataset_eval(cfg, make_eval_step(cfg),
                           MeanAveragePrecision(3, 2, **kw), state,
                           YoloDataset(six, 56, 4, max_boxes=8))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert abs(got[1] - want[1]) <= 1e-6


def _logs(tmp):
    with open(os.path.join(tmp, "logs", "train.jsonl")) as f:
        return [json.loads(line) for line in f]


FIT_CASES = {
    # gradient descent: every epoch improves, so mAP (after epoch 1, every
    # 3, with the COCO sweep) runs on improvement; the save cooldown defers
    # epoch 2's save to the final save
    "descent": dict(lr=1e-6, epochs=2, fit=dict(),
                    cfg=dict(coco_map=True, save_cooldown_epochs=2)),
    # gradient ascent (a negative rate): no epoch after the first improves,
    # so the plateau halves the rate, early stop ends the run after 3 of 4
    # epochs, mAP runs only on the third (every 3), and the final save
    # holds the last epoch
    "ascent": dict(lr=-1e-5, epochs=4,
                   fit=dict(reduce_on_plateau=(0.5, 1, -1.0),
                            early_stop_patience=2), cfg={}),
}


@pytest.mark.parametrize("case", FIT_CASES)
def test_fit_matches_jax_fit(tmp_path, six, case):
    spec = FIT_CASES[case]
    jcfg = _jcfg(str(tmp_path / "jax"), lr=spec["lr"], epochs=spec["epochs"],
                 map_eval_start_epoch=1, map_eval_every=3, **spec["cfg"])
    jtrainer = jloop.Trainer(jcfg, mesh=create_mesh(
        data_parallel=1, devices=jax.devices()[:1]), use_tensorboard=False)
    jstate = jtrainer.init_state()
    init = jax.device_get((jstate.params, jstate.batch_stats))
    ds_kw = dict(max_boxes=8, shuffle=True, seed=0)
    jstate = jtrainer.fit(JaxDataset(six, 56, 4, **ds_kw),
                          JaxDataset(six, 56, 4, max_boxes=8), state=jstate,
                          verbose=False, **spec["fit"])
    jtrainer.ckpt.close()

    cfg = _port(jcfg, str(tmp_path / "torch"))
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = _load(trainer.init_state(), *init)
    state = trainer.fit(YoloDataset(six, 56, 4, **ds_kw),
                        YoloDataset(six, 56, 4, max_boxes=8), state=state,
                        verbose=False, **spec["fit"])
    trainer.close()

    got, want = _logs(str(tmp_path / "torch")), _logs(str(tmp_path / "jax"))
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        compared = sorted(k for k in w if k == "total" or k.startswith("val_")
                          and not k.endswith("_s"))
        assert compared == sorted(k for k in g if k == "total" or k.startswith(
            "val_") and not k.endswith("_s"))
        assert ("save_s" in g) == ("save_s" in w)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-7)
        for k in compared:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert (trainer.ckpt.all_steps, trainer.ckpt.best_step) == (
        jtrainer.ckpt.all_steps, jtrainer.ckpt.best_step)
    if case == "descent":
        assert got[-1]["val_mAP"] > 0 and "val_mAP_coco" in got[-1]
        assert "save_s" not in got[-1] and trainer.ckpt.all_steps == [0, 1]
    else:
        assert len(got) == 3 and got[-1]["lr"] == pytest.approx(-5e-6)
        assert trainer.ckpt.all_steps == [0, 2]
    want_sd = flax_to_torch(*jax.device_get((jstate.params,
                                             jstate.batch_stats)))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_device_cache_fit_equals_host_fit(tmp_path, six):
    """``data.device_cache``: the same batches gathered on the device give
    the same run as the host loader."""
    logs = {}
    for cached in (False, True):
        jcfg = _jcfg(str(tmp_path / str(cached)), map_eval_start_epoch=0,
                     map_eval_every=1)
        cfg = _port(jcfg)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, device_cache=cached))
        trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
        trainer.fit(YoloDataset(six, 56, 4, max_boxes=8, shuffle=True),
                    YoloDataset(six, 56, 4, max_boxes=8), verbose=False)
        trainer.close()
        logs[cached] = _logs(str(tmp_path / str(cached)))
    for a, b in zip(logs[False], logs[True]):
        for k in ("total", "val_loss", "val_mAP"):
            assert a[k] == b[k], k


def test_evaluator_reproduces_the_best_checkpoints_logged_epoch(tmp_path, six):
    from keras_object_detection_torch.eval import load_serving_state

    cfg = _port(_jcfg(str(tmp_path), lr=1e-5, ema=0.5,
                      map_eval_start_epoch=0, map_eval_every=1))
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    val = YoloDataset(six, 56, 4, max_boxes=8)
    trainer.fit(YoloDataset(six, 56, 4, max_boxes=8, shuffle=True), val,
                verbose=False)
    trainer.close()
    logged = {r["step"]: r for r in _logs(str(tmp_path))}
    state, state_dict, info = load_serving_state(cfg, cfg.train.checkpoint_dir,
                                                 device="cpu")
    assert f"best={trainer.ckpt.best_step}" in info
    out = Evaluator(cfg, device="cpu").evaluate(state, val, coco_map=True)
    best = logged[trainer.ckpt.best_step]
    assert out["loss"] == pytest.approx(best["val_loss"], rel=1e-6)
    assert out["mAP"] == pytest.approx(best["val_mAP"], abs=1e-6)
    assert out["mAP@0.50"] <= out["mAP"] + 1e-6  # map_iou_threshold is 0.1
    # eval_with_ema: the logged loss is the EMA weights'; use_ema=False
    # evaluates the live weights instead
    live = Evaluator(cfg, use_ema=False, device="cpu").evaluate(state, val)
    assert live["loss"] != out["loss"]
    _, ema_sd, ema_info = load_serving_state(cfg, cfg.train.checkpoint_dir,
                                             use_ema=True, device="cpu")
    assert ema_info.endswith("EMA")
    assert torch.equal(ema_sd["head.conv.weight"], state.ema["head.conv.weight"])
    avg_state, _, avg_info = load_serving_state(
        cfg, cfg.train.checkpoint_dir, avg_ckpts=2, device="cpu")
    assert "average of the newest 2" in avg_info


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = _port(_jcfg(str(tmp_path)))
    for make in (lambda: Trainer(cfg, use_tensorboard=False),
                 lambda: Evaluator(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# the trainer switches the port refused before they were ported: the
# model axis (tensor parallelism, tests/test_torch_tensor_parallel.py) is
# read from the config as JAX's Trainer reads it; in one process JAX's
# create_mesh raises its mesh-size error, as it does on one device
@pytest.mark.parametrize("section,override,match", [
    ("mesh", {"model_parallel": 2}, "mesh 0x2 != 1 devices"),
])
def test_unported_trainer_switches_raise(tmp_path, section, override, match):
    from keras_object_detection_tpu.parallel.mesh import \
        create_mesh as jcreate_mesh

    cfg = _port(_jcfg(str(tmp_path)))
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), data_parallel=-1, **override)})
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, device="cpu", use_tensorboard=False)
    with pytest.raises(ValueError, match=match):
        jcreate_mesh(-1, 2, devices=jax.devices()[:1])


def test_train_step_after_eval_step_trains_in_training_mode(tmp_path, six):
    cfg = _port(_jcfg(str(tmp_path)))
    state = create_train_state(cfg, device="cpu")
    batch = next(YoloDataset(six, 56, 4, max_boxes=8).epoch())
    make_eval_step(cfg)(state, *batch)
    assert not state.model.training
    make_train_step(cfg)(state, *batch, 0)
    assert state.model.training
