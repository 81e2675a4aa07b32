"""The port's FPN-family (YOLOv3) training run against the JAX package's,
on ``test_torch_fpn_train.py``'s model (``darknet_micro`` @56 + the FPN
head over 2 scales, C = 3, float32, ignore 0.5, IoU objectness):

- a 2-epoch ``Trainer.fit``: each epoch's train loss terms, val loss and
  val mAP to 1e-4 relative (the second epoch's 5e-4, its test says why),
  the final parameters to 1e-4; a run's checkpoint served by
  ``cli.evaluate`` from its ``config.json``;
- ``multiscale_grid``'s FPN branch equal to JAX's (and its errors), and a
  multiscale fit from the device cache with ``steps_per_dispatch`` 2
  bit-equal to 1. Its data is written with cv2 (``write_dataset``)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.parallel.mesh import create_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import evaluate as cli_evaluate
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import Trainer
from keras_object_detection_torch.train import loop as tloop
from test_torch_data import write_dataset
from test_torch_fit import NO_AUGMENT, _load, _logs
from test_torch_fpn_train import few_threads, fpn_jcfg, jax_state  # noqa: F401


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """4 images: one batch an epoch (each of JAX's step and eval step
    compiles once)."""
    return write_dataset(tmp_path_factory.mktemp("four"), 4, seed=1)


def _fit_jcfg(tmp, **kw):
    return fpn_jcfg(lr=1e-6, data=dict(max_boxes_per_image=8, **NO_AUGMENT),
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
    # the second epoch starts from an SGD update whose gradients part by up
    # to 1.3 % (_assert_step_matches); its IoU objectness term, whose target
    # follows the decoded boxes, moves 1.4e-4 relative (measured), the rest
    # under 4e-5
    for g, w, rel in zip(got, want, (1e-4, 5e-4)):
        for k in ("total", "box_loss", "object_loss", "no_object_loss",
                  "class_loss", "val_loss", "val_mAP"):
            assert g[k] == pytest.approx(w[k], rel=rel, abs=1e-6), k
    assert got[-1]["val_mAP"] > 0
    assert trainer.ckpt.all_steps == jtrainer.ckpt.all_steps
    want_sd = flax_to_torch(*jax.device_get((jstate.params,
                                             jstate.batch_stats)))
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def test_cli_evaluate_serves_an_fpn_run(tmp_path, four, capsys, monkeypatch):
    """A one-epoch FPN run's checkpoint, served by cli.evaluate from its
    config.json (the head, its scales and priors, the v3 loss switches)."""
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
    """The FPN branch: S = size / the pixel stride (darknet_micro 8,
    Darknet-53 32), and its two errors."""
    micro = fpn_jcfg()
    yolov3 = jconfig.yolov3_config()
    for jcfg, sizes in ((micro, (40, 48, 56, 64, 72)),
                        (yolov3, (320, 352, 416, 544, 608))):
        cfg = tconfig.Config.from_json(jcfg.to_json())
        assert [tloop.multiscale_grid(cfg, s) for s in sizes] == \
            [jloop.multiscale_grid(jcfg, s) for s in sizes]
    assert tloop.multiscale_grid(tconfig.yolov3_config(), 608) == 19
    odd = dataclasses.replace(micro, model=dataclasses.replace(
        micro.model, image_size=60))
    for fn, c in ((jloop.multiscale_grid, micro),
                  (tloop.multiscale_grid,
                   tconfig.Config.from_json(micro.to_json()))):
        with pytest.raises(ValueError, match="multiple of the backbone"):
            fn(c, 60)
    for fn, c in ((jloop.multiscale_grid, odd),
                  (tloop.multiscale_grid,
                   tconfig.Config.from_json(odd.to_json()))):
        with pytest.raises(ValueError, match="not an exact multiple"):
            fn(c, 64)


def _device_fit(tmp, data, k):
    cfg = tconfig.Config.from_json(fpn_jcfg(
        lr=1e-3, data=dict(max_boxes_per_image=8, device_cache=True),
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


def test_multiscale_dispatch_fit_runs_with_the_fpn_encode(tmp_path):
    """Multiscale (48², 64²: S = 6 / 12 and 8 / 16) and steps_per_dispatch
    2 over the device cache: bit-equal to K = 1."""
    data = write_dataset(tmp_path / "eight", 8, seed=2)
    one, logs1 = _device_fit(str(tmp_path / "k1"), data, 1)
    two, logs2 = _device_fit(str(tmp_path / "k2"), data, 2)
    for a, b in zip(logs1, logs2):
        for k in ("total", "val_loss", "val_mAP", "train_size"):
            assert a.get(k) == b.get(k), k
    assert {r["train_size"] for r in logs1} <= {48, 64}
    assert np.isfinite(logs1[-1]["total"])
    want = one.model.state_dict()
    for k, v in two.model.state_dict().items():
        assert torch.equal(v, want[k]), k
