"""The port's checkpoints (``train/checkpoint.py``): a bit-equal round trip
of the whole train state, the retention and best-step rules against the
JAX package's orbax ``CheckpointManager`` on the same metric sequences,
``average_checkpoints`` as in ``tests/test_ckpt_average.py``, and the
resume axis as in ``tests/test_eval_masking.py``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from keras_object_detection_tpu.train.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.train import (CheckpointManager, Trainer,
                                                average_checkpoints,
                                                create_train_state,
                                                make_train_step)
from test_torch_data import write_dataset


def _cfg(tmp="", optimizer="nadam", ema=None):
    return tconfig.Config(
        grid=tconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=tconfig.ModelConfig(backbone="darknet_micro", head="conv",
                                  image_size=56, compute_dtype="float32"),
        data=tconfig.DataConfig(batch_size=2, max_boxes_per_image=8),
        train=tconfig.TrainConfig(
            epochs=1, optimizer=optimizer, ema_decay=ema,
            schedule=tconfig.ScheduleConfig(kind="constant", base_lr=1e-4),
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            log_dir=os.path.join(tmp, "logs")))


def _trained_state(cfg, seed=0):
    state = create_train_state(cfg, torch.Generator().manual_seed(seed),
                               device="cpu")
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (2, 56, 56, 3)).astype(np.uint8)
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    valid = np.zeros((2, 4), bool)
    valid[:, 0] = True
    return make_train_step(cfg)(state, images, boxes, valid, 3)[0]


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"mu.{i}": v for i, v in enumerate(state.opt.mu)})
    out.update({f"nu.{i}": v for i, v in enumerate(state.opt.nu)})
    out["lr"] = state.opt.lr
    if state.ema is not None:
        out.update({f"ema.{k}": v for k, v in state.ema.items()})
    return out


def test_round_trip_is_bit_equal_and_never_aliases(tmp_path):
    cfg = _cfg(ema=0.9)
    state = _trained_state(cfg)
    saved = {k: v.clone() for k, v in _tensors(state).items()}
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(0, state, {"val_loss": 1.5})
    with torch.no_grad():  # the live state moves on in place
        for v in _tensors(state).values():
            v.add_(1.0)
    template = create_train_state(cfg, torch.Generator().manual_seed(9),
                                  device="cpu")
    restored = mgr.restore(template)
    got = _tensors(restored)
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    assert restored.step == 1 and restored.opt.count == 1
    live = {v.data_ptr() for v in _tensors(state).values()}
    live |= {v.data_ptr() for v in _tensors(template).values()}
    assert not live & {v.data_ptr() for v in got.values()}
    mgr.close()
    reopened = CheckpointManager(str(tmp_path))
    assert reopened.all_steps == [0] and reopened.best_step == 0
    for k, v in _tensors(reopened.restore(template, step=0)).items():
        assert torch.equal(v, saved[k]), k


SEQUENCES = {
    "mixed": [(0, 5.), (1, 4.), (2, 6.), (3, 3.), (4, 7.), (5, 2.), (6, 8.),
              (7, 8.5)],
    "ties": [(0, 5.), (1, 5.), (2, 5.), (3, 5.), (4, 4.)],
    "worsening": [(0, 1.), (1, 2.), (2, 3.), (3, 4.)],
    "improving": [(0, 3.), (1, 2.), (2, 1.), (3, 0.5)],
    "step not above the latest": [(5, 3.), (2, 2.), (6, 4.)],
}


@pytest.mark.parametrize("name", SEQUENCES)
def test_retention_and_best_follow_orbax(tmp_path, name):
    state = _trained_state(_cfg(optimizer="sgd"))
    ours = CheckpointManager(str(tmp_path / "torch"))
    theirs = JaxCheckpointManager(str(tmp_path / "jax"))
    for step, value in SEQUENCES[name]:
        ours.save(step, state, {"val_loss": value})
        theirs.save(step, {"w": np.full(2, step, np.float32)},
                    {"val_loss": value})
        theirs.wait()
        assert (ours.all_steps, ours.best_step, ours.latest_step) == (
            theirs.all_steps, theirs.best_step, theirs.latest_step), step
    ours.close()
    theirs.close()
    assert sorted(int(d) for d in os.listdir(tmp_path / "torch")
                  if d.isdigit()) == ours.all_steps
    again = CheckpointManager(str(tmp_path / "torch"))
    assert (again.all_steps, again.best_step) == (ours.all_steps, ours.best_step)


def _fill(state, value):
    with torch.no_grad():
        for v in state.model.state_dict().values():
            v.fill_(value)
        if state.ema is not None:
            for v in state.ema.values():
                v.fill_(value)
    state.step = int(value * 10)
    return state


@pytest.mark.parametrize("ema", [None, 0.99])
def test_average_checkpoints_uniform_mean(tmp_path, ema):
    cfg = _cfg(optimizer="sgd", ema=ema)
    template = create_train_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5)
    for epoch, v in enumerate([1.0, 2.0, 6.0], start=1):
        mgr.save(epoch, _fill(create_train_state(cfg, device="cpu"), v),
                 {"val_loss": 10.0 - v})
    mgr.wait()
    assert mgr.all_steps == [1, 2, 3]
    avg = average_checkpoints(mgr, template)
    for v in avg.model.state_dict().values():  # parameters and BN statistics
        torch.testing.assert_close(v, torch.full_like(v, 3.0))
    if ema is not None:
        for v in avg.ema.values():
            torch.testing.assert_close(v, torch.full_like(v, 3.0))
    assert avg.step == 60  # the rest from the newest
    last2 = average_checkpoints(mgr, template, last_k=2)
    for v in last2.model.state_dict().values():
        torch.testing.assert_close(v, torch.full_like(v, 4.0))
    mgr.close()


def test_average_checkpoints_empty_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        average_checkpoints(mgr, create_train_state(_cfg(), device="cpu"))
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        mgr.restore(create_train_state(_cfg(), device="cpu"))
    mgr.close()


def test_fit_start_epoch_controls_checkpoint_axis(tmp_path):
    data = write_dataset(tmp_path / "data", 6)
    cfg = _cfg(str(tmp_path), optimizer="adam")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, schedule=dataclasses.replace(cfg.train.schedule,
                                                base_lr=1e-5)))
    ds = YoloDataset(data, 56, 2, max_boxes=8)
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = trainer.fit(ds, ds, epochs=1, verbose=False)
    assert trainer.ckpt.latest_epoch == 0
    state = trainer.fit(ds, ds, epochs=1, state=state, verbose=False,
                        start_epoch=trainer.ckpt.latest_epoch + 1)
    assert trainer.ckpt.latest_epoch == 1
    assert trainer.ckpt.all_steps == [0, 1]
    trainer.close()
