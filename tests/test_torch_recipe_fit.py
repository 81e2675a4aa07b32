"""The port's multiscale training and ``steps_per_dispatch``
(``train/loop.py``) against the JAX package's, and the whole recipe in a
``Trainer.fit``.

- ``multiscale_grid`` and ``validate_multiscale`` against JAX's for
  darknet24 / darknet19 / darknet_tiny / darknet_micro, VGG16 and
  MobileNetV2 with the conv head, and the GAP dense head, at sizes on and
  off the backbone's pixel stride: the same grid, or a ``ValueError`` in
  both (flatten_dense is refused);
- ``Trainer._epoch_size`` equal to JAX's over seeds, periods and epochs;
- a multiscale + mosaic + mixup ``Trainer.fit`` (darknet_micro, float32,
  SGD at lr 1e-6, batch 4, 2 epochs at sizes 48 and 56 from 56² images)
  against JAX's,
  the port fed JAX's draws of every step: each epoch's size, train
  ``total``, ``val_loss`` and ``val_mAP`` within 1e-4 relative, as
  ``test_torch_fit.test_fit_matches_jax_fit``;
- ``steps_per_dispatch`` K = 1, 2 and -1 (the whole epoch) over the
  device cache bit-equal to a K = 1 run: every logged metric (sizes, train
  terms, the validation loss and mAP), the checkpoints kept and the final
  parameters and running statistics, with one host-to-device copy a chunk
  of K steps.

Data comes from ``tools/make_synthetic_dataset.py``.
"""

import dataclasses
import importlib.util
import os
import pathlib
import types
import unittest.mock

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.parallel.mesh import create_mesh
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.train import (Trainer, multiscale_grid,
                                                validate_multiscale)
from keras_object_detection_torch.train import loop as tloop
from test_torch_fit import _load, _logs, _port
from test_torch_recipe_augment import jax_step_draws


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]


def synthetic(directory, n, seed, size=64):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset", ROOT / "tools" / "make_synthetic_dataset.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.make_split(str(directory), n, np.random.RandomState(seed),
                    num_classes=3, image_size=size)
    return str(directory)


GRID_CASES = [
    ("darknet24", "conv", 448, [320, 384, 448, 512, 576, 64, 330]),
    ("darknet19", "conv", 416, [320, 352, 608, 400]),
    ("darknet_tiny", "conv", 224, [160, 256, 288, 200]),
    ("darknet_micro", "conv", 56, [48, 64, 40, 50]),
    ("vgg16", "conv", 448, [320, 416, 480, 450]),
    ("mobilenetv2", "conv", 448, [320, 480, 333]),
    ("mobilenetv2", "gap_dense", 448, [320, 352]),
]


def _grid_cfgs(backbone, head, size):
    kw = dict(grid=dict(grid=7, num_boxes=2, num_classes=20),
              model=dict(backbone=backbone, head=head, image_size=size))
    jcfg = jconfig.Config(grid=jconfig.GridConfig(**kw["grid"]),
                          model=jconfig.ModelConfig(**kw["model"]))
    return jcfg, tconfig.Config.from_json(jcfg.to_json())


def _grid_or_error(fn, cfg, size):
    try:
        return fn(cfg, size)
    except ValueError:
        return "ValueError"


@pytest.mark.parametrize("backbone,head,canon,sizes", GRID_CASES)
def test_multiscale_grid_matches_jax(backbone, head, canon, sizes):
    jcfg, cfg = _grid_cfgs(backbone, head, canon)
    got = [_grid_or_error(multiscale_grid, cfg, s) for s in sizes]
    want = [_grid_or_error(jloop.multiscale_grid, jcfg, s) for s in sizes]
    assert got == want
    assert "ValueError" in got or head == "gap_dense"


@pytest.mark.parametrize("head,sizes,ok", [
    ("flatten_dense", (384, 448), False), ("conv", (384, 448), True),
    ("conv", (384, 450), False), ("gap_dense", (384, 450), True)])
def test_validate_multiscale_matches_jax(head, sizes, ok):
    jcfg, cfg = _grid_cfgs("darknet24", head, 448)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, multiscale_sizes=sizes))
    cfg = tconfig.Config.from_json(jcfg.to_json())
    for fn, c in ((jloop.validate_multiscale, jcfg),
                  (validate_multiscale, cfg)):
        if ok:
            fn(c)
        else:
            with pytest.raises(ValueError):
                fn(c)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("every", [1, 3])
def test_epoch_size_matches_jax(seed, every):
    sizes = (320, 384, 448, 512, 576)
    jcfg = jconfig.Config(train=jconfig.TrainConfig(
        seed=seed, multiscale_sizes=sizes, multiscale_every=every))
    cfg = tconfig.Config.from_json(jcfg.to_json())
    got = [Trainer._epoch_size(types.SimpleNamespace(config=cfg), e)
           for e in range(24)]
    want = [jloop.Trainer._epoch_size(types.SimpleNamespace(config=jcfg), e)
            for e in range(24)]
    assert got == want
    assert len(set(got)) > 1
    assert Trainer._epoch_size(types.SimpleNamespace(
        config=tconfig.Config()), 0) is None


SIZES = (48, 56)


def _recipe_jcfg(tmp, epochs=2, map_start=1, map_every=2, optimizer="sgd",
                 **train):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="conv",
                                  image_size=56, compute_dtype="float32"),
        data=jconfig.DataConfig(batch_size=4, max_boxes_per_image=8,
                                mosaic_prob=0.75, mixup_prob=0.5),
        train=jconfig.TrainConfig(
            epochs=epochs, optimizer=optimizer, seed=3,  # draws 48, 56
            schedule=jconfig.ScheduleConfig(kind="constant", base_lr=1e-6),
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            log_dir=os.path.join(tmp, "logs"), map_eval_start_epoch=map_start,
            map_eval_every=map_every, multiscale_sizes=SIZES, **train),
        eval=jconfig.EvalConfig(mask_padded_images=True, conf_threshold=0.0,
                                map_iou_threshold=0.1),
        mesh=jconfig.MeshConfig(data_parallel=1))


@pytest.fixture(scope="module")
def recipe_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipe")
    return (synthetic(root / "train", 5, 0, 56),
            synthetic(root / "val", 3, 1, 56))


def test_recipe_fit_matches_jax_fit(tmp_path, recipe_data, monkeypatch):
    train_dir, val_dir = recipe_data
    jcfg = _recipe_jcfg(str(tmp_path / "jax"))
    sizes = [jloop.Trainer._epoch_size(types.SimpleNamespace(config=jcfg), e)
             for e in range(2)]
    assert len(set(sizes)) > 1  # the run trains at two sizes at least
    jtrainer = jloop.Trainer(jcfg, mesh=create_mesh(
        data_parallel=1, devices=jax.devices()[:1]), use_tensorboard=False)
    jstate = jtrainer.init_state()
    init = jax.device_get((jstate.params, jstate.batch_stats))
    ds_kw = dict(max_boxes=8, shuffle=True, seed=0)
    jtrainer.fit(JaxDataset(train_dir, 56, 4, **ds_kw),
                 JaxDataset(val_dir, 56, 4, max_boxes=8), state=jstate,
                 verbose=False)
    jtrainer.ckpt.close()

    def jax_draws(config, model, batch, seed, step):
        return jax_step_draws(jcfg, jax.random.PRNGKey(seed), step, batch)

    monkeypatch.setattr(tloop, "sample_step_draws", jax_draws)
    cfg = _port(jcfg, str(tmp_path / "torch"))
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = _load(trainer.init_state(), *init)
    trainer.fit(YoloDataset(train_dir, 56, 4, **ds_kw),
                YoloDataset(val_dir, 56, 4, max_boxes=8), state=state,
                verbose=False)
    trainer.close()

    got, want = _logs(str(tmp_path / "torch")), _logs(str(tmp_path / "jax"))
    assert [r["train_size"] for r in got] == [r["train_size"] for r in want] \
        == sizes
    for g, w in zip(got, want):
        compared = sorted(k for k in w if k == "total" or k.startswith("val_")
                          and not k.endswith("_s"))
        assert compared == sorted(k for k in g if k == "total" or k.startswith(
            "val_") and not k.endswith("_s"))
        for k in compared:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert (trainer.ckpt.all_steps, trainer.ckpt.best_step) == (
        jtrainer.ckpt.all_steps, jtrainer.ckpt.best_step)


def _near_truth_eval_step(config, make=tloop.make_eval_step):
    """The eval step with the target plus a tenth of the model's output as
    the prediction: an mAP above 0 (the seeded model's own is 0) that still
    moves with the weights."""
    eval_step = make(config)

    def step(*args):
        loss, y_true, y_pred = eval_step(*args)
        return loss, y_true, y_true + 0.1 * y_pred

    return step


def _fit_device_cache(tmp, data, spd):
    train_dir, val_dir = data
    cfg = _port(_recipe_jcfg(tmp, map_start=0, map_every=1,
                             steps_per_dispatch=spd))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, device_cache=True, batch_size=2))
    with unittest.mock.patch.object(tloop, "make_eval_step",
                                    _near_truth_eval_step):
        trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = trainer.fit(YoloDataset(train_dir, 56, 2, max_boxes=8,
                                    shuffle=True, seed=0),
                        YoloDataset(val_dir, 56, 2, max_boxes=8),
                        verbose=False)
    trainer.close()
    return trainer, state, _logs(tmp)


@pytest.fixture(scope="module")
def one_step_a_dispatch(tmp_path_factory, recipe_data):
    return _fit_device_cache(str(tmp_path_factory.mktemp("one")), recipe_data,
                             1)


@pytest.mark.parametrize("spd", [1, 2, -1])
def test_steps_per_dispatch_is_bit_equal_to_one_step_a_dispatch(
        tmp_path, recipe_data, one_step_a_dispatch, spd, monkeypatch):
    one, one_state, one_logs = one_step_a_dispatch
    staged = []
    stage = tloop.stage
    monkeypatch.setattr(tloop, "stage",
                        lambda t, d: staged.append(len(t)) or stage(t, d))
    k, k_state, k_logs = _fit_device_cache(str(tmp_path / "k"), recipe_data,
                                           spd)
    steps = 3  # 5 images, batch 2: 3 steps an epoch (the last padded)
    chunks = {1: steps, 2: 2, -1: 1}[spd]
    assert len(staged) == 2 * chunks  # one copy a chunk, two epochs
    assert [r["step"] for r in k_logs] == [0, 1]
    assert len({r["train_size"] for r in k_logs}) == 2
    assert all("val_mAP" in r for r in k_logs)
    assert all(0 < r["val_mAP"] < 1 for r in one_logs)  # the mAP pass is seen

    def measured(key):  # clock readings, which differ from run to run
        return key == "time" or key.endswith("_s")

    for a, b in zip(one_logs, k_logs):
        keys = sorted(x for x in a if not measured(x))
        assert keys == sorted(x for x in b if not measured(x))
        assert {x: a[x] for x in keys} == {x: b[x] for x in keys}
    assert (one.ckpt.all_steps, one.ckpt.best_step) == (
        k.ckpt.all_steps, k.ckpt.best_step)
    assert one_state.step == k_state.step == 2 * steps
    want = one_state.model.state_dict()
    for name, v in k_state.model.state_dict().items():
        assert torch.equal(v, want[name]), name


def test_recipe_entry_points_need_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = _port(_recipe_jcfg(str(tmp_path), steps_per_dispatch=-1,
                             optimizer="adamw"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=True))
    from keras_object_detection_torch.train import create_train_state
    for make in (lambda: Trainer(cfg, use_tensorboard=False),
                 lambda: create_train_state(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
