"""The PyTorch port and chip_smoke.py stand alone: they import no JAX, flax,
optax, orbax or TensorFlow, and nothing of the JAX package. With those
blocked, the port serves, takes a train step on both paths and of each v1
transfer backbone and head (frozen, and in the mxu and flax@N BN modes),
runs a one-epoch ``Trainer.fit`` over a small decoded-cache dataset with
``Evaluator.evaluate`` on it and a two-epoch one with the v1 recipe
(mosaic, mixup, multiscale, adamw, remat, ``steps_per_dispatch`` over the
device cache), takes a step with each IoU box loss and sgdw, takes a
YOLOv2 anchor + passthrough step and a YOLOv3 FPN step and serves each,
serves soft and fast NMS and the staged latency, runs the error analysis,
serves int8 (dynamic, calibrated, bias-corrected, QAT, weight-only, on the
FPN plan too) and picks a serving model, exports and reloads a
``torch.export`` program, writes and parses a profiler trace, draws a
tagged image, imports the tensor-parallel placement and the dry run,
summarises a learning run's log, and the twelve command lines (the
three measurement tools among them) answer ``--help``;
h5py is never imported (only reading a Keras file needs it)."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "keras",
           "keras_object_detection_tpu")
PORT_FILES = sorted((ROOT / "keras_object_detection_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_SCRIPT = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np, torch
from keras_object_detection_torch.config import tiny_cpu_config
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import build_model
import keras_object_detection_torch.ops._build
import dataclasses
from keras_object_detection_torch.train import create_train_state, make_train_step
cfg = tiny_cpu_config()
for kernels in (False, True):
    tc = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone="darknet_micro",
                                       image_size=56,
                                       bn_mode="fused" if kernels else "flax"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=kernels))
    state = create_train_state(tc, device="cpu")
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    state, metrics = make_train_step(tc)(
        state, np.zeros((2, 56, 56, 3), np.uint8), boxes,
        np.ones((2, 4), bool), 0)
    assert torch.isfinite(metrics["total"])
# the v1 transfer family: a train step of each backbone and head, BN modes
import keras_object_detection_torch.models.pretrained
assert "h5py" not in sys.modules  # imported only when a .h5 is read
for backbone, head, extra in (
        ("vgg16", "conv", dict(freeze_backbone=True)),
        ("mobilenetv2", "gap_dense", dict(head_dense_units=32,
                                          bn_mode="fused")),
        ("vgg16", "flatten_dense", dict(bn_mode="mxu")),
        ("darknet_micro", "conv", dict(bn_mode="flax@1"))):
    tc = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, grid=1),
        model=dataclasses.replace(cfg.model, backbone=backbone,
                                  head=head, image_size=32, **extra),
        train=dataclasses.replace(cfg.train, use_pallas_loss=True))
    state = create_train_state(tc, device="cpu")
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    state, metrics = make_train_step(tc)(
        state, np.zeros((2, 32, 32, 3), np.uint8), boxes,
        np.ones((2, 4), bool), 0)
    assert torch.isfinite(metrics["total"]), (backbone, head)
sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
images = np.random.RandomState(0).randint(0, 256, (2, 224, 224, 3), np.uint8)
rows, valid = InferenceModel(cfg, sd, device="cpu").predict(images)
assert rows.shape == (2, 49, 6) and valid.shape == (2, 49)
assert torch.isfinite(rows).all()

import os, subprocess, tempfile
from keras_object_detection_torch.data import YoloDataset, disk_cache
from keras_object_detection_torch.eval import Evaluator
from keras_object_detection_torch.train import Trainer
tmp = tempfile.mkdtemp()
paths = [os.path.join(tmp, f"{{i}}.jpg") for i in range(4)]
for p in paths:
    open(p, "wb").close()
rng = np.random.RandomState(0)
boxes = np.zeros((4, 4, 5), np.float32)
boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
disk_cache.write(os.path.join(tmp, "cache"), paths, 56, 4,
                 zip(rng.randint(0, 256, (4, 56, 56, 3)).astype(np.uint8),
                     boxes, np.ones((4, 4), bool)))
tc = dataclasses.replace(
    cfg, model=dataclasses.replace(cfg.model, backbone="darknet_micro",
                                   image_size=56),
    train=dataclasses.replace(cfg.train, checkpoint_dir=os.path.join(tmp, "c"),
                              log_dir=os.path.join(tmp, "l"),
                              map_eval_start_epoch=0))
ds = YoloDataset(tmp, 56, 2, max_boxes=4, cache_dir=os.path.join(tmp, "cache"))
trainer = Trainer(tc, device="cpu", use_tensorboard=False)
state = trainer.fit(ds, ds, epochs=1, verbose=False)
trainer.close()
assert trainer.ckpt.all_steps == [0]
out = Evaluator(tc, device="cpu").evaluate(state, ds)
assert np.isfinite(out["loss"]) and 0.0 <= out["mAP"] <= 1.0
# the v1 recipe: mosaic, mixup, multiscale, adamw, remat, steps_per_dispatch
rc = dataclasses.replace(
    tc, model=dataclasses.replace(tc.model, remat=True, remat_policy="dots",
                                  bn_mode="fused"),
    data=dataclasses.replace(tc.data, mosaic_prob=1.0, mixup_prob=0.5,
                             device_cache=True),
    train=dataclasses.replace(tc.train, optimizer="adamw",
                              multiscale_sizes=(48, 56), steps_per_dispatch=2,
                              checkpoint_dir=os.path.join(tmp, "rc"),
                              log_dir=os.path.join(tmp, "rl")))
trainer = Trainer(rc, device="cpu", use_tensorboard=False)
state = trainer.fit(ds, ds, epochs=2, verbose=False)
trainer.close()
assert state.step == 4 and trainer.ckpt.latest_step == 1
for mode in ("diou", "ciou", "alpha_iou"):
    bc = dataclasses.replace(rc, train=dataclasses.replace(
        rc.train, box_loss_mode=mode, optimizer="sgdw"))
    state = create_train_state(bc, device="cpu")
    state, metrics = make_train_step(bc)(
        state, np.zeros((2, 56, 56, 3), np.uint8), boxes[:2],
        np.ones((2, 4), bool), 0)
    assert torch.isfinite(metrics["total"]), mode
# the YOLOv2 anchor family: a passthrough step with the v2 loss's ignore
# mask and IoU target (fused BatchNorm), and serving
ac = dataclasses.replace(
    tc, grid=dataclasses.replace(tc.grid, anchors=((0.1, 0.15), (0.4, 0.3),
                                                   (0.8, 0.8))),
    model=dataclasses.replace(tc.model, head="anchor", passthrough=True,
                              bn_mode="fused"),
    train=dataclasses.replace(tc.train, ignore_threshold=0.6,
                              obj_target="iou"))
state = create_train_state(ac, device="cpu")
state, metrics = make_train_step(ac)(
    state, np.zeros((2, 56, 56, 3), np.uint8), boxes[:2],
    np.ones((2, 4), bool), 0)
assert torch.isfinite(metrics["total"])
rows, valid = InferenceModel(ac, state.model.state_dict(), device="cpu"
                             ).predict(images[:, :56, :56])
assert rows.shape == (2, 147, 6) and torch.isfinite(rows).all()
# the YOLOv3 FPN family: a 2-scale step (fused BatchNorm, the v3 loss's
# ignore mask and IoU target), and serving its 735 candidates cut to 512
fc = dataclasses.replace(
    ac, grid=dataclasses.replace(ac.grid, anchors=ac.grid.anchors + (
        (0.05, 0.06), (0.2, 0.25), (0.12, 0.1))),
    model=dataclasses.replace(ac.model, head="fpn", passthrough=False,
                              fpn_scales=2, activation="leaky_relu"),
    train=dataclasses.replace(ac.train, ignore_threshold=0.5))
state = create_train_state(fc, device="cpu")
state, metrics = make_train_step(fc)(
    state, np.zeros((2, 56, 56, 3), np.uint8), boxes[:2],
    np.ones((2, 4), bool), 0)
assert torch.isfinite(metrics["total"])
rows, valid = InferenceModel(fc, state.model.state_dict(), device="cpu"
                             ).predict(images[:, :56, :56])
assert rows.shape == (2, 512, 6) and torch.isfinite(rows).all()
# serving extras: soft / fast NMS, staged latency, the error analysis
for mode in ("soft_gaussian", "soft_linear", "fast"):
    mc = dataclasses.replace(tc, eval=dataclasses.replace(tc.eval,
                                                          nms_mode=mode))
    model = InferenceModel(mc, create_train_state(mc, device="cpu")
                           .model.state_dict(), device="cpu")
    rows, valid = model.predict(images[:, :56, :56])
    assert rows.shape == (2, 49, 6)
    assert model.benchmark_latency(images[:1, :56, :56], runs=1,
                                   staged=True)["batch"] == 1
from keras_object_detection_torch.ops.map import MeanAveragePrecision
metric = MeanAveragePrecision(3)
grid = torch.zeros(2, 7, 7, 13)
metric.update_state(grid, grid)
assert metric.result_error_analysis()["num_detections"] == 0
# int8 serving
from keras_object_detection_torch.export import (
    Int8InferenceModel, QuantizedInferenceModel, select_serving_model)
sd = create_train_state(tc, device="cpu").model.state_dict()
calib = images[:3, :56, :56]
for kw in (dict(), dict(calib_images=calib),
           dict(calib_images=calib, bias_correct=True),
           dict(calib_images=calib, qat_steps=1, qat_batch=2)):
    rows, valid = Int8InferenceModel(tc, sd, device="cpu", **kw).predict(
        images[:, :56, :56])
    assert rows.shape == (2, 49, 6) and torch.isfinite(rows).all(), kw
rows, valid = QuantizedInferenceModel(tc, sd, device="cpu").predict(
    images[:, :56, :56])
assert rows.shape == (2, 49, 6)
model, info = select_serving_model(tc, sd, "auto", probe_runs=1, device="cpu")
assert info["chosen"] in ("float", "int8")
rows, valid = Int8InferenceModel(fc, create_train_state(fc, device="cpu")
                                 .model.state_dict(), device="cpu").predict(
    images[:, :56, :56])
assert rows.shape == (2, 512, 6)
# export, profiling, viz, tensor parallelism
import os, tempfile
from keras_object_detection_torch.export import export_program, load_program
from keras_object_detection_torch.utils import profiling, viz
import keras_object_detection_torch.parallel.tensor
import keras_object_detection_torch.parallel.dryrun
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "model.pt2")
    export_program(tc, sd, path, device="cpu")
    assert load_program(path)(torch.zeros(1, 56, 56, 3)).shape == (1, 7, 7, 13)
    with profiling.trace(tmp):
        torch.ones(4).sum()
    assert profiling.traced_events(tmp)
    names = os.path.join(tmp, "names.txt")
    with open(names, "w") as f:
        f.write("a\\nb\\nc\\n")
    tagged = viz.get_grid_tagged_img(np.zeros((56, 56, 3), np.uint8),
                                     np.array([[1, 0.9, .5, .5, .2, .2]]),
                                     names)
    assert tagged.any()
# the command lines answer --help (each imported here, with JAX blocked)
import contextlib, importlib, io, json
for cli in ("train", "evaluate", "kmeans_anchors", "serving_map", "export",
            "ptq_delta", "run_synth_benchmark", "darknet_weights",
            "visualize_dataset", "train_step_breakdown",
            "serving_device_time", "tp_comm_analysis"):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            importlib.import_module(
                f"keras_object_detection_torch.cli.{{cli}}").main(["--help"])
        except SystemExit as e:
            assert e.code == 0, (cli, e.code)
    assert "usage:" in out.getvalue(), cli
# the learning run's summary of a training log
from keras_object_detection_torch.cli.run_synth_benchmark import summarize_log
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "train.jsonl")
    with open(path, "w") as f:
        for e in range(3):
            f.write(json.dumps({{"step": e, "epoch_time_s": 1.0 + e,
                                "val_mAP": 0.1 * e}}) + "\\n")
    assert summarize_log(path, 8) == {{"val_mAP_peak": 0.2,
                                      "val_mAP_peak_epoch": 2}}
leaked = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} + ("h5py",)
          and sys.modules[m] is not None]
assert not leaked, leaked
print("ok")
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(BLOCKED) + r")\b", re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_port_sources(path):
    found = _IMPORT.findall(path.read_text())
    assert not found, f"{path} imports {found}"
