"""The port's command lines (``keras_object_detection_torch.cli``): a one-epoch
training run on the CPU writes ``config.json`` and a checkpoint and
evaluates the test set; ``cli.evaluate`` reads them back and reports loss,
mAP, per-class AP, PR curves and detections; the JAX CLI's ``build_config``
and the port's make the same config from the same flags, and a
``config.json`` the JAX CLI writes loads in the port."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import pytest
import torch

from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import evaluate as cli_evaluate
from keras_object_detection_torch.cli import train as cli_train
from test_torch_data import write_dataset

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A one-epoch tiny-preset run on 5 images: (data dir, checkpoint dir,
    its stdout)."""
    tmp = tmp_path_factory.mktemp("cli")
    data = write_dataset(tmp / "data", 5, seed=3, shape=(240, 200))
    ckpt = str(tmp / "ckpt")
    return data, ckpt, [
        "--data-dir", data, "--test-dir", data, "--preset", "tiny",
        "--epochs", "1", "--device", "cpu", "--checkpoint-dir", ckpt,
        "--log-dir", str(tmp / "logs")]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The loggers write JSONL only: importing torch.utils.tensorboard here
    pulls in TensorFlow, which takes longer than the runs."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_train_writes_config_and_checkpoint(trained, capsys):
    data, ckpt, argv = trained
    cli_train.main(argv)
    out = capsys.readouterr().out
    assert "epoch 1/1:" in out and "test results:" in out
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = tconfig.Config.from_json(f.read())
    assert cfg.model.backbone == "darknet_tiny" and cfg.data.test_dir == data
    assert os.path.exists(os.path.join(ckpt, "0", "state.pt"))
    cli_train.main(argv + ["--resume"])  # continues at epoch 2
    out = capsys.readouterr().out
    assert "resumed from epoch 1" in out and "epoch 2/2:" in out
    assert sorted(d for d in os.listdir(ckpt) if d.isdigit()) == ["0", "1"]


def test_evaluate_reads_the_run(trained, tmp_path, capsys):
    data, ckpt, argv = trained
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(argv)
    capsys.readouterr()
    names = tmp_path / "names.txt"
    names.write_text("cat\ndog\nbird\n")
    cli_evaluate.main([
        "--checkpoint-dir", ckpt, "--data-dir", data, "--device", "cpu",
        "--coco-map", "--per-class-ap", "--names", str(names),
        "--pr-json", str(tmp_path / "pr.json")])
    cli_evaluate.main([
        "--checkpoint-dir", ckpt, "--device", "cpu", "--image",
        os.path.join(data, "img000.jpg"), "--latency-runs", "1",
        "--image-dir", data, "--detections-json", str(tmp_path / "det.json")])
    lines = capsys.readouterr().out.splitlines()
    evaluation = next(x for x in lines if x.startswith("evaluation:"))
    for key in ("'loss'", "'mAP'", "'mAP@[.50:.95]'"):
        assert key in evaluation
    assert any(x.strip().startswith("dog") for x in lines)
    image = json.loads(next(x for x in lines if x.startswith('{"image"')))
    assert image["image"] == "img000.jpg" and "p50_ms" in image["latency_ms"]
    with open(tmp_path / "det.json") as f:
        assert len(json.load(f)) == 5
    with open(tmp_path / "pr.json") as f:
        assert set(json.load(f)) <= {"cat", "dog", "bird"}


@pytest.mark.parametrize("backbone,head,weights,freeze", [
    ("darknet_tiny", "flatten_dense", True, True),
    ("vgg16", "conv", False, True), ("mobilenetv2", "gap_dense", False, False),
    ("darknet19", "conv", False, False)])
def test_train_and_evaluate_the_transfer_family(tmp_path, capsys, backbone,
                                                head, weights, freeze):
    """cli.train (Trainer.fit) and cli.evaluate (Evaluator, InferenceModel)
    on each v1 transfer backbone and head at 224² on the CPU. With
    --pretrained-backbone (a darknet .weights file here) the frozen
    checkpoint's backbone is the file's; frozen without it, the seeded
    init's; not frozen, it trains. cli.evaluate reads the run back (its
    config.json names the weights file, which evaluation does not read)."""
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.models.darknet_import import (
        load_darknet_backbone, save_darknet_backbone)
    from keras_object_detection_torch.train import create_train_state
    from keras_object_detection_torch.train.checkpoint import CheckpointManager

    data = write_dataset(tmp_path / "data", 4, seed=5, shape=(240, 200))
    ckpt = str(tmp_path / "ckpt")
    argv = ["--data-dir", data, "--preset", "tiny", "--epochs", "1",
            "--device", "cpu", "--checkpoint-dir", ckpt, "--log-dir",
            str(tmp_path / "logs"), "--backbone", backbone, "--head", head]
    path = ""
    if weights:
        path = str(tmp_path / "backbone.weights")
        save_darknet_backbone(build_model(
            tconfig.tiny_cpu_config(), torch.Generator().manual_seed(7)
        ).state_dict(), path)
        argv += ["--pretrained-backbone", path]
    cli_train.main(argv + (["--freeze-backbone"] if freeze else []))
    out = capsys.readouterr().out
    assert "epoch 1/1:" in out
    assert ("darknet import: 6/6 convs" in out) == weights
    with open(os.path.join(ckpt, "config.json")) as f:
        run = tconfig.Config.from_json(f.read())
    assert (run.model.backbone, run.model.head, run.model.freeze_backbone,
            run.model.pretrained_backbone) == (backbone, head, freeze, path)
    template = dataclasses.replace(run, model=dataclasses.replace(
        run.model, pretrained_backbone=""))
    state = CheckpointManager(ckpt).restore(create_train_state(template,
                                                               device="cpu"))
    start = build_model(template, torch.Generator().manual_seed(0)).state_dict()
    if weights:
        start, _ = load_darknet_backbone(start, path)
    for k, v in state.model.state_dict().items():
        if k.startswith("backbone.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, start[k]) == freeze, k
    if weights:
        os.remove(path)
    cli_evaluate.main(["--checkpoint-dir", ckpt, "--data-dir", data,
                       "--device", "cpu", "--image",
                       os.path.join(data, "img000.jpg"), "--latency-runs", "1"])
    out = capsys.readouterr().out
    assert "evaluation:" in out and '"detections"' in out


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_train_cli",
                                                  ROOT / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [
    ["--preset", "tiny"],
    ["--preset", "voc", "--batch-size", "16", "--lr", "0.01", "--schedule",
     "cosine_restarts", "--optimizer", "sgd", "--letterbox", "--grad-accum",
     "2", "--cache-dir", "cache", "--device-cache", "--num-classes", "5",
     "--image-size", "224", "--compute-dtype", "float32", "--seed", "4"],
    ["--preset", "voc", "--backbone", "vgg16", "--head", "flatten_dense",
     "--pretrained-backbone", "vgg16.h5", "--freeze-backbone"],
    ["--preset", "tiny", "--backbone", "mobilenetv2", "--head", "gap_dense"],
    ["--preset", "voc", "--mosaic", "0.5", "--mixup", "0.25", "--multiscale",
     "384,448,512", "--multiscale-every", "2", "--optimizer", "adamw",
     "--weight-decay", "5e-4"],
    ["--preset", "tiny", "--optimizer", "sgdw", "--weight-decay", "1e-3"],
    # YOLOv3, which the port refused before its FPN family was ported
    ["--preset", "yolov3"],
    ["--head", "fpn", "--anchors", ";".join(["0.1,0.1", "0.2,0.3"] * 4
                                            + ["0.5,0.6"])],
])
def test_the_jax_clis_config_loads_in_the_port(flags, tmp_path, monkeypatch):
    argv = ["--data-dir", str(tmp_path), *flags]
    jax_cli = _jax_cli()
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    jax_json = jax_cli.build_config(jax_cli.parse_args()).to_json()
    ours = cli_train.build_config(cli_train.parse_args(argv))
    assert tconfig.Config.from_json(jax_json) == ours
    shared = {k: {f: v for f, v in sec.items() if f in json.loads(
        ours.to_json())[k]} for k, sec in json.loads(jax_json).items()}
    assert shared == json.loads(ours.to_json())


# the flags the port refused before its profiling and tagged images were
# ported (the test keeps its name): what the JAX CLIs do with them
@pytest.mark.parametrize("case", ["profile_dir", "tag_dir", "image_names"])
def test_unported_flags_raise(trained, case, tmp_path, capsys):
    data, ckpt, train_argv = trained
    if case == "profile_dir":
        # a trace of the first epoch, then the second epoch untraced
        from keras_object_detection_torch.utils.profiling import traced_events

        prof = str(tmp_path / "prof")
        cli_train.main(["--data-dir", data, "--preset", "tiny", "--backbone",
                        "darknet_micro", "--image-size", "56", "--epochs",
                        "2", "--device", "cpu", "--checkpoint-dir",
                        str(tmp_path / "c"), "--log-dir", str(tmp_path / "l"),
                        "--profile-dir", prof])
        out = capsys.readouterr().out
        assert "epoch 1/1:" in out and "epoch 2/2:" in out
        names = {str(e.get("name", "")) for e in traced_events(prof)}
        assert "aten::conv2d" in names
        return
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    names = tmp_path / "names.txt"
    names.write_text("cat\ndog\nbird\n")
    base = ["--checkpoint-dir", ckpt, "--device", "cpu", "--names",
            str(names), "--grid-overlay"]
    if case == "tag_dir":
        tags = tmp_path / "tags"
        cli_evaluate.main(base + ["--image-dir", data, "--tag-dir", str(tags),
                                  "--detections-json",
                                  str(tmp_path / "det.json")])
        with open(tmp_path / "det.json") as f:
            detections = json.load(f)
        jpgs = sorted(p for p in os.listdir(data) if p.endswith(".jpg"))
        assert sorted(os.listdir(tags)) == jpgs
        written = {name: tags / name for name in jpgs}
    else:
        out = tmp_path / "tagged.jpg"
        cli_evaluate.main(base + ["--image", os.path.join(data, "img000.jpg"),
                                  "--latency-runs", "1", "--output",
                                  str(out)])
        printed = capsys.readouterr().out
        assert f"wrote {out}" in printed
        detections = {"img000.jpg": json.loads(next(
            x for x in printed.splitlines() if x.startswith("{")))[
                "detections"]}
        written = {"img000.jpg": out}
    # the one-epoch model keeps nothing at conf 0.4: each file is the
    # model's input with the lattice, as JAX's get_grid_tagged_img draws it
    import cv2
    import numpy as np

    from keras_object_detection_tpu.utils.viz import get_grid_tagged_img
    from keras_object_detection_torch.data.reader import load_example

    for name, path in written.items():
        assert detections[name] == []
        img = load_example(os.path.join(data, name), 224, 20)[0]
        want = str(tmp_path / f"want_{name}")
        cv2.imwrite(want, cv2.cvtColor(get_grid_tagged_img(
            img, np.zeros((0, 6)), str(names)), cv2.COLOR_RGB2BGR))
        assert np.array_equal(cv2.imread(str(path)), cv2.imread(want))


def _evaluation(out):
    line = next(x for x in out.splitlines() if x.startswith("evaluation:"))
    return {k: v for k, v in eval(line[len("evaluation:"):]).items()
            if not k.endswith(("_s", "_per_s"))}


# the multi-device flags, which the port refused before its data
# parallelism was ported: what the JAX CLIs do with them
@pytest.mark.parametrize("case", ["train_dp4", "train_sharded", "evaluate_dp2"])
def test_multi_device_flags_run_as_in_jax(trained, case, tmp_path, capsys):
    data, ckpt, train_argv = trained
    if case == "train_dp4":
        # the tiny preset's batch of 2 over 4 ranks: JAX's Trainer error,
        # raised before any rank starts
        with pytest.raises(ValueError, match="data-parallel mesh size 4"):
            cli_train.main(["--data-dir", data, "--preset", "tiny",
                            "--data-parallel", "4", "--device", "cpu"])
        return
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    capsys.readouterr()
    if case == "train_sharded":
        # a one-device mesh holds the whole set in its one shard
        out = str(tmp_path / "c")
        cli_train.main(["--data-dir", data, "--preset", "tiny", "--epochs",
                        "1", "--device", "cpu", "--checkpoint-dir", out,
                        "--log-dir", str(tmp_path / "l"), "--device-cache",
                        "--device-cache-layout", "sharded"])
        assert "epoch 1/1:" in capsys.readouterr().out
        with open(os.path.join(out, "config.json")) as f:
            assert json.load(f)["data"]["device_cache_layout"] == "sharded"
        return
    # evaluation over a mesh of 2 CPU replicas: the single device's loss
    # and mAP
    base = ["--checkpoint-dir", ckpt, "--data-dir", data, "--device", "cpu",
            "--coco-map"]
    cli_evaluate.main(base)
    single = _evaluation(capsys.readouterr().out)
    cli_evaluate.main(base + ["--data-parallel", "2"])
    meshed = _evaluation(capsys.readouterr().out)
    assert meshed == pytest.approx(single, rel=1e-5, abs=1e-6)
    assert meshed["mAP"] == single["mAP"]


def test_the_default_device_is_the_gpu(trained):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    data, ckpt, _ = trained
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(["--data-dir", data, "--preset", "tiny",
                        "--checkpoint-dir", ckpt + "_gpu"])
    assert not os.path.exists(ckpt + "_gpu")


def test_evaluate_data_parallel_default_device_is_the_gpu(trained):
    # a mesh of every device takes the GPUs, never the CPU unasked
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    data, ckpt, train_argv = trained
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_evaluate.main(["--checkpoint-dir", ckpt, "--data-dir", data,
                           "--data-parallel", "-1"])


# the serving flags, which the port refused before its serving extras and
# int8 serving were ported: what JAX's evaluate.py prints for them
@pytest.mark.parametrize("argv,data,expect", [
    (["--error-analysis"], True,
     ["detection error analysis (", "    missed_gt"]),
    (["--nms-mode", "fast", "--image-dir", "DATA", "--detections-json",
      "TMP/det.json"], False,
     ["wrote ", " detections over 5 images"]),
    (["--nms-mode", "soft_linear", "--soft-nms-sigma", "0.3", "--image",
      "DATA/img000.jpg", "--latency-runs", "1"], False,
     ["forward+decode+NMS: p50", "staged model->decode->NMS: p50"]),
    (["--serving", "int8"], False, ["serving path: {'mode': 'int8'}"]),
    (["--serving", "auto", "--calib-images", "3", "--image",
      "DATA/img001.jpg", "--latency-runs", "1"], True,
     ["int8 calibration set: 3 images", "serving path: {'mode': 'auto'",
      "staged model->decode->NMS: p50"]),
])
def test_serving_flags_run_as_in_jax(trained, argv, data, expect, capsys,
                                     tmp_path):
    data_dir, ckpt, train_argv = trained
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    capsys.readouterr()
    argv = [a.replace("DATA", data_dir).replace("TMP", str(tmp_path))
            for a in argv]
    cli_evaluate.main(["--checkpoint-dir", ckpt, "--device", "cpu", *argv,
                       *(["--data-dir", data_dir] if data else [])])
    out = capsys.readouterr().out
    for line in expect:
        assert line in out, (line, out)


@pytest.mark.parametrize("argv,message", [
    (["--calib-images", "2"], "add --serving int8"),
    (["--serving", "int8", "--calib-images", "2"], "needs --data-dir"),
    (["--serving", "int8", "--qat-steps", "2"], "needs --calib-images"),
])
def test_serving_flag_errors_are_jax_s(trained, argv, message):
    _, ckpt, train_argv = trained
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    with pytest.raises(SystemExit, match=message):
        cli_evaluate.main(["--checkpoint-dir", ckpt, "--device", "cpu", *argv])


def _jax_serving_map_keys(b):
    """The JSON keys of tools/serving_map.py, read from its source: the
    ``out = {...}`` literal and every ``out[...] =``, f-strings at batch
    ``b``."""
    import ast

    tree = ast.parse((ROOT / "tools" / "serving_map.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", "") == "out":
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Subscript) \
                and getattr(node.targets[0].value, "id", "") == "out":
            key = node.targets[0].slice
            keys.add(key.value if isinstance(key, ast.Constant) else "".join(
                v.value if isinstance(v, ast.Constant) else str(b)
                for v in key.values))
    return keys


def test_serving_map_keys_and_map_match(trained, capsys):
    """cli.serving_map prints tools/serving_map.py's keys (int8 and
    --latency ones included), and its mAP is mean_average_precision over
    the port's own predict on the same images (at conf 0 and IoU 0.01,
    where the one-epoch model's boxes score)."""
    import numpy as np

    from keras_object_detection_torch.cli import serving_map
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import (InferenceModel,
                                                   load_serving_state)
    from keras_object_detection_torch.ops.map import mean_average_precision

    data, ckpt, train_argv = trained
    if not os.path.exists(os.path.join(ckpt, "config.json")):
        cli_train.main(train_argv)
    capsys.readouterr()
    serving_map.main(["--checkpoint-dir", ckpt, "--data", data, "--device",
                      "cpu", "--batch-size", "2", "--serving", "int8",
                      "--calib-images", "3", "--latency", "1"])
    int8 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(int8) == _jax_serving_map_keys(1)
    assert int8["serving"] == "int8" and int8["calib_images"] == 3
    assert 0.0 <= int8["serving_mAP"] <= 1.0 and int8["images"] == 5

    serving_map.main(["--checkpoint-dir", ckpt, "--data", data, "--device",
                      "cpu", "--batch-size", "2", "--conf-threshold", "0.0",
                      "--map-iou", "0.01"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = tconfig.Config.from_json(f.read())
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, conf_threshold=0.0))
    _, sd, _ = load_serving_state(cfg, ckpt, device="cpu")
    model = InferenceModel(cfg, sd, device="cpu")
    ds = YoloDataset(data, cfg.model.image_size, 5, max_boxes=32)
    images, boxes, valid = next(ds.epoch())
    rows, keep = model.predict(images)
    gt = np.concatenate([boxes[..., 4:5], np.ones_like(boxes[..., :1]),
                         boxes[..., :4]], axis=-1)
    want = float(mean_average_precision(
        torch.from_numpy(gt), torch.from_numpy(valid), rows, keep,
        cfg.grid.num_classes, 0.01))
    # a loose IoU threshold, so that the seeded model's boxes score at all
    assert got["serving_mAP"] == round(want, 4) and want > 0, want
    assert (got["serving"], got["nms_mode"], got["conf_threshold"]) == (
        "float", "hard", 0.0)
