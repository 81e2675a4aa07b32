"""The port's learning-run command (``cli/run_synth_benchmark.py``) against
the repository's ``tools/run_synth_benchmark.py`` on the JAX package:
- the ``Config`` each builds from the same flags, equal through the port's
  ``Config.from_json`` and as JSON (the conv head's defaults; a k-means
  anchor head with passthrough, ignore threshold and IoU target; a 3-scale
  FPN head with explicit priors, mosaic and multiscale), the JAX tool's
  captured where it would construct its ``Trainer``;
- the k-means priors, bit-equal;
- ``results.json`` from the same training log (a fake trainer on both
  sides), equal but for the two wall-clock keys;
- one real run of the port's command on the CPU (``darknet_micro`` at 56²,
  8 / 4 images, 2 epochs), then ``--resume`` for a third: the JAX tool's
  keys, and the epoch axis continues."""

import argparse
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import run_synth_benchmark as synth
from keras_object_detection_torch.train import loop as tloop
from test_torch_data import write_dataset

TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
        / "run_synth_benchmark.py")
WALL_CLOCK = ("train_wall_s", "images_per_s_train")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_run_synth_benchmark",
                                                  TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    write_dataset(root / "train", 8, seed=5, shape=(56, 56))
    write_dataset(root / "val", 4, seed=6, shape=(56, 56))
    return str(root)


class _Stop(Exception):
    pass


def _run_jax_tool(monkeypatch, argv, trainer):
    """The JAX tool's ``main`` on ``argv`` with ``trainer`` as its Trainer,
    no persistent compile cache."""
    from keras_object_detection_tpu.train import loop as jloop
    from keras_object_detection_tpu.utils import jax_cache

    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(jloop, "Trainer", trainer)
    monkeypatch.setattr(sys, "argv", ["run_synth_benchmark.py", *argv])
    _jax_tool().main()


def _jax_config(monkeypatch, argv):
    seen = {}

    def capture(cfg, **kw):
        seen["cfg"] = cfg
        raise _Stop

    with pytest.raises(_Stop):
        _run_jax_tool(monkeypatch, argv, capture)
    return seen["cfg"]


CASES = {
    "conv_defaults": [],
    "anchor_kmeans": ["--head", "anchor", "--anchors", "kmeans:5",
                      "--passthrough", "--ignore-threshold", "0.6",
                      "--obj-target", "iou", "--backbone", "darknet19",
                      "--image-size", "64", "--grid", "2", "--seed", "3"],
    "fpn_mosaic_multiscale": [
        "--head", "fpn", "--fpn-scales", "3", "--backbone", "darknet53",
        "--anchors", "0.02,0.03;0.04,0.07;0.08,0.06;0.07,0.15;0.15,0.11;"
                     "0.14,0.29;0.28,0.22;0.38,0.48;0.9,0.78",
        "--mosaic", "0.5", "--multiscale", "64,96", "--image-size", "64",
        "--grid", "2", "--schedule", "cosine_restarts", "--ema", "0.999",
        "--device-cache", "--steps-per-dispatch", "4"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_matches_the_jax_tool_s(case, data, tmp_path, monkeypatch):
    argv = ["--data", data, "--workdir", str(tmp_path / "w"), *CASES[case]]
    jcfg = _jax_config(monkeypatch, argv)
    ours = synth.build_config(synth.parse_args(argv))
    assert tconfig.Config.from_json(jcfg.to_json()) == ours
    assert json.loads(jcfg.to_json()) == json.loads(ours.to_json())
    if case == "anchor_kmeans":
        # the fitted priors, bit for bit, and through fit_anchors alone
        assert len(ours.grid.anchors) == 5
        assert ours.grid.anchors == tuple(tuple(a) for a in jcfg.grid.anchors)
        fitted, _ = synth.fit_anchors(os.path.join(data, "train"), 5, 3)
        assert fitted == ours.grid.anchors


def _fake_log(path, epochs=75):
    """A training log as ``Trainer.fit`` writes it: every epoch's times,
    a mAP from epoch 10 on every 5th, saves on some epochs."""
    rng = np.random.RandomState(4)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("not json\n")
        for e in range(epochs):
            # a slow drift, so that the last 60 epochs' median is their own
            rec = {"step": e, "total": float(10 - e / 10),
                   "epoch_time_s": float(0.5 + e / 50 + rng.uniform(0, .1)),
                   "val_loss": float(rng.uniform(1, 5)),
                   "val_s": float(rng.uniform(0.05, 0.2))}
            if e >= 10 and e % 5 == 0:
                rec["val_mAP"] = float(rng.uniform(0, 1))
            if e % 7 == 0:
                rec["save_s"] = float(rng.uniform(0.01, 0.1))
            rec["wall_s"] = rec["epoch_time_s"] + rec["val_s"] + 0.01
            f.write(json.dumps(rec) + "\n")


def _fake_trainer(seen):
    """A stand-in Trainer for either tool: ``fit`` writes ``_fake_log``,
    evaluation reads fixed numbers, the best checkpoint is epoch 40."""

    class Ckpt:
        best_step = latest_step = latest_epoch = 40

        def restore(self, template, step=None):
            assert step == 40
            return "best"

        def close(self):
            pass

    class Trainer:
        device = "fake"

        def __init__(self, cfg, use_tensorboard=True, device=None):
            assert not use_tensorboard
            self.cfg, self.ckpt = cfg, Ckpt()

        def init_state(self):
            return {}

        def fit(self, train_ds, val_ds, verbose, reduce_on_plateau, state,
                start_epoch):
            seen.append(reduce_on_plateau)
            _fake_log(os.path.join(self.cfg.train.log_dir, "train.jsonl"))
            return "final"

        def evaluate(self, state, ds):
            return {"final": {"val_loss": 1.25, "val_mAP": 0.5},
                    "best": {"val_loss": 1.0, "val_mAP": 0.625}}[state]

        def close(self):
            pass

    return Trainer


REPORT_FLAGS = ["--backbone", "darknet_micro", "--image-size", "56",
                "--batch-size", "4", "--epochs", "75", "--map-start", "10",
                "--plateau", "0.5,15,1e-4"]


@pytest.fixture(scope="module")
def jax_report(data, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("jax_report"))
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        _run_jax_tool(mp, ["--data", data, "--workdir", work, *REPORT_FLAGS],
                      _fake_trainer(seen))
    with open(os.path.join(work, "results.json")) as f:
        return json.load(f), seen


def test_results_json_from_the_same_log_equals_the_jax_tool_s(
        jax_report, data, tmp_path, monkeypatch):
    want, jax_seen = jax_report
    seen = []
    monkeypatch.setattr(tloop, "Trainer", _fake_trainer(seen))
    work = str(tmp_path / "w")
    got = synth.main(["--data", data, "--workdir", work, *REPORT_FLAGS])
    with open(os.path.join(work, "results.json")) as f:
        assert json.load(f) == got
    assert seen == jax_seen == [(0.5, 15, 1e-4)]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in WALL_CLOCK} == {
        k: v for k, v in want.items() if k not in WALL_CLOCK}
    # the summary's own numbers, from the log alone
    assert got["val_mAP_peak_epoch"] % 5 == 0
    assert got["best_ckpt_epoch"] == 40 and got["best_ckpt_val_mAP"] == 0.625


def test_run_takes_its_sizes_from_the_config(data, tmp_path, monkeypatch):
    """A data or model field replaced after build_config reaches the
    datasets and the report: run() reads sizes from cfg, not the flags."""
    import dataclasses

    sizes = []

    class Trainer(_fake_trainer([])):
        def fit(self, train_ds, val_ds, **kw):
            sizes.append([(ds.batch_size, ds.image_size, ds.max_boxes)
                          for ds in (train_ds, val_ds)])
            return super().fit(train_ds, val_ds, **kw)

    monkeypatch.setattr(tloop, "Trainer", Trainer)
    args = synth.parse_args(["--data", data, "--workdir", str(tmp_path / "w"),
                             *REPORT_FLAGS])
    cfg = synth.build_config(args)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2,
                                      max_boxes_per_image=5),
        model=dataclasses.replace(cfg.model, image_size=64))
    got = synth.run(cfg, args)
    assert sizes == [[(2, 64, 5), (2, 64, 5)]]
    assert (got["batch_size"], got["image_size"]) == (2, 64)


def test_summarize_log_without_a_log_or_a_map(tmp_path):
    assert synth.summarize_log(str(tmp_path / "none.jsonl"), 8) == {}
    path = str(tmp_path / "logs" / "train.jsonl")
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        for e, t in enumerate((2.0, 1.0, 4.0)):
            f.write(json.dumps({"step": e, "epoch_time_s": t}) + "\n")
    assert synth.summarize_log(path, 8) == {
        "steady_state_epoch_s_p50": 2.0, "steady_state_images_per_s": 4.0,
        "epoch_decomposition_p50_s": {"train": 2.0, "val": 0.0, "save": 0.0}}
    assert synth.parse_plateau("") is None


def test_a_cpu_run_and_its_resume(jax_report, data, tmp_path, capsys):
    want, _ = jax_report
    work = str(tmp_path / "w")
    argv = ["--data", data, "--workdir", work, "--backbone", "darknet_micro",
            "--image-size", "56", "--batch-size", "4", "--map-start", "1",
            "--map-every", "1", "--plateau", "", "--ema", "0.99",
            "--device", "cpu"]
    got = synth.main([*argv, "--epochs", "2"])
    assert set(got) == set(want)
    assert got["epochs"] == 2 and got["train_images"] == 8
    assert got["val_images"] == 4 and got["anchors"] == []
    assert 0.0 <= got["val_mAP"] <= 1.0 and np.isfinite(got["val_loss"])
    assert got["val_mAP_peak_epoch"] == 1  # the only epoch with a mAP
    assert got["best_ckpt_epoch"] in (0, 1)
    with open(os.path.join(work, "ckpt", "config.json")) as f:
        assert tconfig.Config.from_json(f.read()).train.ema_decay == 0.99

    again = synth.main([*argv, "--epochs", "1", "--resume"])
    assert "resumed from epoch 2" in capsys.readouterr().out
    with open(os.path.join(work, "logs", "train.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1, 2]
    assert again["epochs"] == 1
    assert 2 in sorted(int(d) for d in os.listdir(os.path.join(work, "ckpt"))
                       if d.isdigit())


def test_the_cli_takes_the_jax_tool_s_flags(monkeypatch):
    """Every flag of the JAX tool with its default, and ``--device``
    (default cuda) besides."""
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(self, *a, **kw):
        seen["ns"] = parse(self, *a, **kw)
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["run_synth_benchmark.py", "--data", "d",
                                      "--workdir", "w"])
    with pytest.raises(_Stop):
        _jax_tool().main()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    ours = vars(synth.parse_args(["--data", "d", "--workdir", "w"]))
    assert ours.pop("device") == "cuda"
    assert ours == vars(seen["ns"])
