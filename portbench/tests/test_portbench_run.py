"""The run's guards: no result without a GPU, none where JAX or the JAX
package was loaded (top-level names compared whole), none in a checkout
that holds only the benchmark's files; the traffic made from the seed."""

import json
import shutil
import subprocess
import sys

import torch

from portbench import run, traffic


def test_no_gpu_no_result(capsys):
    if torch.cuda.is_available():
        return
    assert run.main(["--workload", "yolov1-train-b64", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_forbidden_modules_are_compared_whole(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "keras_object_detection_tpu_like", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert run.loaded_forbidden() == ["jaxlib"]
    assert run.finish({"_checked": {}, "correct": True}) == 3
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "yolov1-train-b64", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_traffic_is_made_from_the_seed():
    cfg = {"model": {"image_size": 32},
           "data": {"max_boxes_per_image": 64}, "grid": {"num_classes": 20}}
    spec = run._json(run.HERE / "traffic" / "train_dispatch.json")
    spec = dict(spec, dataset=40)
    a = traffic.dataset(cfg, spec, 2 ** 31 + 12345, "cpu")
    b = traffic.dataset(cfg, spec, 2 ** 31 + 12345, "cpu")
    c = traffic.dataset(cfg, spec, 7, "cpu")
    assert torch.equal(a.images, b.images) and torch.equal(a.boxes, b.boxes)
    assert not torch.equal(a.images, c.images)
    counts = a.valid.sum(1)
    assert counts.min() >= 1 and counts.max() <= 16
    o = spec["objects"]
    weights = [o["ratio"] ** k for k in range(o["max"] - o["min"] + 1)]
    mean = sum((o["min"] + k) * w for k, w in enumerate(weights)) / sum(weights)
    assert abs(mean - 2.96) < 0.05  # VOC has about 2.9 objects an image
    order = traffic.epoch_order(40, 8, 3, 0)
    assert order.shape == (5, 8) and len(set(order.flatten().tolist())) == 40
    json.dumps(spec)
