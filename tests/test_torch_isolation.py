"""The PyTorch port and chip_smoke.py stand alone: they import no JAX, flax,
optax or orbax, and nothing of the JAX package. With those blocked, the port
serves and takes a train step on both paths."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax",
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
sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
images = np.random.RandomState(0).randint(0, 256, (2, 224, 224, 3), np.uint8)
rows, valid = InferenceModel(cfg, sd, device="cpu").predict(images)
assert rows.shape == (2, 49, 6) and valid.shape == (2, 49)
assert torch.isfinite(rows).all()
leaked = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
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
