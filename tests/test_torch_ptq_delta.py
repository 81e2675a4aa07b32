"""The port's int8 PTQ-delta command (``cli/ptq_delta.py``) against the
repository's ``tools/ptq_delta.py`` on the JAX package: the same weights
(``flax_to_torch``), each side's checkpoint of them and the same
validation directory (6 images, ``darknet_micro`` @56). The float and
weight-only int8 arms' mAP agree within 1e-6 and their loss within 1e-5
relative (``test_torch_fit.py``'s bounds), the weight sizes and image
count exactly; with ``--int8-serving --calibrate --qat`` the port reports
every int8-serving key JAX's tool writes, each delta its arm's mAP less
the float mAP. The LiteRT arm is skipped on both sides (the port has no
converter; JAX's is skipped with ``--skip-litert``)."""

import importlib.util
import json
import os
import pathlib
import sys

import jax
import pytest

from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_tpu.train.checkpoint import \
    CheckpointManager as JCheckpointManager
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import ptq_delta
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import create_train_state
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from test_torch_data import write_dataset
from test_torch_fit import _jcfg

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "ptq_delta.py"


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_ptq_delta", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ptq")
    data = write_dataset(tmp / "data", 6, seed=1)
    jcfg = _jcfg(str(tmp / "unused"))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(2))
    jdir, tdir = tmp / "jax" / "ckpt", tmp / "torch" / "ckpt"
    for d in (jdir, tdir):
        os.makedirs(d)
        (d / "config.json").write_text(jcfg.to_json())
    manager = JCheckpointManager(str(jdir))
    manager.save(0, jstate, {"val_loss": 1.0})
    manager.close()
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    state = create_train_state(tcfg, device="cpu")
    state.model.load_state_dict(flax_to_torch(*jax.device_get(
        (jstate.params, jstate.batch_stats)), state.model))
    manager = CheckpointManager(str(tdir))
    manager.save(0, state, {"val_loss": 1.0})
    manager.close()
    return data, str(tmp / "jax"), str(tmp / "torch")


def test_float_and_weight_only_arms_match_jax_s_tool(runs, monkeypatch):
    data, jwork, twork = runs
    tool = _jax_tool()
    from keras_object_detection_tpu.utils import jax_cache

    # the tool's persistent XLA cache: not for a test process
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["ptq_delta.py", "--workdir", jwork,
                                      "--data", data, "--skip-litert"])
    tool.main()
    with open(os.path.join(jwork, "ptq_delta.json")) as f:
        want = json.load(f)
    got = ptq_delta.main(["--workdir", twork, "--data", data, "--device",
                          "cpu"])
    with open(os.path.join(twork, "ptq_delta.json")) as f:
        assert json.load(f) == got
    assert set(got) == set(want)
    for k in ("float_mAP", "jax_int8_mAP", "jax_int8_delta"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["float_loss"] == pytest.approx(want["float_loss"], rel=1e-5)
    for k in ("jax_int8_weight_mb", "float_weight_mb", "val_images"):
        assert got[k] == want[k], k


def test_int8_serving_arms_report_jax_s_keys(runs, capsys):
    data, _, twork = runs
    got = ptq_delta.main(["--workdir", twork, "--data", data, "--device",
                          "cpu", "--int8-serving", "--calibrate", "4",
                          "--qat", "1"])
    source = TOOL.read_text()
    arms = {k[:-len("_mAP")] for k in got if k.endswith("_mAP")
            and k != "float_mAP"}
    assert arms == {"int8_serving", "int8_calibrated",
                    "int8_bias_corrected_dynamic", "int8_bias_corrected",
                    "int8_qat", "jax_int8"}
    for k, v in got.items():
        assert k in source, k
        if k.endswith("_delta"):
            assert v == got[k[:-len("_delta")] + "_mAP"] - got["float_mAP"]
    assert got["int8_calibration_images"] == 4 and got["int8_qat_steps"] == 1
    assert "litert int8: skipped" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        ptq_delta.main(["--workdir", twork, "--data", data, "--qat", "1"])
