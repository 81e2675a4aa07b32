"""The port's model export (``export/litert.py``, ``cli/export.py``)
against the JAX package's ``export/litert.py``: ``export_program`` writes a
``torch.export`` program whose loaded forward gives JAX's
``_make_serving_fn`` outputs on the same weights and images, to 1e-4
(``test_torch_serving.py``'s bound on raw grids: float32 convs sum in
another order), for the conv head, the conv head trained in bf16 (exported
in float32 as JAX exports it) and the FPN head's per-scale tuple; the
returned bytes are the file's. ``export_tflite`` raises, naming the
missing converter; ``default_representative_dataset`` is JAX's stream;
the CLI writes a program from a checkpoint and refuses ``--format
tflite``."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.export import litert as jlitert
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.cli import export as cli_export
from keras_object_detection_torch.export import litert
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import create_train_state
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from test_int8_serving import _micro_cfg, _trained_like_variables
from test_torch_sharded_serving import fpn_cfg


def case(name):
    if name == "fpn":
        return fpn_cfg()
    cfg = _micro_cfg()
    if name == "conv_bf16":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    return cfg


@pytest.mark.parametrize("name", ["conv", "conv_bf16", "fpn"])
def test_exported_program_matches_jax_s_serving_fn(name, tmp_path):
    cfg = case(name)
    params, stats = _trained_like_variables(cfg, seed=4)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    path = str(tmp_path / "model.pt2")
    blob = litert.export_program(tcfg, flax_to_torch(params, stats), path,
                                 batch_size=2, device="cpu")
    with open(path, "rb") as f:
        assert f.read() == blob
    size = cfg.model.image_size
    x = np.random.RandomState(5).rand(2, size, size, 3).astype(np.float32)
    want = jlitert._make_serving_fn(cfg, params, stats)(jnp.asarray(x))
    got = litert.load_program(path)(torch.from_numpy(x))
    if name != "fpn":
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_tflite_gap_and_representative_dataset():
    cfg = tconfig.Config.from_json(_micro_cfg().to_json())
    with pytest.raises(NotImplementedError, match="ai_edge_torch"):
        litert.export_tflite(cfg, {}, "x.tflite")
    got = list(litert.default_representative_dataset(cfg, 3)())
    want = list(jlitert.default_representative_dataset(_micro_cfg(), 3)())
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])


def test_export_cli(tmp_path, capsys):
    cfg = tconfig.Config.from_json(_micro_cfg().to_json())
    ckpt = str(tmp_path / "ckpt")
    state = create_train_state(cfg, torch.Generator().manual_seed(1), "cpu")
    manager = CheckpointManager(ckpt)
    manager.save(0, state, {"val_loss": 1.0})
    manager.close()
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        f.write(cfg.to_json())
    out = str(tmp_path / "model.pt2")
    with pytest.raises(NotImplementedError, match="ai_edge_torch"):
        cli_export.main(["--checkpoint-dir", ckpt, "--output", out,
                         "--device", "cpu"])
    cli_export.main(["--checkpoint-dir", ckpt, "--output", out, "--format",
                     "program", "--device", "cpu", "--bench", "--bench-runs",
                     "2"])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed and "exported program: p50" in printed
    x = torch.rand(1, 56, 56, 3)
    state.model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(litert.load_program(out)(x).numpy(),
                                   state.model(x).numpy(), rtol=1e-5,
                                   atol=1e-5)
