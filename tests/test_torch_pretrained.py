"""The port's Keras weight loader (``models/pretrained.py``, h5py only)
against the JAX package's converter (``keras_vgg16_to_flax`` /
``keras_mobilenetv2_to_flax``, through TensorFlow), on files that a Keras
VGG16 / MobileNetV2 built with ``weights=None`` writes into ``tmp_path``,
as ``tests/test_pretrained.py`` does: nothing is downloaded.

Formats: Keras 3 ``.weights.h5``, a legacy weights-only ``.h5`` (the layout
of the Keras applications' ImageNet files), a legacy full-model ``.h5`` and
a ``.keras`` archive. The converted tensors must equal JAX's converted
weights exactly; the port's backbone on them must give Keras's features
(to 1e-5 of their largest value, 13-17 layers of float32 sums).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from keras_object_detection_tpu.models import pretrained as jpretrained
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import backbones, build_model
from keras_object_detection_torch.models import flax_to_torch, pretrained
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)

tf = pytest.importorskip("tensorflow")

SIZE = 64


def _randomize(model, seed):
    """Non-trivial weights and BN statistics in every layer."""
    rng = np.random.RandomState(seed)
    for layer in model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        if layer.__class__.__name__ == "BatchNormalization":
            c = ws[0].shape[0]
            layer.set_weights([rng.uniform(0.8, 1.2, c), rng.normal(0, 0.1, c),
                               rng.normal(0, 0.05, c), rng.uniform(0.8, 1.2, c)])
        else:
            layer.set_weights([rng.normal(0, 0.08, w.shape) for w in ws])


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    """{(backbone, format): (path, keras model)}."""
    from keras.src.legacy.saving import legacy_h5_format

    import h5py

    tmp = tmp_path_factory.mktemp("keras")
    out = {}
    for name, app in (("vgg16", tf.keras.applications.VGG16),
                      ("mobilenetv2", tf.keras.applications.MobileNetV2)):
        km = app(weights=None, include_top=False, input_shape=(SIZE, SIZE, 3))
        _randomize(km, seed=len(out))
        paths = {"weights.h5": str(tmp / f"{name}.weights.h5"),
                 "legacy weights": str(tmp / f"{name}_notop.h5"),
                 "legacy model": str(tmp / f"{name}_model.h5"),
                 "keras": str(tmp / f"{name}.keras")}
        km.save_weights(paths["weights.h5"])
        with h5py.File(paths["legacy weights"], "w") as f:
            legacy_h5_format.save_weights_to_hdf5_group(f, km)
        km.save(paths["legacy model"])
        km.save(paths["keras"])
        for fmt, path in paths.items():
            out[(name, fmt)] = (path, km)
    return out


FORMATS = ["weights.h5", "legacy weights", "legacy model", "keras"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("backbone", ["vgg16", "mobilenetv2"])
def test_keras_file_converts_as_jax_converts_it(keras_files, backbone, fmt):
    path, km = keras_files[(backbone, fmt)]
    convert = {"vgg16": jpretrained.keras_vgg16_to_flax,
               "mobilenetv2": jpretrained.keras_mobilenetv2_to_flax}[backbone]
    jv = convert(km)
    top = jpretrained.BACKBONE_PARAM_KEYS[backbone]
    want = flax_to_torch({top: jv["params"]},
                         {top: jv["batch_stats"]} if "batch_stats" in jv else {})
    got = {"backbone." + k: v for k, v in
           pretrained._CONVERTERS[backbone](path).items()}
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("backbone", ["vgg16", "mobilenetv2"])
def test_loaded_backbone_gives_keras_features(keras_files, backbone):
    path, km = keras_files[(backbone, "weights.h5")]
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    ref = km(x, training=False).numpy()
    bb = backbones.BACKBONES[backbone](torch.float32,
                                       generator=torch.Generator()).eval()
    bb.load_state_dict(pretrained._CONVERTERS[backbone](path))
    with torch.no_grad():
        got = bb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=1e-5,
                               atol=1e-5)


def _cfg(backbone, path, **model):
    cfg = tconfig.tiny_cpu_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, grid=2),
        model=dataclasses.replace(
        cfg.model, backbone=backbone, image_size=SIZE,
        pretrained_backbone=path, **model))


@pytest.mark.parametrize("backbone,head", [("vgg16", "conv"),
                                           ("mobilenetv2", "gap_dense")])
def test_create_train_state_loads_the_backbone(keras_files, backbone, head):
    """``pretrained_backbone`` at init: the backbone's tensors are the
    file's, the head keeps its seeded init, and the frozen recipe trains."""
    path, _ = keras_files[(backbone, "legacy weights")]
    cfg = _cfg(backbone, path, head=head, freeze_backbone=True,
               head_dense_units=32)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    want = pretrained._CONVERTERS[backbone](path)
    sd = state.model.state_dict()
    for k, v in want.items():
        assert torch.equal(sd["backbone." + k], v), k
    fresh = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    for k, v in sd.items():
        if k.startswith("head."):
            assert torch.equal(v, fresh[k]), k
    before = {k: v.clone() for k, v in sd.items()}
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]
    images = np.random.RandomState(0).randint(0, 256, (2, SIZE, SIZE, 3),
                                              np.uint8)
    state, metrics = make_train_step(cfg)(state, images, boxes,
                                          np.ones((2, 4), bool), 0)
    assert torch.isfinite(metrics["total"])
    after = state.model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, before[k]) == k.startswith("backbone."), k


def test_mismatched_files_raise(keras_files, tmp_path):
    vgg_path, _ = keras_files[("vgg16", "weights.h5")]
    mnv2_path, _ = keras_files[("mobilenetv2", "weights.h5")]
    sd = build_model(_cfg("mobilenetv2", ""),
                     torch.Generator().manual_seed(0)).state_dict()
    with pytest.raises(ValueError, match="no layer"):
        pretrained.load_pretrained_backbone(sd, "mobilenetv2", vgg_path)
    narrow = tf.keras.applications.MobileNetV2(
        weights=None, include_top=False, input_shape=(SIZE, SIZE, 3),
        alpha=0.5)
    path = os.path.join(tmp_path, "narrow.weights.h5")
    narrow.save_weights(path)
    with pytest.raises(ValueError, match="shape"):
        pretrained.load_pretrained_backbone(sd, "mobilenetv2", path)
    out = pretrained.load_pretrained_backbone(sd, "mobilenetv2", mnv2_path)
    assert set(out) == set(sd)
    with pytest.raises(ValueError, match="no pretrained converter"):
        pretrained.load_pretrained_backbone(sd, "resnet50", mnv2_path)
    with pytest.raises(ValueError, match="not a darknet weights file"):
        pretrained.load_pretrained_backbone(sd, "darknet19", mnv2_path)
    import h5py
    with h5py.File(tmp_path / "plain.h5", "w") as f:
        f["x"] = np.zeros(3)
    with pytest.raises(ValueError, match="not a Keras weights file"):
        pretrained.read_keras_weights(str(tmp_path / "plain.h5"))
