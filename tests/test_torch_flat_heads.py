"""The flat-output and flatten_dense variants of the port's YoloV1 against
the JAX package's, on the same randomised weights (see
``test_torch_variants.py`` for the helpers and tolerances)."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_variants import _cfg, _close, _images, _models


@pytest.mark.parametrize("head", ["conv", "gap_dense", "flatten_dense"])
def test_flat_output_matches_jax(head):
    cfg = _cfg("darknet_micro", head, 56, head_dense_units=32)
    jm, v, tm = _models(cfg, 7, 56, flat_output=True)
    x = _images(56)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dim() == 2 and tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), want, "float32")


def test_flatten_dense_model_matches_jax():
    """The whole transfer model with the flatten_dense head at 64² (2x2
    features), eval mode: VGG16 flattens into Dense(512) -> Dense(1024)."""
    cfg = _cfg("vgg16", "flatten_dense", 64)
    jm, v, tm = _models(cfg, 8, 64)
    x = _images(64)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), want, "float32")


@pytest.mark.parametrize("backbone,units,size", [
    ("vgg16", [512, 1024], 448), ("mobilenetv2", [4096], 448),
    ("mobilenetv2", [4096], 450), ("darknet_tiny", [512, 1024], 224)])
def test_flatten_dense_stack_follows_the_backbone(backbone, units, size):
    """MobileNetV2 takes Dense(4096), the others Dense(512) -> Dense(1024),
    after a flatten of the 4 ConvBlocks' features (stride 2 on the second,
    SAME: ceil), whose width follows the backbone's feature size (built on
    the meta device: shapes only)."""
    import math

    from keras_object_detection_torch import config as tconfig
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.models.yolo import backbone_feature_size

    cfg = tconfig.Config.from_json(_cfg(backbone, "flatten_dense", size).to_json())
    with torch.device("meta"):
        head = build_model(cfg).head
    side = math.ceil(backbone_feature_size(backbone, size) / 2)
    widths = [d.weight.shape for d in head.denses]
    assert [w[0] for w in widths[:-1]] == units
    assert widths[0][1] == 1024 * side * side and widths[-1][0] == 2 * 2 * 13
