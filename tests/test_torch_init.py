"""Fault 3.1 of the port's ROADMAP, the weight init, and the parameter
counts: every conv and Dense of the v1 models is drawn as flax's default
``lecun_normal`` (JAX's init is the yardstick), and ``count_params`` equals
the JAX package's for every v1 backbone and head."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models import yolo as jyolo
from keras_object_detection_tpu.models.summary import count_params as jcount
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models.convert import _module_path
from keras_object_detection_torch.models.summary import count_params, summarize
from test_torch_variants import _cfg


V1_BACKBONES = ("darknet24", "darknet19", "darknet_tiny", "darknet_micro",
                "vgg16", "mobilenetv2")


@pytest.mark.parametrize("backbone", V1_BACKBONES)
@pytest.mark.parametrize("head", ["conv", "gap_dense", "flatten_dense"])
def test_count_params_matches_jax(backbone, head):
    cfg = jconfig.voc_full_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=backbone, head=head))
    assert count_params(tconfig.Config.from_json(cfg.to_json())) == jcount(cfg)


def test_summary_lists_the_modules():
    text = summarize(tconfig.test_model_config(), depth=1)
    assert "MobileNetV2Backbone" in text and "GAPDenseHead" in text
    n = count_params(tconfig.test_model_config())
    assert text.splitlines()[-1] == f"total parameters: {n:,}"


def _kernels(tree):
    """(path, kernel, bias or None) of every conv and Dense of a flax
    params tree."""
    out = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "kernel" in node:
            out.append(("/".join(path), np.asarray(node["kernel"]),
                        None if "bias" not in node else np.asarray(node["bias"])))
            return
        for k, sub in node.items():
            walk(sub, path + (k,))

    walk(tree, ())
    return out


INIT_MODELS = [("darknet_micro", "conv", 56), ("darknet_tiny", "conv", 64),
               ("darknet24", "conv", 64), ("vgg16", "conv", 64),
               ("mobilenetv2", "conv", 64), ("darknet_micro", "gap_dense", 56),
               ("vgg16", "flatten_dense", 64)]


@pytest.mark.parametrize("backbone,head,size", INIT_MODELS)
def test_weight_init_is_flax_lecun_normal(backbone, head, size):
    """Fault 3.1: every conv and Dense kernel of the port's build_model is
    drawn as flax's default lecun_normal (a normal truncated at 2 sigma,
    std 1/sqrt(fan_in); a depthwise kernel's fan_in is k*k), its bias zero.
    Per kernel, std * sqrt(fan_in) lies within 0.05 of the JAX init's (for
    kernels of fewer than 2,000 values within 4 standard errors of the two
    estimates, sqrt(2 / n) * 4 / sqrt(2)), and no value passes 2 / 0.8796
    standard deviations."""
    cfg = _cfg(backbone, head, size)
    jv = jax.device_get(jyolo.build_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    want = {p: (k, b) for p, k, b in _kernels(jv["params"])}
    model = build_model(tconfig.Config.from_json(cfg.to_json()),
                        torch.Generator().manual_seed(0))
    sd = flax_to_torch(jv["params"], jv.get("batch_stats", {}), model)
    inverse = {}
    for path in want:
        top, *rest = path.split("/")
        inverse[path] = _module_path((top, *rest))[0]
    assert set(inverse.values()) == {
        k[:-len(".weight")] for k in sd if k.endswith(".weight")
        and sd[k].dim() in (2, 4)}
    params = dict(model.named_parameters())
    limit = 2.0 / 0.87962566103423978 + 1e-3
    for path, (jk, jb) in want.items():
        w = params[inverse[path] + ".weight"].detach().numpy()
        fan_in = w[0].size
        assert fan_in == np.prod(jk.shape[:-1])
        got, ref = w.std() * np.sqrt(fan_in), jk.std() * np.sqrt(fan_in)
        tol = max(0.05, 4 * np.sqrt(1.0 / w.size))
        assert abs(got - ref) <= tol, (path, got, ref)
        assert np.abs(w).max() / (1 / np.sqrt(fan_in)) <= limit, path
        assert abs(np.abs(jk).max() * np.sqrt(fan_in)) <= limit, path
        bias = params.get(inverse[path] + ".bias")
        assert (bias is None) == (jb is None), path
        if bias is not None:
            assert not bias.detach().numpy().any() and not jb.any(), path
