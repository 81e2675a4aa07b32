"""Pretrained backbone weights from Keras files (counterpart of
``keras_object_detection_tpu/models/pretrained.py``).

The reference's working recipe trains VGG16 from ImageNet weights with the
backbone frozen or not. Those weights arrive as a local Keras file, which
this module reads with h5py, never with TensorFlow:

- a Keras 3 ``.weights.h5`` (``model.save_weights``): ``layers/*/vars/<i>``,
  the layer's name in the ``vars`` group's ``name`` attribute;
- a legacy HDF5 weights file, as the Keras applications' ImageNet files
  are (``layer_names`` / ``weight_names`` attributes), or a legacy full
  model ``.h5`` (the same under ``model_weights``);
- a ``.keras`` archive (its ``model.weights.h5``).

Each layer's weights are in Keras's order (kernel, bias; gamma, beta,
moving mean, moving variance). Conv kernels go from ``(kh, kw, in, out)``
to OIHW; MobileNetV2's depthwise ``(k, k, C, 1)`` to ``(C, 1, k, k)``. The
reference feeds 0-1 RGB to the backbone without ``preprocess_input``, so the
conversion is a pure weight copy. Darknet backbones load an original
darknet ``.weights`` file instead (``models/darknet_import.py``).

h5py is imported only when a file is read: nothing else of the port needs
it.
"""

from __future__ import annotations

import io
import zipfile
from typing import Dict, List, Mapping

import numpy as np
import torch

VGG16_LAYERS = tuple(f"block{b}_conv{c}" for b, n in
                     ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
                     for c in range(1, n + 1))


def read_keras_weights(path: str) -> Dict[str, List[np.ndarray]]:
    """Layer name -> its weight arrays (float32, Keras's order) of a Keras
    weights file (see the module docstring for the formats)."""
    import h5py

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            source = io.BytesIO(z.read("model.weights.h5"))
    else:
        source = path
    out: Dict[str, List[np.ndarray]] = {}
    as_str = lambda v: v.decode() if isinstance(v, bytes) else str(v)  # noqa: E731
    with h5py.File(source, "r") as f:
        if "layers" in f:  # Keras 3
            for group in f["layers"].values():
                if "vars" not in group:
                    continue
                var = group["vars"]
                name = as_str(var.attrs.get("name", group.name.split("/")[-1]))
                out[name] = [np.asarray(var[k], np.float32)
                             for k in sorted(var, key=int)]
            return out
        root = f["model_weights"] if "model_weights" in f else f
        if "layer_names" not in root.attrs:
            raise ValueError(f"{path}: not a Keras weights file (no 'layers' "
                             "group and no 'layer_names' attribute)")
        for name in map(as_str, root.attrs["layer_names"]):
            names = [as_str(w) for w in root[name].attrs["weight_names"]]
            out[name] = [np.asarray(root[name][w], np.float32) for w in names]
    return out


def _layer(weights: Mapping[str, List[np.ndarray]], name: str,
           count: int) -> List[np.ndarray]:
    if name not in weights:
        raise ValueError(f"the Keras file has no layer {name!r}")
    if len(weights[name]) != count:
        raise ValueError(f"Keras layer {name!r} has {len(weights[name])} "
                         f"weights, expected {count}")
    return weights[name]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def keras_vgg16_to_torch(path: str) -> Dict[str, torch.Tensor]:
    """Keras VGG16's 13 convs (``block{i}_conv{j}``) -> the port's
    ``VGG16Backbone`` state dict (``convs.<k>.weight`` / ``.bias``)."""
    weights = read_keras_weights(path)
    out = {}
    for k, name in enumerate(VGG16_LAYERS):
        kernel, bias = _layer(weights, name, 2)
        out[f"convs.{k}.weight"] = _t(kernel.transpose(3, 2, 0, 1))
        out[f"convs.{k}.bias"] = _t(bias)
    return out


def keras_mobilenetv2_to_torch(path: str) -> Dict[str, torch.Tensor]:
    """Keras MobileNetV2 (alpha 1.0) -> the port's ``MobileNetV2Backbone``
    state dict: ``Conv1`` / ``bn_Conv1`` -> ``convs.0`` / ``bns.0``; block
    i (``expanded_conv``, ``block_1`` ... ``block_16``) -> ``blocks.i``,
    its expand (when present), depthwise and project convs and BNs in
    order; ``Conv_1`` / ``Conv_1_bn`` -> ``convs.1`` / ``bns.1``."""
    weights = read_keras_weights(path)
    out: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, name: str, depthwise: bool = False) -> None:
        (kernel,) = _layer(weights, name, 1)
        perm = (2, 3, 0, 1) if depthwise else (3, 2, 0, 1)
        out[f"{prefix}.weight"] = _t(kernel.transpose(perm))

    def bn(prefix: str, name: str) -> None:
        gamma, beta, mean, var = _layer(weights, name, 4)
        out.update({f"{prefix}.weight": _t(gamma), f"{prefix}.bias": _t(beta),
                    f"{prefix}.running_mean": _t(mean),
                    f"{prefix}.running_var": _t(var)})

    conv("convs.0", "Conv1")
    bn("bns.0", "bn_Conv1")
    for i in range(17):
        keras = "expanded_conv" if i == 0 else f"block_{i}"
        j = 0
        parts = ([("expand", False)] if f"{keras}_expand" in weights else []) \
            + [("depthwise", True), ("project", False)]
        for part, depthwise in parts:
            conv(f"blocks.{i}.convs.{j}", f"{keras}_{part}", depthwise)
            bn(f"blocks.{i}.bns.{j}", f"{keras}_{part}_BN")
            j += 1
    conv("convs.1", "Conv_1")
    bn("bns.1", "Conv_1_bn")
    return out


_CONVERTERS = {"vgg16": keras_vgg16_to_torch,
               "mobilenetv2": keras_mobilenetv2_to_torch}


def load_pretrained_backbone(state_dict: Mapping[str, torch.Tensor],
                             backbone: str, source: str
                             ) -> Dict[str, torch.Tensor]:
    """``state_dict`` (a whole model's) with its ``backbone.*`` entries
    replaced by the converted weights of ``source``: a Keras file for vgg16
    and mobilenetv2, an original darknet ``.weights`` / ``.conv.NN`` file for
    the darknet backbones. Every backbone entry must be converted, at its
    shape, and no other: anything else raises."""
    if backbone.startswith("darknet"):
        from keras_object_detection_torch.models.darknet_import import (
            load_darknet_backbone)

        out, info = load_darknet_backbone(state_dict, source)
        print(f"darknet import: {info['loaded_convs']}/{info['total_convs']} "
              f"convs from {source} (version {info['version']}, seen "
              f"{info['seen']})")
        return out
    if backbone not in _CONVERTERS:
        raise ValueError(f"no pretrained converter for backbone {backbone!r}; "
                         f"options: {sorted(_CONVERTERS)} and the darknets")
    converted = {f"backbone.{k}": v
                 for k, v in _CONVERTERS[backbone](source).items()}
    want = {k: tuple(v.shape) for k, v in state_dict.items()
            if k.startswith("backbone.")}
    missing = sorted(set(want) - set(converted))
    extra = sorted(set(converted) - set(want))
    if missing or extra:
        raise ValueError(f"{source}: converted backbone lacks {missing}, has "
                         f"unknown {extra}")
    for k, v in converted.items():
        if tuple(v.shape) != want[k]:
            raise ValueError(f"{source}: {k} has shape {tuple(v.shape)}, "
                             f"expected {want[k]}")
    out = dict(state_dict)
    out.update(converted)
    return out
