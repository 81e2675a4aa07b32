"""Backbone registry (counterpart of
``keras_object_detection_tpu/models/backbones.py`` ``BACKBONES``).

The darknet24 / darknet_tiny / darknet_micro tables are ported; the other
backbones of the JAX package raise until their slice lands."""

from __future__ import annotations

import torch

from keras_object_detection_torch.models.darknet import (
    ARCHITECTURE_CONFIG, DARKNET_MICRO_CONFIG, DARKNET_TINY_CONFIG,
    DarknetBackbone)


def _darknet(table):
    def build(dtype: torch.dtype, activation: str = "relu", *,
              generator: torch.Generator,
              bn_mode: str = "flax") -> DarknetBackbone:
        return DarknetBackbone(table, activation, dtype, generator=generator,
                               bn_mode=bn_mode)

    return build


def _not_ported(name: str, item: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (ROADMAP {item})")

    return build


BACKBONES = {
    "darknet24": _darknet(ARCHITECTURE_CONFIG),
    "darknet_tiny": _darknet(DARKNET_TINY_CONFIG),
    "darknet_micro": _darknet(DARKNET_MICRO_CONFIG),
    "darknet19": _not_ported("darknet19", "1.9"),
    "darknet53": _not_ported("darknet53", "1.11"),
    "vgg16": _not_ported("vgg16", "1.9"),
    "mobilenetv2": _not_ported("mobilenetv2", "1.9"),
}
