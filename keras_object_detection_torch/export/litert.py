"""Model export (counterpart of ``keras_object_detection_tpu/export/litert.py``,
whose reference is the Keras repository's ``convert_to_tflite.py``).

- ``export_program``: the float32 serving function through
  ``torch.export`` to a ``.pt2`` file (``torch.export.save``), the portable
  artifact of this port (JAX's ``export_stablehlo`` serialises
  ``jax.export``'s StableHLO); ``load_program`` reads it back.
- ``export_tflite``: raises ``NotImplementedError``. JAX converts through
  TensorFlow (``jax2tf``); a PyTorch model needs a torch -> LiteRT
  converter (``ai_edge_torch``) or an ONNX route (``onnx``, onnx2tf), and
  none of them is installed here or on the GPU machine.
- ``default_representative_dataset``: the reference's calibration recipe,
  100 uniform random ``1 x H x W x 3`` float32 images.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Callable, Iterator, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.core.fpn import (fpn_grid_sizes,
                                                   partition_anchors)
from keras_object_detection_torch.models.yolo import build_model

TFLITE_GAP = ("export_tflite: no torch -> LiteRT converter is installed "
              "(ai_edge_torch and onnx are absent); export a torch.export "
              "program instead (export_program, cli.export --format program)")


class ServingFunction(nn.Module):
    """float32 ``[0, 1]`` NHWC images -> ``(batch, S, S, depth)`` grid
    predictions, or for the FPN head a tuple of ``(batch, S_s, S_s,
    B_s * (5 + C))`` grids, coarse -> fine (decode stays outside the
    artifact, as in JAX's exports)."""

    def __init__(self, model: nn.Module, shapes):
        super().__init__()
        self.model = model
        self.shapes = tuple(shapes)

    def forward(self, images: torch.Tensor):
        y = self.model(images)
        if isinstance(y, tuple):
            return tuple(t.reshape((-1,) + s) for t, s in zip(y, self.shapes))
        return y.reshape((-1,) + self.shapes[0])


def _make_serving_fn(config: Config, state_dict: Mapping[str, torch.Tensor],
                     device: Union[str, torch.device] = "cpu"
                     ) -> ServingFunction:
    """The serving function of ``state_dict`` in eval mode on ``device``,
    in float32 whatever the training compute dtype (the parameters are
    float32 either way; JAX exports so because LiteRT's int8 legalisation
    refuses bf16 ops)."""
    if config.model.compute_dtype != "float32":
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, compute_dtype="float32"))
    model = build_model(config)
    model.load_state_dict(state_dict, strict=True)
    # contiguous weights: the program's archive stores whole tensors
    model = model.to(device).eval()
    g = config.grid
    if config.model.head == "fpn":
        parts = partition_anchors(g.anchors, config.model.fpn_scales)
        depth = len(parts[0]) * (5 + g.num_classes)
        shapes = [(s, s, depth)
                  for s in fpn_grid_sizes(g.grid, config.model.fpn_scales)]
    else:
        shapes = [(g.grid, g.grid, g.head_depth(config.model.head))]
    return ServingFunction(model, shapes)


def default_representative_dataset(config: Config,
                                   num_samples: int = 100) -> Callable:
    """Random calibration stream, the reference's recipe (100 x uniform
    random 1xHxWx3 float32)."""
    size = config.model.image_size

    def gen() -> Iterator:
        rng = np.random.RandomState(0)
        for _ in range(num_samples):
            yield [rng.rand(1, size, size, 3).astype(np.float32)]

    return gen


def export_tflite(config: Config, state_dict: Mapping[str, torch.Tensor],
                  output_path: str, quantize_int8: bool = False,
                  representative_dataset: Optional[Callable] = None,
                  batch_size: int = 1) -> bytes:
    """JAX's LiteRT flatbuffer export: not available to the port (module
    docstring); raises ``NotImplementedError``."""
    raise NotImplementedError(TFLITE_GAP)


def export_program(config: Config, state_dict: Mapping[str, torch.Tensor],
                   output_path: str, batch_size: int = 1,
                   device: Union[str, torch.device, None] = None) -> bytes:
    """Export the float32 serving function (``ServingFunction``) at a fixed
    ``(batch_size, H, W, 3)`` input through ``torch.export`` on ``device``
    (default ``cuda``; ``"cpu"`` on request) and write it to
    ``output_path`` (``torch.export.save``). Returns the file's bytes."""
    from keras_object_detection_torch.train.loop import _device

    dev = _device(device, "export")
    serve = _make_serving_fn(config, state_dict, dev)
    size = config.model.image_size
    example = torch.zeros(batch_size, size, size, 3, device=dev)
    with torch.no_grad():
        program = torch.export.export(serve, (example,))
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    blob = buffer.getvalue()
    with open(output_path, "wb") as f:
        f.write(blob)
    return blob


def load_program(path: str) -> Callable:
    """The exported serving function of ``path`` as a callable module on
    the device it was exported on (its weights take no gradient)."""
    return torch.export.load(path).module().requires_grad_(False)
