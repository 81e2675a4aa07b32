"""Weight-only int8 serving (counterpart of
``keras_object_detection_tpu/export/quantize.py``).

Per-channel symmetric int8 over the output channel of every parameter of
at least ``_MIN_QUANT_SIZE`` values; smaller ones stay float32, and so do
the BatchNorm running statistics (flax's ``batch_stats``, never quantized).
JAX quantizes each flax ``params`` leaf per slice of its LAST axis: the
output channel of an HWIO conv kernel and of a Dense ``(in, out)`` kernel,
each value of a 1-D leaf. In the port's ``state_dict`` the output channel is
axis 0 (conv ``(cout, cin, kh, kw)``, Linear ``(out, in)``), so the port
quantizes per slice of axis 0, each value of a 1-D tensor: the same tensors
along the same axis. ``scale`` keeps its reduced axes, ``(cout, 1, ...)``
(JAX's ``(1, ..., cout)``).

``QuantizedInferenceModel`` keeps the int8 tensors on the device and
dequantizes them inside every forward, then decodes and serves hard NMS.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch.func import functional_call

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.eval.evaluator import (ServingModel,
                                                         check_serving_config,
                                                         serving_device)
from keras_object_detection_torch.data.augment import preprocess_eval_batch
from keras_object_detection_torch.models.yolo import build_model
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression
from keras_object_detection_torch.train.loop import _device

_MIN_QUANT_SIZE = 1024  # leave biases / BN tensors in f32

Leaf = Dict[str, torch.Tensor]


def _quantize_leaf(x: torch.Tensor) -> Leaf:
    xf = x.detach().to("cpu", torch.float32)
    if x.numel() < _MIN_QUANT_SIZE or not x.is_floating_point():
        return {"f32": xf}
    absmax = (xf.abs() if xf.dim() == 1
              else xf.abs().amax(dim=tuple(range(1, xf.dim())), keepdim=True))
    # on the CPU: a true division, as JAX's eager quantize_params
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _dequantize_leaf(leaf: Leaf) -> torch.Tensor:
    if "f32" in leaf:
        return leaf["f32"]
    return leaf["q"].to(torch.float32) * leaf["scale"]


def quantize_params(params: Mapping[str, torch.Tensor]) -> Dict[str, Leaf]:
    """Parameters -> ``{"q", "scale"}`` / ``{"f32"}`` per name (on the
    CPU)."""
    return {k: _quantize_leaf(v) for k, v in params.items()}


def dequantize_params(qparams: Mapping[str, Leaf]) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_params`` (lossy: int8 rounding)."""
    return {k: _dequantize_leaf(v) for k, v in qparams.items()}


def quantized_size_bytes(qparams: Mapping[str, Leaf]) -> Tuple[int, int]:
    """(quantized_bytes, float_equivalent_bytes) of quantized parameters."""
    qbytes = sum(t.numel() * t.element_size()
                 for leaf in qparams.values() for t in leaf.values())
    fbytes = sum(t.numel() * 4 for t in dequantize_params(qparams).values())
    return qbytes, fbytes


class QuantizedInferenceModel(ServingModel):
    """Forward + decode + hard NMS over int8 weights, dequantized inside each
    forward (``torch.func.functional_call``), so the int8 tensors are what
    the device keeps. As in JAX, it serves without TTA and with hard NMS
    whatever ``EvalConfig.tta`` and ``nms_mode`` say; the cut to
    ``max_candidates`` applies (the NMS kernel takes at most 1,024
    candidates). ``device=None`` means ``"cuda"``."""

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        check_serving_config(config.eval, mesh)
        self.device = _device(serving_device(device, mesh), "serving")
        self.config = config
        model = build_model(config)
        model.load_state_dict(state_dict, strict=True)
        names = {n for n, _ in model.named_parameters()}
        # every tensor comes from functional_call: the module keeps none
        self.model = model.to("meta")
        self._qparams = {
            k: {n: t.to(self.device) for n, t in leaf.items()}
            for k, leaf in quantize_params(
                {k: v for k, v in state_dict.items() if k in names}).items()}
        self._buffers = {k: v.to(self.device) for k, v in state_dict.items()
                         if k not in names}
        self._shard_over(mesh)

    def _forward(self, images_u8: torch.Tensor):
        g, head = self.config.grid, self.config.model.head
        weights = {**dequantize_params(self._qparams), **self._buffers}
        y = functional_call(self.model, weights,
                            (preprocess_eval_batch(images_u8),))
        if head == "fpn":
            return y
        return y.reshape(-1, g.grid, g.grid, g.head_depth(head))

    @property
    def _tta(self) -> str:
        return "none"

    def _nms(self, boxes: torch.Tensor):
        e = self.config.eval
        return auto_batched_non_max_suppression(
            boxes, e.iou_threshold, e.conf_threshold, e.max_candidates)

    def memory_footprint(self) -> Dict[str, int]:
        q, f = quantized_size_bytes(self._qparams)
        return {"quantized_bytes": q, "float_bytes": f}
