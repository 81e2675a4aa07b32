"""True int8 serving: BatchNorm folding and s8 x s8 -> s32 convolutions
(counterpart of ``keras_object_detection_tpu/export/int8_serving.py``).

- Inference-mode BatchNorm folds into each conv's kernel and bias, so a
  ``ConvBlock`` becomes conv + bias + activation (``fold_conv_bn``, in
  float64, then float32, eps 1e-3).
- Folded kernels are quantized per output channel, symmetric int8
  (``_quantize_kernel``); the conv runs as int8 x int8 with int32 sums
  (``ops/int8_conv.py``: im2col + ``torch._int_mm`` on the GPU), rescaled
  once by ``activation_scale * weight_scale`` and biased in float32.
- Activations are quantized per image (absmax / 127) by default, or with
  static per-tensor scales picked by a quantization-MSE sweep on a
  calibration batch (``calibrate_activation_scales``); the first conv's
  input is the u8 image scaled by 127/255 in integers. Zero-point 0 keeps
  the explicit zero padding exact. 2x2 max-pools run on the int8 tensor of
  the next conv's quantization (max commutes with a positive scale).
- The final 1x1 detection convs stay float32; ``float_tail`` keeps the
  last N folded convs in float32 too. Bias correction
  (``bias_corrected_layers``) and QAT (``export/qat.py``) are the further
  offline levers.

Scope, as in JAX: every table-driven darknet backbone (Darknet-53's
residual stages included) under the conv head, the anchor head, the
passthrough anchor head and the FPN head. The dense heads raise.

**Layouts.** Activations are NHWC. The layer list is JAX's, with each conv
kernel ``(cout, kh, kw, cin)`` (OHWI) instead of JAX's HWIO: ``w_q`` int8,
``w`` float32; JAX's kernel is ``kernel.permute(1, 2, 3, 0)``
(``hwio``). ``w_scale``, ``bias`` and the final convs' ``b`` are
``(cout,)`` float32, ``a_scale`` a 0-dim float32 tensor; every tensor on the
serving device. OHWI makes the int8 kernel the GEMM's ``(N, K)`` matrix as
it stands and the float32 kernel a channels-last OIHW view.

**Numerics.** Each operation rounds once, as JAX's functions do run op
by op: every division is a true division, by a tensor on the activation's
device (PyTorch on the GPU multiplies by the reciprocal of a CPU scalar
divisor), the per-image scale ``max(absmax, 1e-12) / 127`` included, and
the rescale ``acc * (x_scale * w_scale) + bias`` rounds twice. XLA's jitted
program may fuse that rescale into one FMA, and a value one ulp off before
a ``round`` moves an int8 value by one, which spreads through the layers
after it; so the port is held to JAX's op-by-op (eager) forward. The float32
convs (the final ones, a ``float_tail``, calibration and QAT) go through
cuDNN and so use TF32 unless ``torch.backends.cudnn.allow_tf32`` is off; the
int8 convs are exact either way.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.eval.evaluator import (InferenceModel,
                                                         ServingModel,
                                                         check_serving_config,
                                                         serving_device)
from keras_object_detection_torch.models.darknet import (ARCHITECTURES,
                                                         _downsample_indices)
from keras_object_detection_torch.models.layers import space_to_depth
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression
from keras_object_detection_torch.ops.int8_conv import int8_conv2d, pad_nhwc
from keras_object_detection_torch.train.loop import _device

Device = Optional[Union[str, torch.device]]
Layer = Dict[str, torch.Tensor]

_BN_EPS = 1e-3  # ConvBlock's Keras-style epsilon (models/layers.py)


def hwio(kernel: torch.Tensor) -> torch.Tensor:
    """A layer's OHWI kernel in JAX's HWIO layout."""
    return kernel.permute(1, 2, 3, 0)


def conv_plan(backbone: str, n_taps: int = 0) -> List[Tuple]:
    """A darknet table as execution-ordered steps: ``("conv", kernel,
    stride, pad)`` (a ``ConvBlock``, in ``DarknetBackbone.blocks`` order),
    ``("pool",)``, ``("res_begin",)`` / ``("res_add",)`` around each
    residual unit, and ``("tap", j)`` (pyramid tap j, coarse -> fine) before
    each of the last ``n_taps`` downsamples."""
    if backbone not in ARCHITECTURES:
        raise ValueError(
            f"int8 serving supports table-driven darknet backbones "
            f"{sorted(ARCHITECTURES)}, not {backbone!r}")
    table = ARCHITECTURES[backbone]
    tap_at = {}
    if n_taps:
        ds = _downsample_indices(table)
        if len(ds) < n_taps:
            raise ValueError(f"{n_taps} taps need {n_taps} downsamples; "
                             f"the {backbone} table has {len(ds)}")
        tap_at = {idx: n_taps - 1 - j for j, idx in enumerate(ds[-n_taps:])}
    steps: List[Tuple] = []
    for i, entry in enumerate(table):
        if i in tap_at:
            steps.append(("tap", tap_at[i]))
        if isinstance(entry, str):
            steps.append(("pool",))
        elif len(entry) == 4 and all(isinstance(v, int) for v in entry):
            k, _, s, p = entry
            steps.append(("conv", k, s, p))
        elif entry[0] == "R":  # residual stage (darknet53 grammar)
            for _ in range(entry[2]):
                steps += [("res_begin",), ("conv", 1, 1, 0), ("conv", 3, 1, 1),
                          ("res_add",)]
        else:
            conv_a, conv_b, repeats = entry
            for _ in range(repeats):
                steps.append(("conv", conv_a[0], conv_a[2], conv_a[3]))
                steps.append(("conv", conv_b[0], conv_b[2], conv_b[3]))
    return steps


def fold_conv_bn(kernel, bias, bn_scale, bn_bias, bn_mean, bn_var,
                 eps: float = _BN_EPS):
    """Fold inference-mode BatchNorm into the conv before it:
    ``BN(conv(x, W) + b) == conv(x, W * m) + (beta + (b - mean) * m)``,
    ``m = gamma / sqrt(var + eps)``; in float64, returned in float32. The
    kernel's LAST axis is the output channel (HWIO)."""
    m = np.asarray(bn_scale, np.float64) / np.sqrt(
        np.asarray(bn_var, np.float64) + eps)
    w = np.asarray(kernel, np.float64) * m
    b = (np.asarray(bn_bias, np.float64)
         + (np.asarray(bias, np.float64) - np.asarray(bn_mean, np.float64))
         * m)
    return w.astype(np.float32), b.astype(np.float32)


def _quantize_kernel(w: np.ndarray):
    """Per-output-channel symmetric int8 of an HWIO kernel: ``(int8 kernel,
    (cout,) float32 scale)``."""
    absmax = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _head_plan(config: Config) -> Tuple[Tuple, int, int]:
    """``(head_steps, n_head_convblocks, n_final_convs)``. Head steps:
    ``("head_conv",)`` (3x3 SAME, stride ``max(H // grid, 1)``),
    ``("conv_same", k)``, ``("tap_conv",)`` (the next block on the saved
    passthrough tap), ``("reorg_concat",)``, ``("emit",)`` (float32 1x1
    final conv), ``("pred_emit",)`` (an FPN prediction branch: the 3x3 2f
    block and the final conv on a copy of the trunk) and
    ``("route_up_concat", j)`` (the FPN route block, nearest 2x and tap j)."""
    head = config.model.head
    passthrough = config.model.passthrough
    if head == "conv" or (head == "anchor" and not passthrough):
        return (("head_conv",), ("emit",)), 1, 1
    if head == "anchor" and passthrough:
        return (("head_conv",), ("tap_conv",), ("reorg_concat",),
                ("conv_same", 3), ("emit",)), 3, 1
    if head == "fpn":
        scales = config.model.fpn_scales
        steps: List[Tuple] = []
        n_blocks = 0
        for s in range(scales):
            for k in (1, 3, 1, 3, 1):  # the v3 5-conv trunk
                steps.append(("conv_same", k))
            steps.append(("pred_emit",))
            n_blocks += 6
            if s + 1 < scales:
                steps.append(("route_up_concat", s))
                n_blocks += 1
        return tuple(steps), n_blocks, scales
    raise ValueError(
        "int8 serving supports head='conv', the anchor head (incl. "
        "passthrough), and the fpn head; the dense heads (gap_dense, "
        f"flatten_dense) serve float — got {head!r}")


def _n_taps(config: Config) -> int:
    if config.model.head == "fpn":
        return config.model.fpn_scales - 1
    return 1 if config.model.passthrough else 0


def _head_modules(config: Config, n_head_blocks: int):
    """The ``state_dict`` prefixes of the head's ConvBlocks (flax's
    ``ConvBlock_i`` order) and of its final convs."""
    if config.model.head == "fpn":
        return ([f"head.blocks.{i}" for i in range(n_head_blocks)],
                [f"head.convs.{s}" for s in range(config.model.fpn_scales)])
    if config.model.passthrough:
        return [f"head.blocks.{i}" for i in range(n_head_blocks)], ["head.conv"]
    return ["head.block"], ["head.conv"]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _ohwi(kernel_hwio: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        kernel_hwio.transpose(3, 0, 1, 2))).to(device)


def build_int8_layers(config: Config, state_dict: Mapping[str, torch.Tensor],
                      float_tail: int = 0, device: Device = None):
    """``(plan, layers)`` for ``int8_forward`` from the float model's
    ``state_dict``: the plan's steps (``conv_plan``, then ``_head_plan``) and
    every folded ConvBlock in execution order (backbone walk order, then
    the head's call order, flax's numbering), quantized (``w_q``,
    ``w_scale``, ``bias``) or, for the last ``float_tail`` of them, float32
    (``w``, ``bias``); then the float32 final 1x1 conv(s) (``w``, ``b``).
    The tensors go to ``device`` (default cuda)."""
    dev = _device(device, "int8 serving")
    head_steps, n_head_blocks, n_finals = _head_plan(config)
    plan = conv_plan(config.model.backbone, n_taps=_n_taps(config)) + list(
        head_steps)
    n_backbone = sum(1 for s in plan if s[0] == "conv")
    blocks, finals = _head_modules(config, n_head_blocks)
    blocks = [f"backbone.blocks.{i}" for i in range(n_backbone)] + blocks
    sd = state_dict
    float_tail = max(0, min(int(float_tail), len(blocks)))
    layers: List[Layer] = []
    for i, name in enumerate(blocks):
        w, b = fold_conv_bn(
            _np(sd[f"{name}.conv.weight"].permute(2, 3, 1, 0)),  # HWIO
            _np(sd[f"{name}.conv.bias"]), _np(sd[f"{name}.bn.weight"]),
            _np(sd[f"{name}.bn.bias"]), _np(sd[f"{name}.bn.running_mean"]),
            _np(sd[f"{name}.bn.running_var"]))
        bias = torch.from_numpy(b).to(dev)
        if i >= len(blocks) - float_tail:
            layers.append({"w": _ohwi(w, dev), "bias": bias})
        else:
            q, ws = _quantize_kernel(w)
            layers.append({"w_q": _ohwi(q, dev),
                           "w_scale": torch.from_numpy(ws).to(dev),
                           "bias": bias})
    for name in finals:  # copies: QAT updates the layers in place
        layers.append({
            "w": sd[f"{name}.weight"].detach().to(dev, torch.float32)
            .permute(0, 2, 3, 1).clone(memory_format=torch.contiguous_format),
            "b": sd[f"{name}.bias"].detach().to(dev, torch.float32).clone()})
    return tuple(plan), layers


def absmax_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) / 127``, a true division on every device."""
    return torch.clamp_min(absmax, 1e-12) / absmax.new_full((), 127.0)


def _quantize_act(x: torch.Tensor, static_scale: Optional[torch.Tensor] = None):
    """Symmetric float32 -> int8: per image (absmax / 127, shape (B, 1, 1,
    1)) by default, or the calibrated static per-tensor ``static_scale``.
    Returns ``(xq, scale)``."""
    if static_scale is not None:
        scale = static_scale
    else:
        scale = absmax_scale(x.abs().amax(dim=(1, 2, 3), keepdim=True))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_conv(xq: torch.Tensor, x_scale: torch.Tensor, layer: Layer,
               stride: int, pad) -> torch.Tensor:
    """s8 x s8 -> s32 conv, rescaled to float32 and biased."""
    acc = int8_conv2d(xq, layer["w_q"], stride, pad)
    return acc.to(torch.float32) * (x_scale * layer["w_scale"]) + layer["bias"]


def _f32_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              stride: int, pad) -> torch.Tensor:
    """NHWC float32 conv with an OHWI kernel, padded as the int8 conv, the
    bias added after the conv."""
    xp = pad_nhwc(x, w.shape[1], stride, pad)
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), None, stride)
    return y.permute(0, 2, 3, 1) + bias


def _activation(name: str):
    if name == "leaky_relu":
        return lambda v: F.leaky_relu(v, 0.1)
    return F.relu


def _pool_f32(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of NHWC float32 (its gradient to the first
    maximum of a window, as XLA's)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _pool_int8(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of NHWC int8 (max_pool2d takes no int8 on the
    GPU): the maximum of each window's four values, exact."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _reorg(tap: torch.Tensor, block: int) -> torch.Tensor:
    """``space_to_depth`` of an NHWC tensor, JAX's channel order."""
    return space_to_depth(tap.permute(0, 3, 1, 2), block).permute(0, 2, 3, 1)


def _ingest_f32(images_u8: torch.Tensor) -> torch.Tensor:
    """A float32 first conv's input: the pixels / 255 (a true division)."""
    x = images_u8.to(torch.float32)
    return x / x.new_full((), 255.0)


def _ingest_int8(images_u8: torch.Tensor):
    """The first int8 conv's input: the pixels times 127/255, rounded, with
    the static scale 1/127."""
    xq = torch.round(images_u8.to(torch.float32) * (127.0 / 255.0)).to(
        torch.int8)
    return xq, torch.tensor(np.float32(1.0 / 127.0), device=images_u8.device)


class _XState:
    """An activation held as float32 ``x``, as int8 ``xq`` with its
    ``scale``, or both: ``xq`` is made when an int8 consumer first needs it.
    ``fq_done`` marks a QAT tensor already fake-quantized before a pool, so
    that the next conv does not quantize it again (the int8 path's one
    quantization with the pre-pool scale)."""

    __slots__ = ("x", "xq", "scale", "fq_done")

    def __init__(self, x=None, xq=None, scale=None, fq_done=False):
        self.x, self.xq, self.scale = x, xq, scale
        self.fq_done = fq_done

    def f32(self) -> torch.Tensor:
        if self.x is None:
            self.x = self.xq.to(torch.float32) * self.scale  # exact dequant
        return self.x

    def quantized(self, layer: Layer):
        if self.xq is None:
            self.xq, self.scale = _quantize_act(self.x, layer.get("a_scale"))
        return self.xq, self.scale


def int8_forward(plan: Sequence[Tuple], layers: Sequence[Layer],
                 images_u8: torch.Tensor, grid: int, activation: str = "relu",
                 calib: Optional[list] = None, head_activation: str = "relu"):
    """The quantized serving forward: NHWC u8 images -> the ``(B, S, S,
    depth)`` grid (the FPN head: a tuple of them, coarse -> fine).

    A conv quantizes its input (per image, or with the layer's ``a_scale``),
    runs s8 x s8 -> s32, rescales, adds the bias and applies the activation;
    a pool before an int8 conv runs on that conv's int8 input. Layers with
    ``w`` run in float32 on the unquantized activation; layers with
    ``w_fq`` (QAT, ``export/qat.py``) fake-quantize kernel and input and run
    a float32 conv, differentiably. Residual adds, taps, reorg, route,
    upsample and concatenations run on the float32 view.

    ``calib``: calibration mode. Each quantized conv runs in float32 with its
    dequantized kernel, and ``calib.append`` receives the MSE-optimal scale
    of its float32 input (``_optimal_act_scale``).

    ``head_activation``: the head blocks' nonlinearity (ReLU for the conv
    and passthrough heads whatever the backbone's; the FPN head's is the
    model's)."""
    act = _activation(activation)
    head_act = _activation(head_activation)
    st = _XState()
    if "w_q" in layers[0] and calib is None:
        st.xq, st.scale = _ingest_int8(images_u8)
    else:
        st.x = _ingest_f32(images_u8)
    li = 0
    taps: Dict[int, torch.Tensor] = {}
    res_stack: List[torch.Tensor] = []
    outputs: List[torch.Tensor] = []
    n_finals = sum(1 for s in plan if s[0] in ("emit", "pred_emit"))

    def conv_step(state: _XState, stride: int, pad, a=None) -> _XState:
        nonlocal li
        a = a or act
        layer = layers[li]
        li += 1
        if calib is not None:
            x = state.f32()
            if "w_q" in layer:
                calib.append(_optimal_act_scale(x))
                w = layer["w_q"].to(torch.float32) * layer["w_scale"][
                    :, None, None, None]
                y = a(_f32_conv(x, w, layer["bias"], stride, pad))
            else:
                y = a(_f32_conv(x, layer["w"], layer["bias"], stride, pad))
        elif "w_q" in layer:
            xq, x_scale = state.quantized(layer)
            y = a(_int8_conv(xq, x_scale, layer, stride, pad))
        elif "w_fq" in layer:
            from keras_object_detection_torch.export.qat import (
                fake_quant_act, fake_quant_kernel)
            xf = (state.f32() if state.fq_done
                  else fake_quant_act(state.f32(), layer.get("a_scale")))
            y = a(_f32_conv(xf, fake_quant_kernel(layer["w_fq"]),
                            layer["bias"], stride, pad))
        else:
            y = a(_f32_conv(state.f32(), layer["w"], layer["bias"], stride,
                            pad))
        return _XState(x=y)

    for step in plan:
        kind = step[0]
        if kind == "conv":
            st = conv_step(st, step[2], step[3])
        elif kind == "pool":
            nxt = layers[li] if li < len(layers) else {}
            if st.xq is None and calib is None and "w_q" in nxt:
                st.quantized(nxt)  # pool in int8
            if (st.xq is None and not st.fq_done and calib is None
                    and "w_fq" in nxt):
                # QAT's pool-in-int8: one quantize-dequantize with the
                # pre-pool scale, consumed as-is by the next conv
                from keras_object_detection_torch.export.qat import \
                    fake_quant_act
                st = _XState(x=fake_quant_act(st.f32(), nxt.get("a_scale")),
                             fq_done=True)
            if st.xq is not None:
                st.xq, st.x = _pool_int8(st.xq), None
            else:
                st.x = _pool_f32(st.x)
        elif kind == "res_begin":
            res_stack.append(st.f32())
        elif kind == "res_add":
            st = _XState(x=res_stack.pop() + st.f32())
        elif kind == "tap":
            taps[step[1]] = st.f32()
        elif kind == "head_conv":
            spatial = (st.x if st.x is not None else st.xq).shape[1]
            st = conv_step(st, max(spatial // grid, 1), "SAME", head_act)
        elif kind == "conv_same":
            st = conv_step(st, 1, "SAME", head_act)
        elif kind == "tap_conv":
            main = st
            st = conv_step(_XState(x=taps[0]), 1, "SAME", head_act)
            taps[0] = st.f32()
            st = main
        elif kind == "reorg_concat":
            x = st.f32()
            tap = taps[0]
            block = tap.shape[1] // x.shape[1]
            if block > 1:
                tap = _reorg(tap, block)
            st = _XState(x=torch.cat([x, tap], dim=-1))
        elif kind in ("emit", "pred_emit"):
            br = st
            if kind == "pred_emit":
                # the prediction branch sees a copy; the trunk goes on
                br = conv_step(_XState(x=st.x, xq=st.xq, scale=st.scale,
                                       fq_done=st.fq_done),
                               1, "SAME", head_act)
            final = layers[len(layers) - n_finals + len(outputs)]
            outputs.append(_f32_conv(br.f32(), final["w"], final["b"], 1, 0))
        elif kind == "route_up_concat":
            st = conv_step(st, 1, "SAME", head_act)  # the 1x1 route
            st = _XState(x=torch.cat([_upsample2(st.f32()), taps[step[1]]],
                                     dim=-1))
        else:
            raise ValueError(f"unknown plan step {step!r}")
    return outputs[0] if len(outputs) == 1 else tuple(outputs)


def _head_activation(config: Config) -> str:
    """ConvHead and PassthroughConvHead use ReLU whatever the backbone's
    activation; FPNHead uses the model's."""
    return config.model.activation if config.model.head == "fpn" else "relu"


_CLIP_RATIOS = np.linspace(0.25, 1.0, 16)


def _optimal_act_scale(x: torch.Tensor) -> float:
    """The symmetric scale of ``x`` with the least quantization MSE among
    the clip points ``r * absmax``, r in [0.25, 1.0] (16 steps)."""
    x = x.to(torch.float32)
    absmax = float(x.abs().max())
    if absmax <= 0:
        return 1.0 / 127.0
    best_scale, best_err = absmax / 127.0, None
    for r in _CLIP_RATIOS:
        scale = max(r * absmax, 1e-12) / 127.0
        s = torch.tensor(np.float32(scale), device=x.device)
        q = torch.clamp(torch.round(x / s), -127, 127)
        err = float(torch.mean(torch.square(q * s - x)))
        if best_err is None or err < best_err:
            best_err, best_scale = err, scale
    return float(best_scale)


def calibrate_activation_scales(config: Config,
                                state_dict: Mapping[str, torch.Tensor],
                                images_u8, float_tail: int = 0,
                                device: Device = None) -> List[float]:
    """One static input scale per quantized conv, in layer order, from a
    representative batch: the folded network runs once in float32 with
    serving's dequantized kernels, and each quantized conv's input gets the
    MSE sweep's scale (``_optimal_act_scale``). Feed the result to
    ``apply_activation_scales``."""
    dev = _device(device, "int8 calibration")
    plan, layers = build_int8_layers(config, state_dict, float_tail, dev)
    calib: List[float] = []
    with torch.no_grad():
        int8_forward(plan, layers, torch.as_tensor(images_u8).to(dev),
                     config.grid.grid, config.model.activation, calib=calib,
                     head_activation=_head_activation(config))
    return calib


def apply_activation_scales(layers: Sequence[Layer],
                            scales: Sequence[float]) -> List[Layer]:
    """A new layer list with the static scales (``a_scale``) attached to the
    quantized convs, in order."""
    scales = list(scales)
    out = []
    for layer in layers:
        if "w_q" in layer:
            layer = dict(layer, a_scale=torch.tensor(
                np.float32(scales.pop(0)), device=layer["w_q"].device))
        out.append(layer)
    if scales:
        raise ValueError(f"{len(scales)} unused activation scales "
                         "(layer list mismatch)")
    return out


def bias_corrected_layers(config: Config,
                          state_dict: Mapping[str, torch.Tensor], images_u8,
                          float_tail: int = 0,
                          act_scales: Optional[Sequence[float]] = None,
                          device: Device = None):
    """``(plan, layers)`` with per-channel bias correction: the float32 and
    the int8 networks walk the representative batch in lockstep, and each
    quantized conv's bias takes the mean pre-activation error ``E[y_float -
    y_int8]`` over images and positions; later layers are corrected against
    the corrected earlier ones. ``act_scales`` (static calibrated scales)
    are attached first, so the correction targets what will serve."""
    dev = _device(device, "int8 bias correction")
    plan, fl = build_int8_layers(config, state_dict, 10 ** 9, dev)
    _, ql = build_int8_layers(config, state_dict, float_tail, dev)
    if act_scales is not None:
        ql = apply_activation_scales(ql, act_scales)
    ql = [dict(layer) for layer in ql]
    g = config.grid
    act = _activation(config.model.activation)
    head_act = _activation(_head_activation(config))
    images = torch.as_tensor(images_u8).to(dev)
    li = 0

    def conv_pair(xf, stq: _XState, stride, pad, a):
        nonlocal li
        f, q = fl[li], ql[li]
        yf = _f32_conv(xf, f["w"], f["bias"], stride, pad)
        if "w_q" in q:
            xq, xs = stq.quantized(q)
            yq = _int8_conv(xq, xs, q, stride, pad)
            delta = torch.mean(yf - yq, dim=(0, 1, 2))
            ql[li] = dict(q, bias=q["bias"] + delta)
            yq = yq + delta
        else:
            yq = _f32_conv(stq.f32(), q["w"], q["bias"], stride, pad)
        li += 1
        return a(yf), _XState(x=a(yq))

    with torch.no_grad():
        xf = _ingest_f32(images)
        if "w_q" in ql[0]:
            xq0, s0 = _ingest_int8(images)
            stq = _XState(xq=xq0, scale=s0)
        else:
            stq = _XState(x=xf)
        taps_f: Dict[int, torch.Tensor] = {}
        taps_q: Dict[int, torch.Tensor] = {}
        stack_f: List[torch.Tensor] = []
        stack_q: List[torch.Tensor] = []
        for step in plan:
            kind = step[0]
            if kind == "conv":
                xf, stq = conv_pair(xf, stq, step[2], step[3], act)
            elif kind == "pool":
                xf = _pool_f32(xf)
                stq = _XState(x=_pool_f32(stq.f32()))
            elif kind == "res_begin":
                stack_f.append(xf)
                stack_q.append(stq.f32())
            elif kind == "res_add":
                xf = stack_f.pop() + xf
                stq = _XState(x=stack_q.pop() + stq.f32())
            elif kind == "tap":
                taps_f[step[1]] = xf
                taps_q[step[1]] = stq.f32()
            elif kind == "head_conv":
                xf, stq = conv_pair(xf, stq, max(xf.shape[1] // g.grid, 1),
                                    "SAME", head_act)
            elif kind == "conv_same":
                xf, stq = conv_pair(xf, stq, 1, "SAME", head_act)
            elif kind == "tap_conv":
                tf_, tq = conv_pair(taps_f[0], _XState(x=taps_q[0]), 1,
                                    "SAME", head_act)
                taps_f[0], taps_q[0] = tf_, tq.f32()
            elif kind == "reorg_concat":
                tf_, tq = taps_f[0], taps_q[0]
                block = tf_.shape[1] // xf.shape[1]
                if block > 1:
                    tf_, tq = _reorg(tf_, block), _reorg(tq, block)
                xf = torch.cat([xf, tf_], dim=-1)
                stq = _XState(x=torch.cat([stq.f32(), tq], dim=-1))
            elif kind in ("emit", "pred_emit"):
                if kind == "pred_emit":
                    # correct the prediction branch's block; the float32
                    # final conv needs none
                    conv_pair(xf, _XState(x=stq.x, xq=stq.xq,
                                          scale=stq.scale),
                              1, "SAME", head_act)
            elif kind == "route_up_concat":
                xf2, stq2 = conv_pair(xf, stq, 1, "SAME", head_act)
                xf = torch.cat([_upsample2(xf2), taps_f[step[1]]], dim=-1)
                stq = _XState(x=torch.cat([_upsample2(stq2.f32()),
                                           taps_q[step[1]]], dim=-1))
            else:
                raise ValueError(f"unknown plan step {step!r}")
    return plan, ql


class Int8InferenceModel(ServingModel):
    """``InferenceModel``'s twin serving folded int8 weights: the int8
    kernels are what the device keeps, with no dequantized copy.

    ``calib_images``: an ``(N, H, W, 3)`` u8 representative batch; with it
    activations quantize with static calibrated scales instead of per image
    (``act_quant``: ``"static"`` (needs ``calib_images``), ``"dynamic"`` or
    ``"auto"``, static iff ``calib_images``). ``bias_correct``: fold the mean
    per-channel quantization error into the biases
    (``bias_corrected_layers``; needs ``calib_images``). ``qat_steps > 0``:
    a fake-quant distillation fine-tune before freezing to int8
    (``export/qat.py``; needs ``calib_images``; exclusive with
    ``bias_correct``). As in JAX, ``predict`` serves hard NMS (the kernel on
    the GPU) whatever ``EvalConfig.nms_mode`` says. ``device=None`` means
    ``"cuda"``; there the int8 convs take ``torch._int_mm`` or raise.
    ``mesh``: a device ``parallel.Mesh``: the layers are built (and
    calibrated) on ``device``, by default the mesh's first device, and
    replicated on the first device of each data row of the mesh, which
    serves shard by shard as
    ``InferenceModel(mesh=)`` does."""

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 float_tail: int = 0, calib_images=None,
                 bias_correct: bool = False, act_quant: str = "auto",
                 qat_steps: int = 0, qat_lr: float = 1e-5, qat_batch: int = 8,
                 device: Device = None, mesh=None):
        check_serving_config(config.eval, mesh)
        self.device = _device(serving_device(device, mesh), "int8 serving")
        self.config = config
        if act_quant == "auto":
            act_quant = "static" if calib_images is not None else "dynamic"
        if act_quant not in ("static", "dynamic"):
            raise ValueError(f"act_quant {act_quant!r} not in "
                             "static|dynamic|auto")
        if (act_quant == "static" or bias_correct or qat_steps) \
                and calib_images is None:
            raise ValueError("static act_quant / bias_correct / qat_steps "
                             "need calib_images")
        if qat_steps and bias_correct:
            raise ValueError("qat_steps and bias_correct are mutually "
                             "exclusive (QAT's distillation already absorbs "
                             "the mean quantization error)")
        scales = (calibrate_activation_scales(
            config, state_dict, calib_images, float_tail, self.device)
            if act_quant == "static" else None)
        if qat_steps:
            from keras_object_detection_torch.export.qat import qat_finetune

            plan, layers, self.qat_info = qat_finetune(
                config, state_dict, calib_images, steps=qat_steps, lr=qat_lr,
                batch_size=qat_batch, float_tail=float_tail,
                act_scales=scales, device=self.device)
        elif bias_correct:
            plan, layers = bias_corrected_layers(
                config, state_dict, calib_images, float_tail, scales,
                self.device)
        else:
            plan, layers = build_int8_layers(config, state_dict, float_tail,
                                             self.device)
            if scales is not None:
                layers = apply_activation_scales(layers, scales)
        self.plan, self.layers = plan, layers
        self._shard_over(mesh)

    def _forward(self, images_u8: torch.Tensor):
        return int8_forward(self.plan, self.layers, images_u8,
                            self.config.grid.grid, self.config.model.activation,
                            head_activation=_head_activation(self.config))

    def _nms(self, boxes: torch.Tensor):
        e = self.config.eval
        return auto_batched_non_max_suppression(
            boxes, e.iou_threshold, e.conf_threshold, e.max_candidates)

    def memory_footprint(self) -> Dict[str, int]:
        """The layer list's bytes, and the same layers' in float32."""
        qbytes = sum(t.numel() * t.element_size()
                     for layer in self.layers for t in layer.values())
        fbytes = sum(
            (layer["w_q"] if "w_q" in layer else layer["w"]).numel() * 4
            + (layer["bias"] if "bias" in layer else layer["b"]).numel() * 4
            for layer in self.layers)
        return {"quantized_bytes": qbytes, "float_bytes": fbytes}


def select_serving_model(config: Config,
                         state_dict: Mapping[str, torch.Tensor],
                         mode: str = "auto", probe_batch: int = 1,
                         probe_runs: int = 5, calib_images=None,
                         device: Device = None, **int8_kwargs):
    """``(model, info)``: the float ``InferenceModel`` or the
    ``Int8InferenceModel``, by measurement. ``"float"`` / ``"int8"`` force
    one; ``"auto"`` builds both, times each with ``benchmark_latency`` at
    ``probe_batch`` zero images, and serves the faster (int8 on a tie).
    ``info``: ``{"mode"}``, for auto also ``probe_batch``, both p50s
    (``float_p50_ms``, ``int8_p50_ms``, rounded to 3 places) and
    ``chosen``."""
    if mode == "float":
        return InferenceModel(config, state_dict, device=device), {
            "mode": "float"}
    if mode == "int8":
        return (Int8InferenceModel(config, state_dict,
                                   calib_images=calib_images, device=device,
                                   **int8_kwargs),
                {"mode": "int8"})
    if mode != "auto":
        raise ValueError(f"serving mode {mode!r} not in float|int8|auto")
    fmodel = InferenceModel(config, state_dict, device=device)
    qmodel = Int8InferenceModel(config, state_dict, calib_images=calib_images,
                                device=device, **int8_kwargs)
    size = config.model.image_size
    probe = np.zeros((probe_batch, size, size, 3), np.uint8)
    f_p50 = fmodel.benchmark_latency(probe, runs=probe_runs)["p50_ms"]
    q_p50 = qmodel.benchmark_latency(probe, runs=probe_runs)["p50_ms"]
    info = {"mode": "auto", "probe_batch": probe_batch,
            "float_p50_ms": round(f_p50, 3), "int8_p50_ms": round(q_p50, 3),
            "chosen": "int8" if q_p50 <= f_p50 else "float"}
    return (qmodel if info["chosen"] == "int8" else fmodel), info
