"""Quantization-aware fine-tuning (QAT) for int8 serving (counterpart of
``keras_object_detection_tpu/export/qat.py``).

The student is the BN-folded float network (``build_int8_layers`` with an
all-float tail) with every conv that will serve int8 flagged ``w_fq``: its
kernel and input activation are quantize-dequantized inside the forward
(``fake_quant_kernel``, ``fake_quant_act``) on serving's grid, with
straight-through gradients (``x + (qdq(x) - x).detach()``, the scale
detached). The objective is self-distillation on a representative u8
batch: the mean squared error between the student's grids and the folded
float network's. After ``steps`` Adam updates (``train/optim.py``, optax's
arithmetic) the best student freezes back to int8 serving layers
(``freeze_qat_layers``). Kernels are OHWI, as in ``int8_serving``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.export.int8_serving import (
    Device, Layer, _head_activation, _ohwi, _quantize_kernel, absmax_scale,
    build_int8_layers, hwio, int8_forward)
from keras_object_detection_torch.train.loop import _device
from keras_object_detection_torch.train.optim import (apply_updates,
                                                      init_opt_state)

_INPUT_SCALE = 1.0 / 127.0  # int8_forward's static u8-input scale


def _fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qdq = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (qdq - x).detach()


def fake_quant_kernel(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 quantize-dequantize of an OHWI
    kernel with a straight-through gradient; the scale (absmax / 127 per
    output channel, detached) follows the live weights."""
    absmax = w.detach().abs().amax(dim=(1, 2, 3), keepdim=True)
    return _fake_quant(w, absmax_scale(absmax))


def fake_quant_act(x: torch.Tensor,
                   static_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric activation quantize-dequantize with a straight-through
    gradient: per image (absmax / 127) by default, or the static per-tensor
    scale, as ``_quantize_act`` serves."""
    if static_scale is None:
        scale = absmax_scale(x.detach().abs().amax(dim=(1, 2, 3),
                                                   keepdim=True))
    else:
        scale = static_scale.detach()
    return _fake_quant(x, scale)


def qat_layers(config: Config, state_dict: Mapping[str, torch.Tensor],
               float_tail: int = 0,
               act_scales: Optional[Sequence[float]] = None,
               device: Device = None):
    """``(plan, student_layers)``: the folded float network with serving's
    quantized convs flagged ``w_fq`` (with ``bias``, and ``a_scale`` when
    ``act_scales`` are given). The first conv's input scale is serving's
    static 1/127."""
    dev = _device(device, "QAT")
    plan, fl = build_int8_layers(config, state_dict, 10 ** 9, dev)
    _, ql = build_int8_layers(config, state_dict, float_tail, dev)
    scales = list(act_scales) if act_scales is not None else None
    student: List[Layer] = []
    for i, (f, q) in enumerate(zip(fl, ql)):
        if "w_q" not in q:
            student.append(dict(q))  # float_tail convs and the finals
            continue
        if scales is None:
            s = None
        elif scales:
            s = scales.pop(0)
        else:
            raise ValueError("act_scales ran out before the quantized convs "
                             "did (layer list mismatch — was it calibrated "
                             "with a different float_tail?)")
        if i == 0:
            s = _INPUT_SCALE
        layer = {"w_fq": f["w"], "bias": f["bias"]}
        if s is not None:
            layer["a_scale"] = torch.tensor(np.float32(s), device=dev)
        student.append(layer)
    if scales:
        raise ValueError(f"{len(scales)} unused activation scales "
                         "(layer list mismatch)")
    return plan, student


def freeze_qat_layers(layers: Sequence[Layer]) -> List[Layer]:
    """The ``w_fq`` kernels quantized back to int8 serving layers (``w_q``,
    ``w_scale``), biases and static scales kept."""
    out = []
    for layer in layers:
        if "w_fq" in layer:
            w = layer["w_fq"]
            q, ws = _quantize_kernel(
                hwio(w).detach().to("cpu", torch.float32).numpy())
            frozen = {"w_q": _ohwi(q, w.device),
                      "w_scale": torch.from_numpy(ws).to(w.device),
                      "bias": layer["bias"].detach()}
            if "a_scale" in layer:
                frozen["a_scale"] = layer["a_scale"]
            out.append(frozen)
        else:
            out.append({k: v.detach() for k, v in layer.items()})
    return out


def _trainable(layers: Sequence[Layer]) -> List[torch.Tensor]:
    """Every tensor of the student but the static scales (whose gradient is
    zero in JAX, so Adam leaves them as they are)."""
    return [t for layer in layers for k, t in layer.items() if k != "a_scale"]


def qat_finetune(config: Config, state_dict: Mapping[str, torch.Tensor],
                 images_u8, *, steps: int = 256, lr: float = 1e-5,
                 batch_size: int = 8, float_tail: int = 0,
                 act_scales: Optional[Sequence[float]] = None,
                 seed: int = 0, device: Device = None
                 ) -> Tuple[tuple, List[Layer], Dict[str, Any]]:
    """Distill the folded float network into its fake-quant twin, then
    freeze to int8: ``(plan, serving_layers, info)``.

    The images are cut into fixed minibatches (a numpy permutation from
    ``seed``; a short remainder is covered by an overlapping last batch),
    whose teacher grids are computed once; step i trains on batch ``i mod
    len``. Every ``max(1, steps // 8)`` steps and at the end the loss over
    all batches is taken, and the best student (the untouched one
    included) is frozen. ``info``: ``steps``, ``lr``, ``batch_size``,
    ``first_loss``, ``last_loss`` (the final weights'), ``best_loss`` and
    ``best_step`` (what was frozen)."""
    dev = _device(device, "QAT")
    plan, teacher = build_int8_layers(config, state_dict, 10 ** 9, dev)
    _, student = qat_layers(config, state_dict, float_tail, act_scales, dev)
    params = _trainable(student)
    for p in params:
        p.requires_grad_(True)
    grid, activation = config.grid.grid, config.model.activation
    head_activation = _head_activation(config)

    def forward(layers, imgs):
        out = int8_forward(plan, layers, imgs, grid, activation,
                           head_activation=head_activation)
        return out if isinstance(out, tuple) else (out,)

    def batch_loss(layers, imgs, targets):
        outs = forward(layers, imgs)
        return sum(torch.mean(torch.square(o - t))
                   for o, t in zip(outs, targets)) / len(outs)

    images_u8 = np.asarray(images_u8)
    n = len(images_u8)
    batch_size = min(batch_size, n)
    order = np.random.RandomState(seed).permutation(n)
    batches = [order[i:i + batch_size]
               for i in range(0, n - batch_size + 1, batch_size)]
    if n % batch_size:
        batches.append(order[n - batch_size:])
    cached = []
    with torch.no_grad():
        for idx in batches:
            imgs = torch.from_numpy(images_u8[idx]).to(dev)
            cached.append((imgs, forward(teacher, imgs)))

    def full_loss(layers) -> float:
        with torch.no_grad():
            return float(np.mean([float(batch_loss(layers, i, t))
                                  for i, t in cached]))

    def snapshot(layers):
        return [{k: v.detach().clone() for k, v in layer.items()}
                for layer in layers]

    opt = init_opt_state("adam", params, lr)
    first_loss = full_loss(student)
    best_loss, best_student, best_step = first_loss, snapshot(student), 0
    last_loss = first_loss
    eval_every = max(1, steps // 8)
    for step in range(steps):
        imgs, targets = cached[step % len(cached)]
        grads = torch.autograd.grad(batch_loss(student, imgs, targets), params)
        apply_updates(opt, params, grads)
        if (step + 1) % eval_every == 0 or step + 1 == steps:
            last_loss = full_loss(student)
            if last_loss < best_loss:
                best_loss, best_student, best_step = (
                    last_loss, snapshot(student), step + 1)
    info = {"steps": int(steps), "lr": float(lr),
            "batch_size": int(batch_size), "first_loss": first_loss,
            "last_loss": last_loss, "best_loss": best_loss,
            "best_step": int(best_step)}
    return plan, freeze_qat_layers(best_student), info
