"""The yardstick: the H100's published peaks, the model FLOPs counted from
the layers' shapes, and the least time of the system's hand-written kernels
from the bytes and operations their inputs need.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM. A share of a peak states the card's power limit beside it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def conv_shapes(cfg: dict, batch: int) -> List[Dict]:
    """Each convolution of the configured model in the order a forward runs
    them, at ``batch`` images: ``{"name", "macs", "out", "bn"}`` (``out``
    the output's ``(B, C, H, W)``, ``bn`` whether a BatchNorm follows it),
    from a forward of the reference model on PyTorch's ``meta`` device
    (shapes only)."""
    from portbench.reference.model import Conv, ConvBlock, Detector

    size = cfg["model"]["image_size"]
    with torch.device("meta"):
        model = Detector(cfg)
    shapes: List[Dict] = []

    in_block = {id(m.conv) for m in model.modules()
                if isinstance(m, ConvBlock)}

    def hook(name, bn):
        def record(module, inputs, out):
            shapes.append({"name": name, "out": tuple(out.shape), "bn": bn,
                           "macs": out.numel() * module.weight[0].numel()})
        return record

    for name, m in model.named_modules():
        if isinstance(m, Conv):
            m.register_forward_hook(hook(name, id(m) in in_block))
    model.train()
    model(torch.empty(batch, size, size, 3, device="meta"))
    return shapes


def model_flops(cfg: dict, train: bool) -> float:
    """Model FLOPs of one image: a forward is 2 MACs a product; training
    adds a weight gradient for every layer and an input gradient for every
    layer but the first (nothing recomputed)."""
    shapes = conv_shapes(cfg, 1)
    fwd = sum(2 * s["macs"] for s in shapes)
    if not train:
        return float(fwd)
    return float(3 * fwd - 2 * shapes[0]["macs"])


def _least_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3


def bn_stats_ms(out_shape: Tuple[int, ...], itemsize: int,
                grad: bool) -> float:
    """Least time of one BatchNorm-statistics launch over a ``(B, C, H,
    W)`` activation: K2 reads x once and writes the (2, C) float32 sums
    (3 operations an element); K3 reads dy and x (5 an element)."""
    elems = math.prod(out_shape)
    nbytes = elems * itemsize * (2 if grad else 1) + 2 * out_shape[1] * 4
    return _least_ms(nbytes, elems * (5 if grad else 3))


def bn_step_ms(cfg: dict, batch: int, itemsize: int) -> Tuple[float, int]:
    """``(least ms, launches)`` of one train step's K2 and K3 launches:
    one each for every BatchNorm, which follows every convolution but the
    head's last ones."""
    shapes = [s for s in conv_shapes(cfg, batch) if s["bn"]]
    ms = sum(bn_stats_ms(s["out"], itemsize, False)
             + bn_stats_ms(s["out"], itemsize, True) for s in shapes)
    return ms, 2 * len(shapes)


def nms_ms(batch: int, n: int) -> float:
    """Least time of one NMS launch over ``(batch, n, 6)`` float32 rows:
    the rows read once and written once with their (batch, n) mask; 3
    operations a comparison of a sort (n log2 n an image) and 9 a row. The
    IoU of the same-class pairs, which depends on the data, is not counted,
    so this is a floor of the least time."""
    nbytes = batch * n * 6 * 4 * 2 + batch * n
    ops = batch * (3 * n * max(1, math.ceil(math.log2(n))) + 9 * n)
    return _least_ms(nbytes, ops)
