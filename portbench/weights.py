"""The weights both sides run, made on the device from the seed.

Every convolution's weight is flax's ``lecun_normal`` (a normal truncated at
two standard deviations, scaled to a standard deviation of ``1 /
sqrt(fan_in)``), drawn as one standard truncated normal over all weights
in a few large calls and cut into leaves. Biases are 0, BatchNorm scales 1
and shifts ``BN_SHIFT``: shifted so, about 98 % of activations lie on the
linear side of their ReLU. With shifts of 0 a random network of 24 to 75
conv blocks is chaotic: rounding to bfloat16 grows by a factor of about
1.12 a block, to a third of YOLOv1's head input, where a trained
detector's does not grow so. The head's
last convolutions, which read those shifted activations, are centred
filter by filter (each output's weights sum to 0, so its response to the
shift is 0) and scaled by ``head_gain`` (the configuration file's), which
sets how many candidates pass the confidence threshold; ``head_bias``
(``{"channels", "value"}``, where given) sets their bias at those output
channels. For serving, the BatchNorms' running statistics are those of
one batch (``calibrate``), as a trained model's describe its inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from portbench.reference.model import BatchNorm, Conv, Detector

_TRUNC_STD = 0.87962566103423978  # std of a unit normal cut at +-2
BN_SHIFT = 2.0


def make(cfg: dict, seed: int, device, head_gain: float = 1.0,
         head_bias: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """``state_dict`` of the configured model on ``device``."""
    with torch.device(device):
        model = Detector(cfg)
    convs = {name: m for name, m in model.named_modules()
             if isinstance(m, Conv)}
    total = sum(m.weight.numel() for m in convs.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    heads = {n for n in convs
             if n == "head.conv" or n.startswith("head.convs.")}
    at = 0
    with torch.no_grad():
        for name, m in convs.items():
            w = m.weight
            std = 1.0 / math.sqrt(w[0].numel()) / _TRUNC_STD
            w.copy_(flat[at:at + w.numel()].view_as(w) * std)
            at += w.numel()
            m.bias.zero_()
            if name in heads:
                w.sub_(w.mean(dim=(1, 2, 3), keepdim=True)).mul_(head_gain)
                if head_bias:
                    m.bias[list(head_bias["channels"])] = head_bias["value"]
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                m.bias.fill_(BN_SHIFT)
    return {k: v.detach() for k, v in model.state_dict().items()}


@torch.no_grad()
def calibrate(cfg: dict, weights: Dict[str, torch.Tensor],
              images_u8: torch.Tensor) -> None:
    """Set the running statistics in ``weights`` to those of one
    training-mode forward of the reference over ``images_u8``."""
    from portbench.reference.steps import exact

    with torch.device(images_u8.device):
        model = Detector(cfg)
    model.load_state_dict(weights)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 0.0
    with exact():
        model.train()(images_u8.float() * (1.0 / 255.0))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            weights[k].copy_(v)
