"""Lower precisions put into the reference: each rounds the input, the
weight and the output of every convolution, the tensors the configurations
hold in bfloat16. ``fp8`` (e4m3, one scale a tensor that maps its largest
magnitude to the format's largest, 448) is the control, the next precision
below bfloat16; ``bf16`` is the witness that the system's own gaps are
bfloat16's. The rounding passes the gradient straight through, so the
backward runs as in float32 on the rounded forward."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def bf16(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        q = t.to(torch.bfloat16).to(t.dtype)
    return t + (q - t).detach()
