"""BatchNorm batch statistics and the fused training-mode BatchNorm
(counterpart of ``keras_object_detection_tpu/ops/pallas_bn.py``), the
``bn_mode="fused"`` path of ``models.layers.BatchNorm``.

Activations are NCHW tensors in ``channels_last`` memory, whose per-channel
statistics are column sums of the ``(M, C)`` row view (M = N*H*W), or
contiguous ``(M, C)`` tensors (a Dense layer's output), which are that view
already. A CUDA tensor goes to the hand-written kernels of
``ops/csrc/bn_stats.cu``, which take only those layouts and raise on any
other; a CPU tensor goes to the plain versions here (float32 sums over every
dimension but the channels', any layout).

Numerics follow ``flax.linen.BatchNorm`` (fast variance, float32 reductions):
``mean = s1 / M``, ``var = max(0, s2 / M - mean^2)``, the normalise in
float32, one cast to the activation dtype at the end.

``STATS_LAUNCHES`` and ``GRAD_STATS_LAUNCHES`` count the kernel launches;
``DY_LAYOUT_COPIES`` counts the backward's ``dy`` that arrived in another
layout and had to be copied to the kernels' layout before its kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

STATS_LAUNCHES = 0
GRAD_STATS_LAUNCHES = 0
DY_LAYOUT_COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # as in bn_stats.cu


def _channel_sums(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(0, 2, 3) if x.dim() == 4 else 0)


def per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(C,)`` tensor shaped to broadcast against ``x``'s channel
    dimension: ``(C, 1, 1)`` for NCHW, ``(C,)`` for ``(M, C)``."""
    return v[:, None, None] if x.dim() == 4 else v


def kernel_layout(x: torch.Tensor) -> bool:
    """Whether ``x`` is laid out as the kernels read it: an NCHW tensor in
    channels_last memory or a contiguous ``(M, C)`` tensor."""
    if x.dim() == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    return x.dim() == 2 and x.is_contiguous()


def bn_stats_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """``(2, C)`` float32 ``[sum(x), sum(x^2)]`` over every dimension but
    the channels' (N, H, W of NCHW; M of ``(M, C)``)."""
    xf = x.to(torch.float32)
    return torch.stack([_channel_sums(xf), _channel_sums(xf * xf)])


def bn_grad_sums_plain(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                       rstd: torch.Tensor) -> torch.Tensor:
    """``(2, C)`` float32 ``[sum(dy), sum(dy * xhat)]``,
    ``xhat = (x - mean) * rstd``."""
    dyf = dy.to(torch.float32)
    xhat = (x.to(torch.float32) - per_channel(mean, x)) * per_channel(rstd, x)
    return torch.stack([_channel_sums(dyf), _channel_sums(dyf * xhat)])


@functools.cache
def _library() -> ctypes.CDLL:
    from keras_object_detection_torch.ops._build import load_library

    lib = load_library("bn_stats")
    lib.kot_bn_chunks.argtypes = [ctypes.c_longlong]
    lib.kot_bn_chunks.restype = ctypes.c_int
    lib.kot_bn_stats.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kot_bn_stats.restype = ctypes.c_int
    lib.kot_bn_grad_stats.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.kot_bn_grad_stats.restype = ctypes.c_int
    lib.kot_bn_error_string.argtypes = [ctypes.c_int]
    lib.kot_bn_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"the BN kernels take CUDA tensors, {name} is on "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the BN kernels take float32 or bfloat16, {name} is "
                         f"{x.dtype}")
    if x.dim() not in (2, 4):
        raise ValueError(f"the BN kernels take NCHW or (M, C) tensors, {name} "
                         f"is {tuple(x.shape)}")
    if not kernel_layout(x):
        raise ValueError(f"the BN kernels take the (M, C) row view: NCHW in "
                         f"channels_last memory or a contiguous (M, C) tensor; "
                         f"{name} is neither")


def _workspace(lib, x: torch.Tensor) -> Tuple[int, int, torch.Tensor, torch.Tensor]:
    c = x.shape[1]
    m = x.numel() // c
    partials = torch.empty((lib.kot_bn_chunks(m), 2, c), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    return m, c, partials, out


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.kot_bn_error_string(err).decode())


def cuda_bn_stats_sums(x: torch.Tensor) -> torch.Tensor:
    """K2 on the card: ``bn_stats_sums_plain`` of a channels_last tensor."""
    global STATS_LAUNCHES
    _check("x", x)
    lib = _library()
    m, c, partials, out = _workspace(lib, x)
    if m == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        err = lib.kot_bn_stats(x.data_ptr(), partials.data_ptr(), out.data_ptr(),
                               m, c, _DTYPE_CODES[x.dtype],
                               torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "BN statistics kernel")
    STATS_LAUNCHES += 1
    return out


def cuda_bn_grad_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor) -> torch.Tensor:
    """K3 on the card: ``bn_grad_sums_plain`` of channels_last tensors."""
    global GRAD_STATS_LAUNCHES
    _check("dy", dy)
    _check("x", x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy and x differ in shape, dtype or device")
    c = x.shape[1]
    for name, v in (("mean", mean), ("rstd", rstd)):
        if (v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (C,) tensor "
                             "on x's device")
    lib = _library()
    m, c, partials, out = _workspace(lib, x)
    if m == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        err = lib.kot_bn_grad_stats(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            partials.data_ptr(), out.data_ptr(), m, c, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "BN gradient statistics kernel")
    GRAD_STATS_LAUNCHES += 1
    return out


def _route(x: torch.Tensor, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no BN statistics for device {x.device}")


def bn_batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(mean, var)`` of an NCHW or ``(M, C)`` tensor;
    ``var = max(0, E[x^2] - E[x]^2)`` (flax's fast variance)."""
    sums = _route(x, cuda_bn_stats_sums, bn_stats_sums_plain)(x)
    m = x.numel() // x.shape[1]
    mean = sums[0] / m
    var = torch.clamp_min(sums[1] / m - mean * mean, 0.0)
    return mean, var


def bn_grad_stats(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(sum(dy), sum(dy * xhat))``: the only
    reductions of the BatchNorm backward."""
    sums = _route(x, cuda_bn_grad_sums, bn_grad_sums_plain)(dy, x, mean, rstd)
    return sums[0], sums[1]


class FusedBNTrain(torch.autograd.Function):
    """Training-mode BatchNorm of an NCHW or ``(M, C)`` tensor: returns
    ``(y, mean, var)``
    (counterpart of ``fused_bn_train``). ``mean`` and ``var`` feed only the
    running statistics and take no gradient.

    Forward: the statistics kernel, then the normalise in float32 torch
    arithmetic and one cast to ``x``'s dtype. Backward: the gradient
    statistics kernel, then ``dx = scale * rstd * (dy - s1/M - xhat * s2/M)``
    in torch; ``d scale = s2``, ``d bias = s1``."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var = bn_batch_stats(x)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * scale.to(torch.float32)
        y = ((x.to(torch.float32) - per_channel(mean, x)) * per_channel(mul, x)
             + per_channel(bias.to(torch.float32), x)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        global DY_LAYOUT_COPIES
        x, scale, mean, rstd = ctx.saved_tensors
        if dy.is_cuda and not kernel_layout(dy):
            dy = dy.contiguous(memory_format=torch.channels_last
                               if dy.dim() == 4 else torch.contiguous_format)
            DY_LAYOUT_COPIES += 1
        s1, s2 = bn_grad_stats(dy, x, mean, rstd)
        m = x.numel() // x.shape[1]
        coef = per_channel(scale.to(torch.float32) * rstd, x)
        xhat = (x.to(torch.float32) - per_channel(mean, x)) * per_channel(rstd, x)
        dx = (coef * (dy.to(torch.float32) - per_channel(s1 / m, x)
                      - xhat * per_channel(s2 / m, x))).to(x.dtype)
        return dx, s2.to(scale.dtype), s1.to(scale.dtype), None


def fused_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``FusedBNTrain.apply``: ``(y, mean, var)``."""
    return FusedBNTrain.apply(x, scale, bias, eps)
