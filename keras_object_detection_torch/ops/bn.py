"""BatchNorm batch statistics and the fused training-mode BatchNorm
(counterpart of ``keras_object_detection_tpu/ops/pallas_bn.py``), the
``bn_mode="fused"`` path of ``models.layers.BatchNorm``.

Activations are NCHW tensors in ``channels_last`` memory, whose per-channel
statistics are column sums of the ``(M, C)`` row view (M = N*H*W), or
contiguous ``(M, C)`` tensors (a Dense layer's output), which are that view
already. A CUDA tensor goes to the hand-written kernels of
``ops/csrc/bn_stats.cu`` (one launch a call, cut as ``bn_launch_plan``
says), which take only those layouts and raise on any other; a CPU tensor
goes to the plain versions here (float32 sums over every dimension but the
channels', any layout).

Numerics follow ``flax.linen.BatchNorm`` (fast variance, float32 reductions):
``mean = s1 / M``, ``var = max(0, s2 / M - mean^2)``, the normalise in
float32, one cast to the activation dtype at the end.

Under data parallelism (a process ``group`` of more than one rank) the
kernels' ``(2, C)`` sums are summed over the group's ranks between the
kernel and the finish, and ``M`` is the global row count, so every rank
normalises with the global batch's statistics, as JAX's step over a sharded
batch does; the kernels themselves are unchanged. Every rank holds the same
number of rows (the batch divides by the data axis).

``STATS_LAUNCHES`` and ``GRAD_STATS_LAUNCHES`` count the kernel launches;
``DY_LAYOUT_COPIES`` counts the backward's ``dy`` that arrived in another
layout and had to be copied to the kernels' layout before its kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from keras_object_detection_torch.ops import _build
from keras_object_detection_torch.parallel.distributed import (all_reduce_,
                                                               world_size)

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


BN_THREADS = 256  # threads a block, as KOT_BN_THREADS in bn_stats.cu
BN_TILE_BYTES = 128  # bytes of a row one channel tile covers: a cache line
BN_BLOCKS_PER_SM = 2  # blocks the plan asks for, per SM, where the shape allows
BN_ROWS_AT_ONCE = 4  # rows a thread loads at once, at the least (K3's U)


@dataclasses.dataclass(frozen=True)
class BNPlan:
    """How ``bn_stats.cu`` cuts an ``(m, c)`` row view: ``v`` channels a
    16-byte load, blocks of ``block = (tx, ty)`` threads over ``grid = (gx,
    gy)``: ``gx`` channel tiles of ``tx * v`` channels, ``gy`` row blocks of
    ``rows_per_block`` rows. Where ``gy > 1`` each block writes one partial
    row of ``stride`` floats (the tile's two sums, padded to a float4) into
    ``scratch_floats`` of scratch, and tile ``i`` uses ticket counter
    ``i``."""

    v: int
    block: Tuple[int, int]
    grid: Tuple[int, int]
    rows_per_block: int
    stride: int
    scratch_floats: int


@functools.lru_cache(maxsize=4096)
def bn_launch_plan(m: int, c: int, itemsize: int, sms: int,
                   aligned: bool = True) -> BNPlan:
    """The launch plan of K2/K3 for ``m`` rows of ``c`` channels of
    ``itemsize`` bytes on a card of ``sms`` SMs; ``aligned``: every input's
    data pointer is 16-byte aligned.

    A tile is one 128-byte run of a row: ``tx`` threads of ``v`` channels,
    ``tx`` a power of two up to 32 (a warp spans whole rows of the tile),
    fewer where ``c`` is narrower; or a whole row of up to 32 threads where
    128-byte tiles would cut a row whose length is no multiple of 64 bytes
    (144 bf16 channels: 288 bytes). ``ty = 256 // tx`` threads stride over
    the rows. The row blocks per tile are chosen so the grid holds at least
    ``BN_BLOCKS_PER_SM * sms`` blocks wherever the rows allow each thread
    one row. Where the tiles alone fill the card, or where they cannot be
    filled so and a tile's rows fit in one round of loads (at most 4 a
    thread, with ``ty`` cut to the fewest whole warps that allow it), a
    block takes all ``m`` rows and there are no partials."""
    vec = 16 // itemsize
    v = vec if aligned and c % vec == 0 else 1
    groups = c // v
    tx = min(1 << (groups - 1).bit_length(), 32,
             max(1, BN_TILE_BYTES // (itemsize * v)))
    if tx < groups <= 32 and c * itemsize % 64:
        # tiles cut inside a row whose length is no multiple of 64 bytes
        # would share the 64-byte pieces at their borders: a whole row a tile
        tx = groups
    ty = BN_THREADS // tx
    gx = -(-groups // tx)
    target = BN_BLOCKS_PER_SM * sms
    few = m * groups < target * BN_THREADS  # too few for a row a thread
    if gx >= target or (few and m <= BN_ROWS_AT_ONCE * ty):
        if m <= BN_ROWS_AT_ONCE * ty:
            need = -(-m // BN_ROWS_AT_ONCE)
            ty = min(ty, max(1 << (need - 1).bit_length(), 32 // tx))
        rows, gy = m, 1
    else:
        rows = ty * max(1, (m * gx) // (target * ty))
        gy = -(-m // rows)
    stride = -(-2 * tx * v // 4) * 4
    return BNPlan(v=v, block=(tx, ty), grid=(gx, gy), rows_per_block=rows,
                  stride=stride, scratch_floats=gx * gy * stride if gy > 1 else 0)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("bn_stats")
    # partials, n_partials, tickets, n_tickets, out, m, c, dtype, v, tx, ty,
    # gx, gy, rows, stream
    tail = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 7 + [
            ctypes.c_longlong, ctypes.c_void_p]
    lib.kot_bn_stats.argtypes = [ctypes.c_void_p] + tail
    lib.kot_bn_stats.restype = ctypes.c_int
    lib.kot_bn_grad_stats.argtypes = [ctypes.c_void_p] * 4 + tail
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


_TICKETS: Dict[int, torch.Tensor] = {}


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device: torch.device) -> torch.Tensor:
    """The kernels' per-tile ticket counters on ``device``: the plan uses at
    most ``BN_BLOCKS_PER_SM * SMs`` of them, made at the first call and
    kept, so that a CUDA graph captured later replays on the same counters.
    The kernel leaves each at 0 after every launch. One stream at a time may
    use them: two launches in flight at once on one card would share them."""
    tickets = _TICKETS.get(device.index)
    if tickets is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the BN kernels make their ticket counters at "
                               "their first call on a device; make that call "
                               "before capturing a CUDA graph")
        tickets = torch.zeros(BN_BLOCKS_PER_SM * _sm_count(device.index),
                              dtype=torch.int32, device=device)
        torch.cuda.synchronize(device)  # the zeros land before any stream reads them
        _TICKETS[device.index] = tickets
    return tickets


def _launch(fn, what: str, inputs, args, x: torch.Tensor) -> torch.Tensor:
    """``fn(*inputs, *args, partials, its floats, tickets, their count, out,
    m, c, dtype, plan..., stream)`` on ``x``'s device and current stream
    (``_build.launch``); returns ``out``. A negative code is a plan or
    scratch the kernel refuses (ValueError), a positive one a CUDA error
    (RuntimeError)."""
    c = x.shape[1]
    m = x.numel() // c
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    if m == 0:
        return out.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in inputs)
    plan = bn_launch_plan(m, c, x.element_size(), _sm_count(x.device.index),
                          aligned)
    tickets = _tickets(x.device)
    partials = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                            device=x.device) if plan.scratch_floats else None)
    err = _build.launch(fn, x.device, *[t.data_ptr() for t in inputs], *args,
                        partials.data_ptr() if partials is not None else None,
                        plan.scratch_floats, tickets.data_ptr(), tickets.numel(),
                        out.data_ptr(), m, c, _DTYPE_CODES[x.dtype], plan.v,
                        *plan.block, *plan.grid, plan.rows_per_block)
    if err:
        msg = f"{what}: " + _library().kot_bn_error_string(err).decode()
        raise (ValueError if err < 0 else RuntimeError)(msg)
    return out


def cuda_bn_stats_sums(x: torch.Tensor) -> torch.Tensor:
    """K2 on the card, one launch: ``bn_stats_sums_plain`` of a
    channels_last tensor, the same bits on every call."""
    global STATS_LAUNCHES
    _check("x", x)
    out = _launch(_library().kot_bn_stats, "BN statistics kernel", (x,), (), x)
    STATS_LAUNCHES += x.numel() > 0
    return out


def cuda_bn_grad_sums(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor) -> torch.Tensor:
    """K3 on the card, one launch: ``bn_grad_sums_plain`` of channels_last
    tensors, the same bits on every call."""
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
    out = _launch(_library().kot_bn_grad_stats, "BN gradient statistics kernel",
                  (dy, x), (mean.data_ptr(), rstd.data_ptr()), x)
    GRAD_STATS_LAUNCHES += x.numel() > 0
    return out


def _route(x: torch.Tensor, kernel, plain):
    if x.is_cuda:
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no BN statistics for device {x.device}")


def bn_batch_stats(x: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel float32 ``(mean, var)`` of an NCHW or ``(M, C)`` tensor;
    ``var = max(0, E[x^2] - E[x]^2)`` (flax's fast variance); over the
    ranks of ``group`` together where it has more than one."""
    sums = all_reduce_(_route(x, cuda_bn_stats_sums, bn_stats_sums_plain)(x),
                       group)
    m = x.numel() // x.shape[1] * world_size(group)
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
    in torch; ``d scale = s2``, ``d bias = s1``. Over a ``group`` of ranks
    both kernels' sums are summed over the ranks before the finish and
    ``M`` counts every rank's rows; ``d scale`` and ``d bias`` stay this
    rank's own sums, which the step's gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group=None):
        ctx.group = group
        mean, var = bn_batch_stats(x, group)
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
        d_scale, d_bias = s2, s1
        if world_size(ctx.group) > 1:
            s1, s2 = all_reduce_(torch.stack([s1, s2]), ctx.group)
        m = x.numel() // x.shape[1] * world_size(ctx.group)
        coef = per_channel(scale.to(torch.float32) * rstd, x)
        xhat = (x.to(torch.float32) - per_channel(mean, x)) * per_channel(rstd, x)
        dx = (coef * (dy.to(torch.float32) - per_channel(s1 / m, x)
                      - xhat * per_channel(s2 / m, x))).to(x.dtype)
        return (dx, d_scale.to(scale.dtype), d_bias.to(scale.dtype), None,
                None)


def fused_bn_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``FusedBNTrain.apply``: ``(y, mean, var)``, the statistics over the
    ranks of ``group`` where it has more than one."""
    return FusedBNTrain.apply(x, scale, bias, eps, group)
