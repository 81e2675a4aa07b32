"""Conv and Dense building blocks (counterpart of
``keras_object_detection_tpu/models/layers.py`` ``ConvBlock``,
``make_batch_norm`` in all its modes, ``max_pool_2x2``, and flax's
``nn.Conv``, ``nn.Dense``, ``nn.Dropout`` and ``relu6`` as the JAX models use
them).

Tensors run NCHW (in ``channels_last`` memory where the caller asks for it).
Parameters and BN statistics are float32; the conv runs in the block's
compute dtype, as flax's ``nn.Conv(dtype=...)`` casts its kernel and bias.

``Conv2d``, ``Dense``, ``BatchNorm`` and ``ConvBlock`` take a column shard
of tensor parallelism (``shard``, set by ``parallel.tensor.shard_state``):
the layer then computes its shard of the output features (module docstring
of ``parallel/tensor.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from keras_object_detection_torch.config import check_bn_mode
from keras_object_detection_torch.ops.bn import (_channel_sums, fused_bn_train,
                                                 per_channel)
from keras_object_detection_torch.parallel.distributed import (
    all_gather_dim, all_reduce_, all_reduce_sum, copy_in, gather_channels,
    rank_of, world_size)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) zero padding of XLA's ``"SAME"``: the output has
    ``ceil(size / stride)`` positions and the low side gets the smaller half,
    so at stride 2 an odd total pads 0 low and 1 high."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class MxuBNTrain(torch.autograd.Function):
    """Training-mode BatchNorm of ``bn_mode="mxu"`` (counterpart of
    ``keras_object_detection_tpu/ops/mxu_bn.py`` ``mxu_bn_train``, which is
    XLA, not Pallas): the same arithmetic as float32 column sums in plain
    torch. Forward: ``mean = sum(x) / M``, ``var = max(0, sum(x^2) / M -
    mean^2)``. Backward: ``s1 = sum(dy)``, ``s2 = (sum(dy * x) - mean * s1) *
    rstd``, ``dx = scale * rstd * (dy - s1/M - xhat * s2/M)``; ``d scale =
    s2``, ``d bias = s1``. ``mean`` and ``var`` take no gradient. Over a
    ``group`` of ranks the column sums of both passes are summed over the
    ranks and ``M`` counts every rank's rows (as ``FusedBNTrain``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, group=None):
        ctx.group = group
        xf = x.to(torch.float32)
        m = x.numel() // x.shape[1] * world_size(group)
        s1, s2 = all_reduce_(torch.stack(
            [_channel_sums(xf), _channel_sums(xf * xf)]), group)
        mean = s1 / m
        var = torch.clamp_min(s2 / m - mean * mean, 0.0)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * scale.to(torch.float32)
        y = ((xf - per_channel(mean, x)) * per_channel(mul, x)
             + per_channel(bias.to(torch.float32), x)).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd = ctx.saved_tensors
        xf, dyf = x.to(torch.float32), dy.to(torch.float32)
        m = x.numel() // x.shape[1] * world_size(ctx.group)
        s1 = _channel_sums(dyf)
        sdx = _channel_sums(dyf * xf)
        # this rank's d scale and d bias, summed with the other gradients
        d_scale, d_bias = (sdx - mean * s1) * rstd, s1
        s1, sdx = all_reduce_(torch.stack([s1, sdx]), ctx.group)
        s2 = (sdx - mean * s1) * rstd
        coef = per_channel(scale.to(torch.float32) * rstd, x)
        xhat = (xf - per_channel(mean, x)) * per_channel(rstd, x)
        dx = (coef * (dyf - per_channel(s1 / m, x)
                      - xhat * per_channel(s2 / m, x))).to(x.dtype)
        return dx, d_scale.to(scale.dtype), d_bias.to(scale.dtype), None, None


class BatchNorm(nn.Module):
    """BatchNorm in the arithmetic of the installed flax
    (``flax.linen.normalization``): float32 statistics, the normalise
    ``y = (x.float() - mean) * (rsqrt(var + eps) * scale) + bias`` in float32
    and one cast to the input dtype at the end. The input is NCHW or
    ``(B, C)`` (a Dense layer's output).

    In eval mode it normalises with the running statistics. In training
    mode it normalises with the batch's, computed by ``bn_mode``:

    - ``"flax"``: plain torch autograd; ``mean = E[x]`` and the fast
      variance ``var = max(0, E[x^2] - E[x]^2)``;
    - ``"fused"``: ``ops.bn.FusedBNTrain``, the hand-written statistics
      kernels on the GPU;
    - ``"mxu"``: ``MxuBNTrain``, float32 column sums in plain torch;
    - ``"flax@N"``: the statistics of the first N images only
      (``SubsetStatsBatchNorm``: ``var = E[x^2] - E[x]^2``, unclamped),
      every image normalised with them; plain torch autograd.

    All then update the running statistics as flax does, without gradient:
    ``r = momentum * r + (1 - momentum) * batch_stat`` with the biased
    variance (not ``nn.BatchNorm2d``'s unbiased one). ``momentum`` is 0.99
    (Keras's, as the JAX ConvBlock sets it) or MobileNetV2's 0.999. A
    forward that ``remat`` recomputes in the backward skips that update
    (``updates_running_stats`` is False then), so a step updates them
    once.

    ``group`` (set by ``data_group``): the process group of data
    parallelism. With more than one rank the batch statistics are the
    global batch's: every mode sums its per-channel sums over the ranks
    (``flax`` and ``flax@N`` through ``all_reduce_sum``, which carries the
    gradient), and ``flax@N`` takes the first N rows of the global batch,
    the ranks' row blocks in rank order. The running statistics then agree
    on every rank.

    ``shard`` (a ``parallel.tensor.ColumnShard``, set by
    ``ConvBlock.place``): the input holds this rank's channel shard of a
    column-parallel conv. The parameters and running statistics stay whole
    (replicated, as in JAX); the layer normalises with its slice of them,
    and the running statistics take every rank's new slice, gathered over
    the model group."""

    def __init__(self, features: int, eps: float = 1e-3, bn_mode: str = "flax",
                 momentum: float = 0.99):
        super().__init__()
        check_bn_mode(bn_mode)
        self.eps = eps
        self.bn_mode = bn_mode
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.updates_running_stats = True
        self.group = None
        self.shard = None

    def _slice(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a per-channel vector), or its slice of this rank's
        channel shard."""
        return t if self.shard is None else self.shard.cut(t)

    def _global_stats(self, x: torch.Tensor):
        """``(mean, var)`` of the global batch over ``group``'s ranks (this
        process's batch where there is one), in the arithmetic of ``flax``
        (clamped) or ``flax@N`` (unclamped as SubsetStatsBatchNorm computes
        it, the first N global rows)."""
        world, rank = world_size(self.group), rank_of(self.group)
        rows, pixels = x.shape[0], x[0].numel() // x.shape[1]
        xf = x.float()
        if self.bn_mode == "flax":
            n = rows * world
        else:
            n = min(int(self.bn_mode[len("flax@"):]), rows * world)
            xf = xf[:min(max(n - rank * rows, 0), rows)]
        sums = torch.stack([_channel_sums(xf), _channel_sums(xf * xf)])
        s1, s2 = all_reduce_sum(sums, self.group) / (n * pixels)
        var = s2 - s1 * s1
        if self.bn_mode == "flax":
            var = torch.maximum(var, torch.zeros_like(s1))
        return s1, var

    def _normalize(self, x, mean, var):
        mul = torch.rsqrt(var + self.eps) * self._slice(self.weight)
        y = (x.float() - per_channel(mean, x)) * per_channel(mul, x)
        y = y + per_channel(self._slice(self.bias), x)
        return y.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._normalize(x, self._slice(self.running_mean),
                                   self._slice(self.running_var))
        weight, bias = self._slice(self.weight), self._slice(self.bias)
        if self.bn_mode == "fused":
            y, mean, var = fused_bn_train(x, weight, bias, self.eps,
                                          self.group)
        elif self.bn_mode == "mxu":
            y, mean, var = MxuBNTrain.apply(x, weight, bias, self.eps,
                                            self.group)
        else:
            mean, var = self._global_stats(x)
            y = self._normalize(x, mean, var)
        if not self.updates_running_stats:
            return y
        with torch.no_grad():
            if self.shard is not None:
                mean, var = all_gather_dim(
                    torch.stack([mean, var]), 1, self.shard.group).unbind()
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


@contextlib.contextmanager
def data_group(module: nn.Module, group):
    """The BatchNorms of ``module`` compute their training statistics over
    the ranks of ``group`` (the process group of data parallelism; ``None``:
    this process's batch alone) inside the block; restored after."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [bn.group for bn in bns]
    for bn in bns:
        bn.group = group
    try:
        yield
    finally:
        for bn, g in zip(bns, before):
            bn.group = g


@contextlib.contextmanager
def _recompute(recompute_context, module: nn.Module):
    """``recompute_context``, with the BatchNorms of ``module`` not updating
    their running statistics (restored however the recompute ends: torch
    stops a recompute early once it has what the backward needs)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.updates_running_stats = False
    try:
        with recompute_context:
            yield
    finally:
        for bn in bns:
            bn.updates_running_stats = True


def remat(fn, module: nn.Module, policy: str, *args):
    """``fn(*args)`` whose activations the backward recomputes
    (``jax.checkpoint`` as the JAX step applies it under
    ``ModelConfig.remat``), through ``torch.utils.checkpoint``. ``policy``
    ``"full"`` keeps only ``args``; ``"dots"`` (``dots_saveable``) also
    keeps the outputs of convolutions and matrix products and recomputes
    the BatchNorm, activation and pooling around them. ``module`` holds the
    BatchNorms that ``fn`` runs (the model's: no other forward runs during
    a backward): their recompute does not update the running statistics
    again. Values are those of ``fn(*args)``: the recompute runs
    the same operations on the same inputs (the forward draws nothing from
    torch's global generators, so their state is not kept)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    def contexts():
        if policy == "dots":
            ops = torch.ops.aten
            forward, recompute = create_selective_checkpoint_contexts(
                [ops.convolution.default, ops.mm.default, ops.addmm.default])
        else:
            forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        return forward, _recompute(recompute, module)

    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts,
                      preserve_rng_state=False)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal()``: a normal truncated at
    two standard deviations and scaled so that the result's standard
    deviation is ``1 / sqrt(fan_in)``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv2d(nn.Module):
    """Conv parameters, OIHW weight and optional bias, initialised as flax's
    ``nn.Conv`` by default: ``lecun_normal_`` weight from an explicit
    generator, fan_in = (in_channels / groups) * k * k as flax's grouped
    kernel ``(k, k, in / groups, out)`` counts it, and zero bias. The conv
    runs in the input's dtype, as flax's ``nn.Conv(dtype=...)`` casts its
    kernel and bias. ``groups`` is flax's ``feature_group_count``.

    ``shard`` (tensor parallelism): ``weight`` is this rank's shard of the
    output channels; the conv takes its whole input through ``copy_in``,
    adds its slice of the whole bias and, with ``gather`` (a ``ConvBlock``
    clears it to gather after its BatchNorm and activation), gathers the
    ranks' channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 generator: torch.Generator, bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.groups = groups
        weight = torch.empty(out_channels, in_channels // groups, kernel_size,
                             kernel_size)
        self.weight = nn.Parameter(lecun_normal_(weight, weight[0].numel(),
                                                 generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.shard = None
        self.gather = True

    def forward(self, x: torch.Tensor, stride: int = 1,
                padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
        bias = self.bias
        if self.shard is not None:
            x = copy_in(x, self.shard.group)
            bias = None if bias is None else self.shard.cut(bias)
        # the bias is added after the conv's output is rounded to x.dtype,
        # as flax does; a bias fused into the conv rounds once, and in
        # bfloat16 that drifts from the JAX forward by ~3x more
        y = F.conv2d(x, self.weight.to(x.dtype), None, stride, padding,
                     groups=self.groups)
        if bias is not None:
            y = y + bias.to(x.dtype)[:, None, None]
        if self.shard is not None and self.gather:
            y = gather_channels(y, 1, self.shard.group)
        return y


def conv_same(conv: Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``conv`` with XLA's ``"SAME"`` padding (see ``same_padding``): the
    conv's own symmetric padding where low and high agree, else an explicit
    pad first."""
    k = conv.weight.shape[-1]
    ph = same_padding(x.shape[2], k, stride)
    pw = same_padding(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return conv(x, stride, (ph[0], pw[0]))
    return conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), stride)


class Dense(nn.Module):
    """flax's ``nn.Dense``: ``(out, in)`` weight drawn as flax's default
    ``lecun_normal`` (fan_in = in) from an explicit generator and zero bias.
    Input and weight are cast to ``dtype`` and the bias is added after the
    product is rounded to it, as ``Conv2d`` does. ``shard`` (tensor
    parallelism): as ``Conv2d``'s, the output features gathered at once."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        weight = torch.empty(out_features, in_features)
        self.weight = nn.Parameter(lecun_normal_(weight, in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.shard = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, bias = x.to(self.dtype), self.bias
        if self.shard is not None:
            x, bias = copy_in(x, self.shard.group), self.shard.cut(bias)
        y = F.linear(x, self.weight.to(self.dtype)) + bias.to(self.dtype)
        if self.shard is not None:
            y = gather_channels(y, -1, self.shard.group)
        return y


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in training mode ``where(keep, x / (1 - rate),
    0)``. ``keep`` is an explicit boolean mask of ``x``'s shape, or is drawn
    as ``uniform < 1 - rate`` from an explicit CPU ``torch.Generator``;
    torch's global generator is never used, and training mode without
    either raises. In eval mode it is the identity."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, shape, generator: torch.Generator) -> torch.Tensor:
        """A keep mask of ``shape`` on the CPU: ``uniform < 1 - rate``."""
        return torch.rand(shape, generator=generator) < 1.0 - self.rate

    def forward(self, x: torch.Tensor,
                rng: Union[torch.Tensor, torch.Generator, None] = None
                ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if isinstance(rng, torch.Generator):
            rng = self.draw(x.shape, rng)
        if not isinstance(rng, torch.Tensor):
            raise ValueError("training-mode dropout takes a keep mask or a "
                             "torch.Generator to draw one from")
        if rng.shape != x.shape:
            raise ValueError(f"dropout mask {tuple(rng.shape)} does not match "
                             f"{tuple(x.shape)}")
        keep = rng.to(x.device, torch.bool)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def relu6(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu6``: ``min(max(x, 0), 6)``, whose gradient is 0 at both
    ties (x = 0 and x = 6), as ``hardtanh``'s backward gives it."""
    return F.hardtanh(x, 0.0, 6.0)


class ConvBlock(nn.Module):
    """Zero padding -> Conv (with bias) -> BatchNorm -> ReLU / LeakyReLU(0.1).

    ``padding`` is an int (symmetric, the reference's ``ZeroPadding2D``) or
    ``"SAME"`` (XLA's rule, see ``same_padding``). A block whose conv is
    column-parallel (``place``) runs the BatchNorm and activation on its
    channel shard and gathers the channels after them."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: Union[int, str] = 0,
                 activation: str = "relu",
                 dtype: torch.dtype = torch.float32, *,
                 generator: torch.Generator, bn_mode: str = "flax"):
        super().__init__()
        if activation not in ("relu", "leaky_relu"):
            raise ValueError(f"unknown activation {activation!r}")
        if isinstance(padding, str) and padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        self.kernel_size = kernel_size
        self.strides = strides
        self.padding = padding
        self.activation = activation
        self.dtype = dtype
        self.conv = Conv2d(in_channels, filters, kernel_size, generator)
        self.bn = BatchNorm(filters, bn_mode=bn_mode)
        self.shard = None

    def place(self, shard) -> None:
        """Run column-parallel on ``shard`` (the conv's weight already cut):
        the conv and BatchNorm on the channel shard, one gather after the
        activation."""
        self.shard = self.conv.shard = self.bn.shard = shard
        self.conv.gather = False

    def forward(self, x: torch.Tensor,
                strides: Optional[int] = None) -> torch.Tensor:
        """``strides`` overrides the constructor's, for a head whose stride
        follows the incoming feature size."""
        strides = self.strides if strides is None else strides
        x = x.to(self.dtype)
        if self.padding == "SAME":
            x = conv_same(self.conv, x, strides)
        else:
            x = self.conv(x, strides, (self.padding, self.padding))
        x = self.bn(x)
        x = F.leaky_relu(x, 0.1) if self.activation == "leaky_relu" else F.relu(x)
        if self.shard is not None:
            x = gather_channels(x, 1, self.shard.group)
        return x


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool (VALID, like ``flax.linen.max_pool``)."""
    return F.max_pool2d(x, 2, 2)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """YOLOv2's reorg layer on an NCHW tensor: ``(B, C, H, W) -> (B,
    C * block**2, H / block, W / block)``, the channels ordered (block row,
    block column, C) as JAX's NHWC ``space_to_depth`` orders them, so that
    the conv after it takes converted kernels unchanged
    (``nn.PixelUnshuffle`` orders them (C, block row, block column)). The
    permutation runs on the NHWC view; the result is NCHW with
    ``channels_last`` strides."""
    b, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims ({h},{w}) not divisible by {block}")
    y = x.permute(0, 2, 3, 1).reshape(b, h // block, block, w // block, block, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                            block * block * c)
    return y.permute(0, 3, 1, 2)
