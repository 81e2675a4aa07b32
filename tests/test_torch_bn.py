"""Parity of the port's BatchNorm with the JAX package's.

- ``ops.bn.bn_batch_stats`` / ``bn_grad_stats`` / ``FusedBNTrain`` on the
  CPU (the kernels' plain versions) against ``bn_batch_stats`` /
  ``bn_grad_stats`` / ``fused_bn_train`` of ``ops/pallas_bn.py`` in
  interpret mode, on ``tests/test_pallas_bn.py``'s cases.
- Training-mode ``models.layers.BatchNorm`` in both modes against
  ``flax.linen.BatchNorm``: output, gradients and the running-statistics
  update, in float32 and bfloat16.

The port takes NCHW tensors in channels_last memory; the JAX functions take
the same numbers as NHWC. Tolerances: float32 sums in another order, 1e-5
relative; bfloat16 outputs one bf16 rounding apart at most (2^-7).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.ops import pallas_bn
from keras_object_detection_torch.models.layers import BatchNorm
from keras_object_detection_torch.ops import bn as tbn

CASES = [
    ((4, 7, 7, 16), "float32"),
    ((2, 14, 14, 64), "bfloat16"),
    ((3, 7, 7, 192), "float32"),
    ((2, 7, 7, 24), "float32"),
    ((5, 13, 11, 32), "float32"),
]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_port(x_nhwc: np.ndarray, dtype: str) -> torch.Tensor:
    """NHWC numbers -> the port's NCHW tensor in channels_last memory."""
    t = torch.from_numpy(np.array(x_nhwc, np.float32)).to(TDT[dtype])
    return t.permute(0, 3, 1, 2)


def rounded(x: np.ndarray, dtype: str) -> np.ndarray:
    """The float32 values of ``x`` after a cast to ``dtype``."""
    return np.asarray(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype", CASES)
def test_batch_stats_match_pallas_bn(shape, dtype):
    x = rounded(np.random.RandomState(0).randn(*shape) * 3 + 1, dtype)
    want_mean, want_var = pallas_bn.bn_batch_stats(jnp.asarray(x, JDT[dtype]),
                                                   interpret=True)
    xt = to_port(x, dtype)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    mean, var = tbn.bn_batch_stats(xt)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_grad_stats_match_pallas_bn(shape, dtype):
    rng = np.random.RandomState(1)
    x = rounded(rng.randn(*shape), dtype)
    dy = rounded(rng.randn(*shape), dtype)
    jx, jdy = jnp.asarray(x, JDT[dtype]), jnp.asarray(dy, JDT[dtype])
    mean, var = pallas_bn.bn_batch_stats(jx, interpret=True)
    rstd = jax.lax.rsqrt(var + 1e-3)
    w1, w2 = pallas_bn.bn_grad_stats(jdy, jx, mean, rstd, interpret=True)
    s1, s2 = tbn.bn_grad_stats(to_port(dy, dtype), to_port(x, dtype),
                               torch.from_numpy(np.array(mean)),
                               torch.from_numpy(np.array(rstd)))
    np.testing.assert_allclose(s1.numpy(), w1, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), w2, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_fused_bn_train_value_and_grad_match_pallas_bn(shape, dtype):
    c = shape[-1]
    rng = np.random.RandomState(3)
    x = rounded(rng.randn(*shape), dtype)
    w = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)

    def jloss(x, scale, bias):
        y, _, _ = pallas_bn.fused_bn_train(x, scale, bias, 1e-3, JDT[dtype], True)
        return jnp.sum(y.astype(jnp.float32) * w)

    jx = jnp.asarray(x, JDT[dtype])
    y_want = pallas_bn.fused_bn_train(jx, scale, bias, 1e-3, JDT[dtype], True)[0]
    g_want = jax.grad(jloss, argnums=(0, 1, 2))(jx, scale, bias)

    xt = to_port(x, dtype).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = tbn.fused_bn_train(xt, st, bt, 1e-3)
    assert y.dtype == TDT[dtype] and not mean.requires_grad
    (y.float() * to_port(w, "float32")).sum().backward()

    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    grads = [xt.grad.float().permute(0, 2, 3, 1), st.grad, bt.grad]
    for got, want in zip(grads, g_want):
        want = np.asarray(want.astype(jnp.float32))
        ref = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(got.numpy() / ref, want / ref, rtol=tol,
                                   atol=tol)


def _flax_bn_step(x, scale, bias, mean0, var0, w, dtype):
    """flax.linen.BatchNorm in training mode: output, the updated running
    statistics and the gradients of sum(y * w)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                       dtype=JDT[dtype], param_dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def loss(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd["batch_stats"])

    (_, (y, new)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                              has_aux=True)(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(scale), jnp.asarray(bias))
    return y, new, grads


@pytest.mark.parametrize("bn_mode", ["flax", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 7, 7, 16), (3, 5, 6, 24)])
def test_training_batchnorm_matches_flax(bn_mode, dtype, shape):
    c = shape[-1]
    rng = np.random.RandomState(4)
    x = rounded(rng.randn(*shape) * 2 + 0.5, dtype)
    w = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = (rng.rand(c) + 0.5).astype(np.float32)
    y_want, stats_want, g_want = _flax_bn_step(x, scale, bias, mean0, var0, w,
                                               dtype)

    layer = BatchNorm(c, bn_mode=bn_mode).train()
    layer.load_state_dict({"weight": torch.from_numpy(scale),
                           "bias": torch.from_numpy(bias),
                           "running_mean": torch.from_numpy(mean0),
                           "running_var": torch.from_numpy(var0)})
    xt = to_port(x, dtype).requires_grad_(True)
    y = layer(xt)
    (y.float() * to_port(w, "float32")).sum().backward()

    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    assert y.dtype == TDT[dtype]
    np.testing.assert_allclose(y.detach().float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(y_want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(layer.running_mean.numpy(), stats_want["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(layer.running_var.numpy(), stats_want["var"],
                               rtol=1e-6, atol=1e-7)
    grads = [xt.grad.float().permute(0, 2, 3, 1), layer.weight.grad,
             layer.bias.grad]
    for got, want in zip(grads, g_want):
        want = np.asarray(want.astype(jnp.float32))
        ref = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(got.numpy() / ref, want / ref, rtol=tol,
                                   atol=tol)


def test_running_variance_is_the_biased_batch_variance():
    """flax's update, not nn.BatchNorm2d's: the running variance moves
    towards the biased variance of the batch."""
    x = torch.randn(8, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    layer = BatchNorm(3).train()
    layer(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(layer.running_var, 0.99 + 0.01 * biased,
                               rtol=1e-6, atol=1e-7)


def test_cpu_tensors_use_the_plain_versions():
    x = torch.randn(2, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    before = (tbn.STATS_LAUNCHES, tbn.GRAD_STATS_LAUNCHES)
    y, _, _ = tbn.fused_bn_train(x, torch.ones(8, requires_grad=True),
                                 torch.zeros(8), 1e-3)
    y.sum().backward()
    assert (tbn.STATS_LAUNCHES, tbn.GRAD_STATS_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        tbn.cuda_bn_stats_sums(x.detach())
