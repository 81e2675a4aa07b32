"""The port's BatchNorm in every ``bn_mode`` of the JAX package against its
counterpart there, on NCHW and on the 2-D ``(B, C)`` input of the GAP dense
head's BatchNorm:

- ``fused``: ``ops.bn``'s plain versions (what a CPU tensor takes) against
  ``ops/pallas_bn.py``'s ``fused_bn_train`` in interpret mode;
- ``mxu``: ``MxuBNTrain`` against ``ops/mxu_bn.py``'s ``mxu_bn_train``;
- ``flax@N``: against ``SubsetStatsBatchNorm``;
- ``flax``: against ``flax.linen.BatchNorm``;

each in training mode (output, gradients of ``sum(y * w)``, the running
statistics after one update at momentum 0.99 and at MobileNetV2's 0.999)
and in eval mode. Tolerances: float32 1e-5 (sums in another order), bf16
outputs one bf16 rounding apart (2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.models.layers import make_batch_norm
from keras_object_detection_torch.models.layers import BatchNorm, relu6
from keras_object_detection_torch.ops import bn as tbn

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(6, 5, 6, 24), (16, 96)]  # NHWC, and a Dense output


def to_port(x: np.ndarray, dtype: str) -> torch.Tensor:
    """NHWC (or 2-D) numbers -> the port's NCHW (or 2-D) tensor."""
    t = torch.from_numpy(np.array(x, np.float32)).to(TDT[dtype])
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def from_port(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _inputs(shape, dtype, seed=4):
    c = shape[-1]
    rng = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rng.randn(*shape) * 2 + 0.5, JDT[dtype])
                   .astype(jnp.float32))
    w = rng.randn(*shape).astype(np.float32)
    params = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
              "bias": rng.randn(c).astype(np.float32)}
    stats = {"mean": rng.randn(c).astype(np.float32),
             "var": (rng.rand(c) + 0.5).astype(np.float32)}
    return x, w, params, stats


def _jax_bn(bn_mode, x, w, params, stats, dtype, train, momentum):
    bn = make_batch_norm(bn_mode, use_running_average=not train,
                         momentum=momentum, epsilon=1e-3, dtype=JDT[dtype])
    if bn_mode == "fused":
        bn = bn.clone(interpret=True)

    def loss(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd["batch_stats"])

    (_, (y, new)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                              has_aux=True)(
        jnp.asarray(x, JDT[dtype]), params["scale"], params["bias"])
    return y, new, grads


def _port_bn(bn_mode, x, w, params, stats, dtype, train, momentum):
    layer = BatchNorm(x.shape[-1], bn_mode=bn_mode, momentum=momentum)
    layer.train(train)
    layer.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    xt = to_port(x, dtype).requires_grad_(True)
    y = layer(xt)
    (y.float() * to_port(w, "float32")).sum().backward()
    return layer, y, [xt.grad, layer.weight.grad, layer.bias.grad]


@pytest.mark.parametrize("bn_mode", ["flax", "fused", "mxu", "flax@4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("train,momentum", [(True, 0.99), (True, 0.999),
                                            (False, 0.99)])
def test_batchnorm_modes_match_jax(bn_mode, dtype, shape, train, momentum):
    x, w, params, stats = _inputs(shape, dtype)
    y_want, stats_want, g_want = _jax_bn(bn_mode, x, w, params, stats, dtype,
                                         train, momentum)
    layer, y, grads = _port_bn(bn_mode, x, w, params, stats, dtype, train,
                               momentum)
    tol = 2 ** -7 if dtype == "bfloat16" else 1e-5
    assert y.dtype == TDT[dtype] and y.shape == to_port(x, dtype).shape
    np.testing.assert_allclose(from_port(y),
                               np.asarray(y_want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    want_mean = stats_want.get("mean", stats["mean"])
    want_var = stats_want.get("var", stats["var"])
    np.testing.assert_allclose(layer.running_mean.numpy(), want_mean,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(layer.running_var.numpy(), want_var,
                               rtol=1e-6, atol=1e-7)
    if train:
        assert not np.array_equal(layer.running_var.numpy(), stats["var"])
    for got, want in zip([from_port(grads[0]), grads[1].numpy(),
                          grads[2].numpy()], g_want):
        want = np.asarray(want.astype(jnp.float32))
        ref = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(got / ref, want / ref, rtol=tol, atol=tol)


def test_subset_statistics_use_the_first_images_only():
    """flax@N normalises every image with the statistics of the first N:
    changing the other images changes neither the statistics nor the first
    images' outputs."""
    x = torch.randn(6, 8, generator=torch.Generator().manual_seed(0))
    outs = []
    for tail in (0.0, 100.0):
        layer = BatchNorm(8, bn_mode="flax@2").train()
        xx = x.clone()
        xx[2:] += tail
        outs.append((layer(xx)[:2], layer.running_mean.clone()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=0)


def test_fused_2d_route_matches_pallas_bn_stats():
    """The kernels' 2-D route on the CPU (a contiguous (M, C) tensor is
    already their row view) against ``pallas_bn`` in interpret mode."""
    from keras_object_detection_tpu.ops import pallas_bn

    rng = np.random.RandomState(2)
    x = (rng.randn(64, 160) * 3 + 1).astype(np.float32)
    dy = rng.randn(64, 160).astype(np.float32)
    want_mean, want_var = pallas_bn.bn_batch_stats(jnp.asarray(x), interpret=True)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    assert tbn.kernel_layout(xt) and not tbn.kernel_layout(xt.t())
    mean, var = tbn.bn_batch_stats(xt)
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=1e-5, atol=1e-6)
    rstd = jax.lax.rsqrt(want_var + 1e-3)
    w1, w2 = pallas_bn.bn_grad_stats(jnp.asarray(dy), jnp.asarray(x), want_mean,
                                     rstd, interpret=True)
    s1, s2 = tbn.bn_grad_stats(dyt, xt, torch.from_numpy(np.array(want_mean)),
                               torch.from_numpy(np.array(rstd)))
    np.testing.assert_allclose(s1.numpy(), w1, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), w2, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        tbn.cuda_bn_stats_sums(xt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu6_gradient_is_zero_at_both_ties(dtype):
    """jax.nn.relu6 takes gradient 0 at x = 0 and at x = 6, and 1 strictly
    between; the port's relu6 (hardtanh's backward) does the same."""
    x = np.array([-1.0, 0.0, 1e-3, 3.0, 6.0 - 2 ** -5, 6.0, 7.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jax.nn.relu6(v).astype(jnp.float32)))(
        jnp.asarray(x, JDT[dtype]))
    xt = torch.tensor(x, dtype=TDT[dtype], requires_grad=True)
    y = relu6(xt)
    y.float().sum().backward()
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  [0, 0, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(
        y.detach().float().numpy(),
        np.asarray(jax.nn.relu6(jnp.asarray(x, JDT[dtype])).astype(jnp.float32)))

