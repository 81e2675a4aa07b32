"""The port's QAT (``export/qat.py``) against the JAX package's on the CPU:
the fake-quant grids and their straight-through gradients, the student and
its freeze, and a short ``qat_finetune``.

Exact: the fake-quantized kernels and activations against JAX's op by op,
and the frozen layers. ``qat_finetune``'s losses to 1e-5 relative (seen:
1.2e-6): JAX runs the fine-tune as jitted programs (XLA fuses the
fake-quant arithmetic, so a value one ulp off before a ``round`` may land
on the next grid point) and optax's adam rounds ``1 - b1`` from float64,
where the port's adam (``train/optim.py``) subtracts in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.export import int8_serving as J
from keras_object_detection_tpu.export import qat as JQAT
from keras_object_detection_torch.export import int8_serving as T
from keras_object_detection_torch.export import qat as TQAT

from test_torch_int8 import (PLANS, assert_layers_equal, images, port,  # noqa: F401
                             res_micro, variables)


def test_fake_quant_kernel_is_jax_s_and_on_the_serving_grid():
    rng = np.random.RandomState(0)
    w = rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel: the 1e-12 floor
    want = np.asarray(JQAT.fake_quant_kernel(jnp.asarray(w)))
    w_ohwi = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))
    got = T.hwio(TQAT.fake_quant_kernel(w_ohwi)).numpy()
    np.testing.assert_array_equal(got, want)
    q, scale = T._quantize_kernel(w)
    np.testing.assert_array_equal(got, q.astype(np.float32) * scale)


@pytest.mark.parametrize("static", [None, 0.013])
def test_fake_quant_act_is_jax_s(static):
    x = np.random.RandomState(1).normal(0, 1, (2, 5, 5, 8)).astype(np.float32)
    x[1] *= 4.0  # images of other ranges: per-image scales differ
    want = np.asarray(JQAT.fake_quant_act(
        jnp.asarray(x), None if static is None else jnp.float32(static)))
    got = TQAT.fake_quant_act(torch.from_numpy(x), None if static is None
                              else torch.tensor(np.float32(static)))
    np.testing.assert_array_equal(got.numpy(), want)
    if static is not None:  # saturation at +-127 steps
        assert np.abs(want).max() == np.float32(127 * np.float32(static))


def test_straight_through_gradients_are_the_identity():
    rng = np.random.RandomState(2)
    w = torch.from_numpy(rng.normal(0, 0.1, (4, 3, 3, 2)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 3, 4)).astype(np.float32))
    for fn, t in ((TQAT.fake_quant_kernel, w), (TQAT.fake_quant_act, x)):
        t = t.clone().requires_grad_(True)
        cot = torch.from_numpy(rng.normal(0, 1, tuple(t.shape)).astype(
            np.float32))
        (grad,) = torch.autograd.grad((fn(t) * cot).sum(), t)
        assert torch.equal(grad, cot)


@pytest.mark.parametrize("name,float_tail,calibrated", [
    ("conv", 0, False), ("passthrough", 1, True), ("fpn residual", 0, True)])
def test_student_and_its_freeze_match_jax(name, float_tail, calibrated):
    """``qat_layers`` equals JAX's student, and frozen untouched it is the
    PTQ layer list (``build_int8_layers`` with the calibrated scales
    attached), the first conv's input scale 1/127."""
    cfg = PLANS[name]()
    params, stats = variables(cfg, 20)
    tcfg, sd = port(cfg, params, stats)
    scales = (J.calibrate_activation_scales(cfg, params, stats, images(21, 2),
                                            float_tail) if calibrated else None)
    jplan, jstudent = JQAT.qat_layers(cfg, params, stats, float_tail, scales)
    tplan, tstudent = TQAT.qat_layers(tcfg, sd, float_tail, scales, "cpu")
    assert tplan == tuple(jplan)
    assert_layers_equal(tstudent, jstudent)
    frozen = TQAT.freeze_qat_layers(tstudent)
    assert_layers_equal(frozen, JQAT.freeze_qat_layers(jstudent))
    _, ptq = T.build_int8_layers(tcfg, sd, float_tail, "cpu")
    if calibrated:
        ptq = T.apply_activation_scales(ptq, scales)
    ptq[0] = dict(ptq[0], a_scale=torch.tensor(np.float32(1 / 127)))
    for f, p in zip(frozen, ptq):
        assert set(f) == set(p)
        for k in p:
            assert torch.equal(f[k], p[k]), k


def test_qat_finetune_matches_jax():
    """Three adam steps at JAX's default lr 1e-5 on 5 images in batches of
    2 (the last batch overlapping): ``first_loss``, ``last_loss`` and
    ``best_loss`` to 1e-5 relative, the same ``best_step``; the frozen
    layers serve; the caller's ``state_dict`` is left as it was (the
    layers are copies, though QAT updates them in place)."""
    cfg = PLANS["conv"]()
    params, stats = variables(cfg, 22)
    tcfg, sd = port(cfg, params, stats)
    calib = images(23, 5)
    kw = dict(steps=3, lr=1e-5, batch_size=2)
    before = {k: v.clone() for k, v in sd.items()}
    _, _, want = JQAT.qat_finetune(cfg, params, stats, calib, **kw)
    plan, layers, got = TQAT.qat_finetune(tcfg, sd, calib, device="cpu", **kw)
    assert set(got) == set(want) == {"steps", "lr", "batch_size",
                                     "first_loss", "last_loss", "best_loss",
                                     "best_step"}
    for key in ("first_loss", "last_loss", "best_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["best_step"] == want["best_step"]
    assert all(torch.equal(v, before[k]) for k, v in sd.items())
    assert (got["steps"], got["batch_size"]) == (3, 2)
    assert got["best_loss"] < got["first_loss"]
    assert all("w_q" in layer for layer in layers[:-1])
    model = T.Int8InferenceModel(tcfg, sd, calib_images=calib, qat_steps=1,
                                 qat_batch=2, device="cpu")
    assert set(model.qat_info) == set(got)
    assert model.predict(images(24))[0].shape == (2, 49, 6)
