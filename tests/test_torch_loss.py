"""Parity of the port's v1 losses with the JAX package's.

- ``losses.yolo.yolo_v1_loss_terms`` (torch autograd) against
  ``yolo_v1_loss_terms``: values to rtol 1e-6, gradients against
  ``jax.grad`` at generic points, and the executed-reference goldens.
- ``ops.yolo_loss.fused_yolo_v1_loss`` on the CPU (the kernels' plain
  versions) against ``pallas_yolo_v1_loss(interpret=True)``: the forward to
  1e-6 and the backward to 1e-6 against ``jax.grad`` of it, which runs
  ``_backward_kernel``, including a clip-bound and a corner-tie point.

Three tie conventions meet at those points. The fused backward follows
``_backward_kernel`` (the intersection clip passes gradient only strictly
inside (0, 1); a corner tie goes wholly to the prediction). ``jax.grad`` of
the jnp loss passes half at a clip bound and splits a tie in half. Torch
autograd of the plain loss passes the whole gradient at a clip bound and
splits a tie in half. ``test_plain_autograd_tie_convention`` pins the last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.losses.yolo import \
    yolo_v1_loss_terms as jterms
from keras_object_detection_tpu.ops import pallas_loss
from keras_object_detection_tpu.ops.pallas_loss import pallas_yolo_v1_loss
from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
from keras_object_detection_torch.ops import yolo_loss
from keras_object_detection_torch.ops.yolo_loss import (
    fused_yolo_v1_loss, yolo_v1_loss_backward_plain, yolo_v1_loss_forward_plain)

TERMS = ("box_loss", "object_loss", "no_object_loss", "class_loss", "total")


def random_case(seed, batch=2, c=3, b=2, obj_prob=0.3, s=7):
    rng = np.random.RandomState(seed)
    depth = c + 5 * b
    y_true = np.zeros((batch, s, s, depth), np.float32)
    obj = rng.uniform(size=(batch, s, s)) < obj_prob
    cls = rng.randint(c, size=(batch, s, s))
    y_true[..., :c] = np.eye(c, dtype=np.float32)[cls] * obj[..., None]
    y_true[..., c] = obj
    y_true[..., c + 1:c + 5] = rng.uniform(
        [0, 0, 0.02, 0.02], [1, 1, 0.6, 0.6], (batch, s, s, 4)) * obj[..., None]
    y_pred = rng.uniform(-0.3, 1.0, size=y_true.shape).astype(np.float32)
    return y_true, y_pred


def tie_case(kind):
    """One batch, C=3, B=2, every cell empty but (0, 0), where slot 0 is the
    responsible slot and sits on a tie of the IoU chain:

    - ``"clip"``: the boxes touch along x, so the intersection width is
      exactly 0 (``clip(iw_raw, 0, 1)`` at its lower bound);
    - ``"corner"``: the left corners coincide (``max(t_x1, p_x1)`` tied)."""
    y_true, y_pred = random_case(3, batch=1)
    y_true[:] = 0.0
    y_true[0, 0, 0, [0, 3]] = 1.0
    if kind == "clip":
        y_true[0, 0, 0, 4:8] = [0.25, 0.5, 0.25, 0.5]  # x in [0, 0.25]
        y_pred[0, 0, 0, 3:8] = [0.7, 0.75, 0.6, 0.25, 0.5]  # x in [0.25, 0.5]
    else:
        y_true[0, 0, 0, 4:8] = [0.5, 0.5, 0.5, 0.5]  # x in [0, 0.5]
        y_pred[0, 0, 0, 3:8] = [0.3, 0.75, 0.55, 0.75, 0.4]  # x in [0, 0.75]
    y_pred[0, 0, 0, 8:13] = [0.2, 0.9, 0.9, 0.1, 0.1]  # slot 1: IoU 0
    return y_true, y_pred


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
@pytest.mark.parametrize("c,b", [(3, 2), (20, 2), (5, 3)])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_terms_match_jax(noobj_mode, c, b, weighted):
    y_true, y_pred = random_case(c * 10 + b, c=c, b=b)
    sw = np.array([1.0, 0.0], np.float32) if weighted else None
    want = jterms(jnp.asarray(y_true), jnp.asarray(y_pred), c, b,
                  noobj_mode=noobj_mode,
                  sample_weight=None if sw is None else jnp.asarray(sw))
    got = yolo_v1_loss_terms(_t(y_true), _t(y_pred), c, b,
                             noobj_mode=noobj_mode,
                             sample_weight=None if sw is None else _t(sw))
    for k in TERMS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)


@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
@pytest.mark.parametrize("seed", [20, 21, 22])
def test_plain_gradient_matches_jax_grad(noobj_mode, seed):
    y_true, y_pred = random_case(seed)
    want = jax.grad(lambda p: jterms(jnp.asarray(y_true), p, 3, 2,
                                     noobj_mode=noobj_mode)["total"])(
        jnp.asarray(y_pred))
    p = _t(y_pred).requires_grad_(True)
    yolo_v1_loss_terms(_t(y_true), p, 3, 2, noobj_mode=noobj_mode)["total"].backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_plain_and_fused_match_reference_goldens(goldens):
    for case in goldens["loss"]:
        y_true = _t(np.asarray(case["y_true"], np.float32))
        y_pred = _t(np.asarray(case["y_pred"], np.float32))
        c, b = case["num_classes"], case["num_boxes"]
        plain = float(yolo_v1_loss_terms(y_true, y_pred, c, b)["total"])
        fused = float(fused_yolo_v1_loss(y_true, y_pred, c, b))
        np.testing.assert_allclose(plain, case["loss"], rtol=1e-5)
        np.testing.assert_allclose(fused, case["loss"], rtol=1e-5)


@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
@pytest.mark.parametrize("c,b,batch", [(3, 2, 2), (20, 2, 3), (5, 3, 1)])
def test_fused_forward_matches_pallas_kernel(noobj_mode, c, b, batch):
    y_true, y_pred = random_case(b * 100 + c, batch=batch, c=c, b=b)
    _, out = pallas_loss._forward(jnp.asarray(y_true), jnp.asarray(y_pred), c,
                                  b, 5.0, 0.5, noobj_mode, True)
    depth = c + 5 * b
    sums = yolo_v1_loss_forward_plain(_t(y_true).reshape(-1, depth),
                                      _t(y_pred).reshape(-1, depth), c, b, 5.0,
                                      0.5, noobj_mode)
    np.testing.assert_allclose(sums.numpy(), np.asarray(out)[0, :5], rtol=1e-6)
    total = fused_yolo_v1_loss(_t(y_true), _t(y_pred), c, b,
                               noobj_mode=noobj_mode)
    np.testing.assert_allclose(float(total), float(out[0, 0]), rtol=1e-6)


def _fused_grad(y_true, y_pred, c=3, b=2, noobj_mode="selected"):
    p = _t(y_pred).requires_grad_(True)
    fused_yolo_v1_loss(_t(y_true), p, c, b, noobj_mode=noobj_mode).backward()
    return p.grad.numpy()


def _pallas_grad(y_true, y_pred, c=3, b=2, noobj_mode="selected"):
    return np.asarray(jax.grad(lambda p: pallas_yolo_v1_loss(
        jnp.asarray(y_true), p, c, b, noobj_mode=noobj_mode, interpret=True))(
            jnp.asarray(y_pred)))


@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
@pytest.mark.parametrize("case", ["random", "random_c20", "b3", "edge_wh",
                                  "clip", "corner"])
def test_fused_backward_follows_backward_kernel(noobj_mode, case):
    c, b = 3, 2
    if case == "random":
        y_true, y_pred = random_case(40)
    elif case == "random_c20":
        c = 20
        y_true, y_pred = random_case(41, c=20)
    elif case == "b3":
        c, b = 5, 3
        y_true, y_pred = random_case(42, c=5, b=3)
    elif case == "edge_wh":  # the sign/abs/sqrt kinks: zero and negative w, h
        y_true, y_pred = random_case(31)
        y_true[0, 1, 1, :] = [0, 1, 0, 1, 0.4, 0.6, 0.2, 0.3] + [0] * 5
        y_pred[0, 1, 1, 6:8] = [0.0, -0.4]
    else:
        y_true, y_pred = tie_case(case)
    got = _fused_grad(y_true, y_pred, c, b, noobj_mode)
    want = _pallas_grad(y_true, y_pred, c, b, noobj_mode)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fused_backward_at_ties_differs_from_jax_grad():
    """At the tie points the kernel's rules give other gradients than
    ``jax.grad`` of the jnp loss, in the coordinates the IoU chain reaches."""
    for kind in ("clip", "corner"):
        y_true, y_pred = tie_case(kind)
        fused = _fused_grad(y_true, y_pred)
        jgrad = np.asarray(jax.grad(lambda p: jterms(
            jnp.asarray(y_true), p, 3, 2)["total"])(jnp.asarray(y_pred)))
        assert abs(fused[0, 0, 0, 4] - jgrad[0, 0, 0, 4]) > 1e-3, kind
        other = np.ones(fused.shape, bool)
        other[0, 0, 0, 4:8] = False
        np.testing.assert_allclose(fused[other], jgrad[other], rtol=1e-5,
                                   atol=1e-6)


def test_plain_autograd_tie_convention():
    """Torch autograd of the plain loss: the clip bound passes the whole
    gradient (jax.grad half, the kernel none), so there torch - kernel =
    2 (jax - kernel) != 0; a corner tie splits in half, as jax.grad does."""
    for kind in ("clip", "corner"):
        y_true, y_pred = tie_case(kind)
        p = _t(y_pred).requires_grad_(True)
        yolo_v1_loss_terms(_t(y_true), p, 3, 2)["total"].backward()
        torch_g = p.grad.numpy()[0, 0, 0, 4]  # d total / d p_cx of slot 0
        jax_g = np.asarray(jax.grad(lambda q: jterms(
            jnp.asarray(y_true), q, 3, 2)["total"])(jnp.asarray(y_pred)))[0, 0, 0, 4]
        kernel_g = _fused_grad(y_true, y_pred)[0, 0, 0, 4]
        if kind == "clip":
            assert abs(jax_g - kernel_g) > 1e-3
            np.testing.assert_allclose(torch_g - kernel_g, 2 * (jax_g - kernel_g),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(torch_g, jax_g, rtol=1e-6)
            assert abs(torch_g - kernel_g) > 1e-3


def test_backward_reads_the_cotangent():
    y_true, y_pred = random_case(50)
    t = _t(y_true).reshape(-1, 13)
    p = _t(y_pred).reshape(-1, 13)
    one = yolo_v1_loss_backward_plain(t, p, torch.tensor(1.0), 3)
    half = yolo_v1_loss_backward_plain(t, p, torch.tensor(0.5), 3)
    np.testing.assert_allclose(half.numpy(), 0.5 * one.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_cpu_tensors_use_the_plain_versions():
    y_true, y_pred = random_case(51)
    before = (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES)
    p = _t(y_pred).requires_grad_(True)
    fused_yolo_v1_loss(_t(y_true), p, 3).backward()
    assert (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        yolo_loss.cuda_yolo_v1_loss_forward(_t(y_true).reshape(-1, 13),
                                            _t(y_pred).reshape(-1, 13), 3)
