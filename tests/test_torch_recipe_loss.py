"""The port's IoU-family box losses (``box_loss_mode`` diou / ciou /
alpha_iou, ``losses/yolo.py``) against the JAX package's
``yolo_v1_loss_terms``: the five terms to rtol 1e-6 and the gradient
against ``jax.grad`` to rtol 1e-5 / atol 1e-6 (float32), at generic points
and at the ties of the geometry:

- a predicted width or height of exactly 0.0 or -0.0 at an object cell,
  where ``jnp.abs`` passes the whole gradient (``select(x >= 0, g, -g)``)
  and torch's ``abs`` none (``test_abs_tie_needs_the_jax_rule`` shows the
  difference the port's ``_JaxAbs`` removes);
- boxes that touch (intersection width exactly 0: ``maximum(., 0)`` splits
  the tie in half in both libraries) and boxes with the same centre
  (``center_d2`` = 0, where ``alpha_iou``'s cube has a zero gradient).

The fused loss stays MSE-only: a train step with ``use_pallas_loss`` and an
IoU mode raises ``ValueError`` in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.losses.yolo import \
    yolo_v1_loss_terms as jterms
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.losses import yolo as tyolo
from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
from keras_object_detection_torch.train import make_train_step
from test_torch_loss import TERMS, random_case
from test_torch_train import _batch, _cfg


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


MODES = ("diou", "ciou", "alpha_iou")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _both(y_true, y_pred, mode, noobj_mode="selected", weight=None,
          term="total"):
    """(JAX terms, JAX gradient, port terms, port gradient) of ``term``."""
    jw = None if weight is None else jnp.asarray(weight)

    def jtotal(p):
        return jterms(jnp.asarray(y_true), p, 3, 2, noobj_mode=noobj_mode,
                      box_loss_mode=mode, sample_weight=jw)[term]

    jp = jnp.asarray(y_pred)
    want = jterms(jnp.asarray(y_true), jp, 3, 2, noobj_mode=noobj_mode,
                  box_loss_mode=mode, sample_weight=jw)
    want_grad = np.asarray(jax.grad(jtotal)(jp))
    p = _t(y_pred).requires_grad_(True)
    got = yolo_v1_loss_terms(_t(y_true), p, 3, 2, noobj_mode=noobj_mode,
                             box_loss_mode=mode,
                             sample_weight=None if weight is None else _t(weight))
    got[term].backward()
    return want, want_grad, got, p.grad.numpy()


def _assert_match(want, want_grad, got, got_grad):
    for k in TERMS:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed,noobj_mode,weighted", [
    (30, "selected", False), (31, "all", False), (32, "selected", True)])
def test_iou_box_losses_match_jax(mode, seed, noobj_mode, weighted):
    y_true, y_pred = random_case(seed)
    weight = np.array([1.0, 0.0], np.float32) if weighted else None
    _assert_match(*_both(y_true, y_pred, mode, noobj_mode, weight))


def _object_cell_case(seed=40):
    """A batch whose object cells' responsible slot (slot 0, by a wide
    IoU margin) is then set up by the caller."""
    y_true, y_pred = random_case(seed, batch=1, obj_prob=0.0)
    # four object cells, each with a truth box and slot 1 far away
    for k, (i, j) in enumerate([(0, 0), (1, 2), (3, 3), (5, 6)]):
        y_true[0, i, j, 3] = 1.0
        y_true[0, i, j, k % 3] = 1.0
        y_true[0, i, j, 4:8] = [0.4 + 0.05 * k, 0.5, 0.3, 0.2 + 0.05 * k]
        y_pred[0, i, j, 3 + 5 + 1:3 + 10] = [5.0, 5.0, 0.01, 0.01]
    return y_true, y_pred


def _tie_case(kind):
    y_true, y_pred = _object_cell_case()
    cells = [(0, 0), (1, 2), (3, 3), (5, 6)]
    for k, (i, j) in enumerate(cells):
        tx, ty, tw, th = y_true[0, i, j, 4:8]
        slot0 = y_pred[0, i, j, 4:8]
        if kind == "zero_wh":  # +0.0 and -0.0 widths and heights
            slot0[:] = [tx + 0.01, ty - 0.02,
                        [0.0, -0.0, 0.2, 0.0][k], [0.1, 0.0, -0.0, -0.0][k]]
        elif kind == "touching":  # intersection width exactly 0
            y_true[0, i, j, 4:8] = [0.5, 0.5, 0.25, 0.25]
            slot0[:] = [0.75, 0.5 + 0.0625 * k, 0.25, 0.125]
        else:  # "same_centre": center_d2 = 0
            slot0[:] = [tx, ty, tw * 0.5, th * 1.5]
    return y_true, y_pred


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["zero_wh", "touching", "same_centre"])
def test_iou_box_losses_match_jax_grad_at_ties(mode, kind):
    """The box term's gradient. At these points the object term's quirk
    IoU sits on its own clip tie, where the plain loss keeps torch's
    convention (``test_torch_loss.test_plain_autograd_tie_convention``)."""
    y_true, y_pred = _tie_case(kind)
    want, want_grad, got, got_grad = _both(y_true, y_pred, mode,
                                           term="box_loss")
    _assert_match(want, want_grad, got, got_grad)
    assert np.isfinite(got_grad).all()
    if kind == "touching":  # the slot really sits on the tie
        ious = tyolo._iou_geometry(_t(y_true[0, 1, 2, 4:8]),
                                   _t(y_pred[0, 1, 2, 4:8]))[0]
        assert float(ious) == 0.0


def test_abs_tie_needs_the_jax_rule(monkeypatch):
    """With torch's ``abs`` (gradient 0 at 0) the w = 0 / h = 0 cells'
    gradients part from ``jax.grad``; ``_JaxAbs`` closes that gap."""
    y_true, y_pred = _tie_case("zero_wh")
    want, want_grad, _, got_grad = _both(y_true, y_pred, "diou",
                                         term="box_loss")
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-6)

    class TorchAbs:
        apply = staticmethod(torch.abs)

    monkeypatch.setattr(tyolo, "_JaxAbs", TorchAbs)
    _, _, _, torch_grad = _both(y_true, y_pred, "diou", term="box_loss")
    assert np.abs(torch_grad - want_grad).max() > 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_iou_box_losses_are_finite_far_from_the_truth(mode):
    """No overlap at all (iou = 0, ``iou ** 3`` and its gradient 0) and
    huge aspect ratios (``w / (h + 1e-9)`` with h = 0): finite values and
    gradients, as JAX's."""
    y_true, y_pred = _object_cell_case(41)
    y_pred[0, 0, 0, 4:8] = [0.95, 0.95, 3.0, 0.0]
    y_pred[0, 1, 2, 4:8] = [-2.0, 4.0, 0.0, 7.0]
    want, want_grad, got, got_grad = _both(y_true, y_pred, mode,
                                           term="box_loss")
    _assert_match(want, want_grad, got, got_grad)
    assert all(np.isfinite(float(got[k].detach())) for k in TERMS)
    assert np.isfinite(got_grad).all()


def test_ciou_trade_off_weight_takes_no_gradient():
    """CIoU's alpha is under ``stop_gradient``: the port's gradient equals
    JAX's, and differs from the one with alpha differentiated."""
    y_true, y_pred = random_case(33)
    want, want_grad, _, got_grad = _both(y_true, y_pred, "ciou")
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5, atol=1e-6)

    def live_alpha(true_box, pred_box):
        iou, norm_d2, v = tyolo._iou_geometry(true_box, pred_box)
        return 1.0 - iou + norm_d2 + v / (1.0 - iou + v + 1e-9) * v

    p = _t(y_pred).requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tyolo.BOX_LOSSES, "ciou", live_alpha)
        yolo_v1_loss_terms(_t(y_true), p, 3, 2,
                           box_loss_mode="ciou")["total"].backward()
    assert np.abs(p.grad.numpy() - want_grad).max() > 1e-6


def test_fused_loss_refuses_iou_box_losses():
    """JAX raises when its step traces (one mode stands for the three: the
    check is ``box_loss_mode != "mse"``); the port when it builds one."""
    jcfg = _cfg(True, "sgd")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, box_loss_mode="ciou"))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    images, boxes, valid = _batch()
    with pytest.raises(ValueError, match="box_loss_mode"):
        jloop.make_train_step(jcfg)(jstate, jnp.asarray(images),
                                    jnp.asarray(boxes), jnp.asarray(valid),
                                    jax.random.PRNGKey(1))
    for mode in MODES:
        with pytest.raises(ValueError, match="box_loss_mode"):
            make_train_step(tconfig.Config.from_json(dataclasses.replace(
                jcfg, train=dataclasses.replace(
                    jcfg.train, box_loss_mode=mode)).to_json()))


def test_unknown_box_loss_mode_raises():
    y_true, y_pred = random_case(34)
    with pytest.raises(ValueError, match="box_loss_mode"):
        yolo_v1_loss_terms(_t(y_true), _t(y_pred), 3, 2, box_loss_mode="giou")
