"""The port's FPN-family (YOLOv3) building blocks against the JAX package's,
on the same numpy inputs: ``partition_anchors`` and ``fpn_grid_sizes``
(exact, the stable area sort and its errors too), ``encode_fpn_grids``
(exact: each box's scale and slot, with a shape-IoU tie across two scales
going to the first maximum, as ``jnp.argmax`` has it; the offsets to a
rounding), both decodes (1e-6;
the decoded targets' class, objectness and centres exactly), the NMS keep
sets after the top-k cut of an FPN decode (exact), and
``yolo_v3_loss_terms`` with the ignore mask and IoU objectness over 2 and
3 scales (every term and its gradient against ``jax.grad``, 1e-5
relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.core import fpn as jfpn
from keras_object_detection_tpu.losses.yolov3 import \
    yolo_v3_loss_terms as jloss
from keras_object_detection_tpu.ops import nms as jnms
from keras_object_detection_torch import core as tcore
from keras_object_detection_torch.core import fpn as tfpn
from keras_object_detection_torch.losses import yolo_v3_loss_terms
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression

C = 3
TERMS = ("box_loss", "object_loss", "no_object_loss", "class_loss", "total")
# JAX's FPN tests' priors: 6 over 2 scales, 9 over 3
ANCHORS6 = ((0.8, 0.7), (0.5, 0.6), (0.35, 0.3),
            (0.2, 0.25), (0.12, 0.1), (0.05, 0.06))
ANCHORS9 = ANCHORS6 + ((0.03, 0.04), (0.6, 0.2), (0.15, 0.5))
# a prior shared by the last slot of scale 0 and the first of scale 1: a box
# of exactly its size ties across the two scales
TIED = ((0.5, 0.5), (0.3, 0.3), (0.3, 0.3), (0.1, 0.1))


def test_fpn_is_exported_as_in_jax():
    for name in ("fpn_grid_sizes", "partition_anchors", "encode_fpn_grids",
                 "decode_fpn_grids", "decode_fpn_targets"):
        assert getattr(tcore, name) is getattr(tfpn, name)


@pytest.mark.parametrize("anchors,scales", [
    (ANCHORS6, 2), (ANCHORS9, 3), (ANCHORS9, 1), (TIED, 2),
    (((0.2, 0.3), (0.3, 0.2), (0.1, 0.6), (0.6, 0.1)), 2)])  # equal areas
def test_partition_and_grid_sizes_match_jax(anchors, scales):
    assert tfpn.partition_anchors(anchors, scales) == \
        jfpn.partition_anchors(anchors, scales)
    assert tfpn.fpn_grid_sizes(13, scales) == jfpn.fpn_grid_sizes(13, scales)
    assert tfpn.fpn_grid_sizes(13, 3) == (13, 26, 52)


@pytest.mark.parametrize("anchors,scales", [(ANCHORS6[:5], 2), ((), 3)])
def test_partition_raises_as_jax(anchors, scales):
    for fn in (jfpn.partition_anchors, tfpn.partition_anchors):
        with pytest.raises(ValueError, match="divisible by num_scales"):
            fn(anchors, scales)


def _boxes(seed, batch, n, anchors):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0, 1, (batch, n, 2))
    boxes[..., 2:4] = np.exp(rng.uniform(np.log(0.02), np.log(0.9),
                                         (batch, n, 2)))
    boxes[..., 4] = rng.randint(0, C, (batch, n))
    # a collision: row 3 takes row 1's cell and shape, another class
    boxes[:, 3, :4] = boxes[:, 1, :4] + np.float32([1e-3, 1e-3, 0, 0])
    boxes[:, 3, 4] = (boxes[:, 1, 4] + 1) % C
    # shape-IoU ties: exactly the size of the first and the middle prior
    boxes[:, 5, 2:4] = anchors[0]
    boxes[:, 6, 2:4] = anchors[len(anchors) // 2]
    boxes[:, 4, :2] = 1.0  # the bottom-right edge
    valid = rng.uniform(0, 1, (batch, n)) < 0.8
    valid[:, [1, 3, 4, 5, 6]] = True
    boxes[:, 0, :4] = boxes[:, 1, :4]  # a padding row on row 1's slot
    valid[:, 0] = False
    return boxes, valid


def _jax_encode(boxes, valid, anchors, grid, scales):
    # jitted: JAX's eager vmap compiles every operation on its own
    return [np.asarray(g) for g in jax.jit(jax.vmap(
        lambda b, v: jfpn.encode_fpn_grids(b, v, C, anchors, grid, scales)))(
            jnp.asarray(boxes), jnp.asarray(valid))]


def _jax_decode(fn, grids, anchors, grid, scales):
    return np.asarray(jax.jit(lambda g: fn(g, C, anchors, grid, scales))(
        [jnp.asarray(x) for x in grids]))


@pytest.mark.parametrize("anchors,scales,grid,n", [
    (ANCHORS6, 2, 7, 12), (ANCHORS9, 3, 5, 30), (TIED, 2, 4, 10)])
def test_encode_fpn_grids_matches_jax_exactly(anchors, scales, grid, n):
    boxes, valid = _boxes(0, 3, n, anchors)
    want = _jax_encode(boxes, valid, anchors, grid, scales)
    got = tfpn.encode_fpn_grids(torch.from_numpy(boxes),
                                torch.from_numpy(valid), C, anchors, grid,
                                scales)
    per = len(anchors) // scales
    assert len(got) == len(want) == scales
    for s, (g, w) in enumerate(zip(got, want)):
        side = grid * 2 ** s
        assert g.shape == w.shape == (3, side, side, per * (5 + C))
        g = g.numpy().reshape(3, -1, 5 + C)
        w = w.reshape(3, -1, 5 + C)
        # the routing: each slot's objectness and class exactly; tx* = S *
        # cx - col to a rounding (jitted, XLA fuses it into one FMA), tw*
        # and th* through log, whose last bit XLA and torch may round apart
        exact = [0] + list(range(5, 5 + C))
        np.testing.assert_array_equal(g[..., exact], w[..., exact])
        np.testing.assert_allclose(g[..., 1:3], w[..., 1:3], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(g[..., 3:5], w[..., 3:5], rtol=1e-6,
                                   atol=1e-7)
    # every valid box lands on exactly one scale
    total = sum(float(g.reshape(3, -1, 5 + C)[..., 0].sum()) for g in got)
    assert total == sum(float(w.reshape(3, -1, 5 + C)[..., 0].sum())
                        for w in want) > 0
    if anchors == TIED:
        # the box of the shared prior's size goes to the coarse scale
        tied = np.float32(TIED[1])
        for img in range(3):
            row = got[0].reshape(3, -1, per, 5 + C)[img]
            col = min(int(grid * boxes[img, 6, 0]), grid - 1)
            cell = min(int(grid * boxes[img, 6, 1]), grid - 1) * grid + col
            assert row[cell, 1, 0] == 1.0
            np.testing.assert_allclose(np.exp(row[cell, 1, 3:5]) * tied,
                                       boxes[img, 6, 2:4], rtol=1e-6)


def _preds(seed, anchors, grid, scales, batch=2):
    rng = np.random.RandomState(seed)
    per = len(anchors) // scales
    out = []
    for s in range(scales):
        side = grid * 2 ** s
        p = rng.normal(0, 3, (batch, side, side, per, 5 + C)).astype(
            np.float32)
        p[0, 0, 0, :, 3:5] = 20.0  # the +-9 size clip
        p[0, 0, 1, 0, 5:] = 1.0  # a softmax tie: the lower class
        out.append(p.reshape(batch, side, side, per * (5 + C)))
    return out


@pytest.mark.parametrize("anchors,scales", [(ANCHORS6, 2), (ANCHORS9, 3)])
def test_decodes_match_jax(anchors, scales):
    preds = _preds(1, anchors, 5, scales)
    want = _jax_decode(jfpn.decode_fpn_grids, preds, anchors, 5, scales)
    got = tfpn.decode_fpn_grids([torch.from_numpy(p) for p in preds], C,
                                anchors, 5, scales)
    per = len(anchors) // scales
    n = sum(per * (5 * 2 ** s) ** 2 for s in range(scales))
    assert got.shape == want.shape == (2, n, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])

    boxes, valid = _boxes(2, 2, 14, anchors)
    enc = _jax_encode(boxes, valid, anchors, 5, scales)
    want = _jax_decode(jfpn.decode_fpn_targets, enc, anchors, 5, scales)
    got = tfpn.decode_fpn_targets([torch.from_numpy(t) for t in enc], C,
                                  anchors, 5, scales).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    # (t* + col) / S: one rounding in both; w = prior * exp(t*): exp's last bit
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], rtol=1e-7,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], rtol=1e-6)
    assert (got[..., 1] > 0).sum() == (want[..., 1] > 0).sum() > 0


def test_nms_keep_sets_after_the_cut_match_jax():
    """An FPN decode of 3 scales at S = 7 and 3 priors a scale (147 + 588
    + 2,352 = 3,087 rows an image, above K1's MAX_N of 1024) cut to 256 by
    confidence, then NMS: the same rows and keep sets as JAX's top-k and
    NMS."""
    preds = _preds(4, ANCHORS9, 7, 3)
    for p in preds:  # sizes near their priors: neighbours overlap
        p.reshape(*p.shape[:3], 3, 5 + C)[..., 3:5] *= 0.1
    decoded = _jax_decode(jfpn.decode_fpn_grids, preds, ANCHORS9, 7, 3)
    want_rows, want_valid = jax.jit(lambda d: jnms.batched_non_max_suppression(
        jnms.top_k_candidates(d, 256), 0.5, 0.4))(jnp.asarray(decoded))
    got = tfpn.decode_fpn_grids([torch.from_numpy(p) for p in preds], C,
                                ANCHORS9, 7, 3)
    assert got.shape == (2, 3 * (49 + 196 + 784), 6)
    # the port's own decode, compared above to 1e-6: hand NMS JAX's rows so
    # that the keep sets compare on identical inputs
    rows, valid = auto_batched_non_max_suppression(
        torch.from_numpy(decoded), 0.5, 0.4, 256)
    assert rows.shape == (2, 256, 6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert 0 < int(valid.sum()) < valid.numel()


def _loss_inputs(anchors, scales, seed=0, batch=3, grid=4):
    rng = np.random.RandomState(seed)
    boxes, valid = _boxes(seed, batch, 10, anchors)
    boxes[..., 2:4] = np.clip(boxes[..., 2:4], 0.03, 0.6)
    y_true = _jax_encode(boxes, valid, anchors, grid, scales)
    y_pred = [rng.normal(0, 1.5, t.shape).astype(np.float32) for t in y_true]
    return y_true, y_pred, boxes, valid


@pytest.mark.parametrize("anchors,scales", [(ANCHORS6, 2), (ANCHORS9, 3)])
@pytest.mark.parametrize("obj_target,ignore,weighted", [
    ("iou", 0.5, True), ("one", None, False)])
def test_v3_loss_terms_and_gradient_match_jax(anchors, scales, obj_target,
                                              ignore, weighted):
    y_true, y_pred, boxes, valid = _loss_inputs(anchors, scales)
    weight = np.float32([1.0, 0.5, 0.0]) if weighted else None
    kw = dict(ignore_threshold=ignore, obj_target=obj_target)

    def jtotal(preds):
        terms = jloss([jnp.asarray(t) for t in y_true], preds, C, anchors,
                      scales, sample_weight=None if weight is None
                      else jnp.asarray(weight), gt_boxes=jnp.asarray(boxes),
                      gt_valid=jnp.asarray(valid), **kw)
        return terms["total"], terms

    (_, jterms), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        [jnp.asarray(p) for p in y_pred])
    preds = [torch.from_numpy(p).requires_grad_(True) for p in y_pred]
    terms = yolo_v3_loss_terms(
        [torch.from_numpy(t) for t in y_true], preds, C, anchors, scales,
        sample_weight=None if weight is None else torch.from_numpy(weight),
        gt_boxes=torch.from_numpy(boxes), gt_valid=torch.from_numpy(valid),
        **kw)
    terms["total"].backward()
    for k in TERMS:
        assert terms[k].dtype == torch.float32
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]),
                                   rtol=1e-5, err_msg=k)
    for p, jg in zip(preds, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(p.grad.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * np.abs(jg).max())


def test_v3_loss_guards_match_jax():
    y_true, y_pred, _, _ = _loss_inputs(ANCHORS6, 2)
    for fn, arr in ((jloss, jnp.asarray), (yolo_v3_loss_terms,
                                           torch.from_numpy)):
        with pytest.raises(ValueError, match="expected 2 per-scale grids"):
            fn([arr(t) for t in y_true], [arr(y_pred[0])], C, ANCHORS6, 2)
        with pytest.raises(ValueError, match="divisible by num_scales"):
            fn([arr(t) for t in y_true], [arr(p) for p in y_pred], C,
               ANCHORS6[:5], 2)
