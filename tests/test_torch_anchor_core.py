"""The port's anchor-family building blocks against the JAX package's, on
the same numpy inputs: the exact IoU (1e-6), ``encode_anchor_grid``
(exact: the winner of each (cell, anchor) slot, the best anchor with its
shape-IoU ties, padding rows, edges), both decodes with the +-9 size clip
(1e-6), ``yolo_v2_loss_terms`` (every term and its gradient against
``jax.grad``, 1e-5 relative, with ``obj_target`` one / iou, ignore threshold
None / 0.5 / at a slot's own best IoU, and ``sample_weight``),
``space_to_depth`` (exact) and the k-means anchor tool (the same anchors
as ``tools/kmeans_anchors.py``)."""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.core import anchors as janchors
from keras_object_detection_tpu.core import boxes as jboxes
from keras_object_detection_tpu.losses.yolov2 import \
    yolo_v2_loss_terms as jloss
from keras_object_detection_tpu.models.layers import \
    space_to_depth as jspace_to_depth
from keras_object_detection_torch.cli import kmeans_anchors as tkmeans
from keras_object_detection_torch.core import anchors as tanchors
from keras_object_detection_torch.core import boxes as tboxes
from keras_object_detection_torch.losses import yolo_v2_loss_terms
from keras_object_detection_torch.models.layers import space_to_depth

# the JAX package's anchor tests' priors; C = 3
ANCHORS = ((0.1, 0.15), (0.4, 0.3), (0.8, 0.8))
C = 3
TERMS = ("box_loss", "object_loss", "no_object_loss", "class_loss", "total")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _random_boxes(seed, shape):
    rng = np.random.RandomState(seed)
    b = np.zeros(shape + (4,), np.float32)
    b[..., :2] = rng.uniform(0, 1, shape + (2,))
    b[..., 2:] = rng.uniform(0.0, 0.6, shape + (2,))
    return b


def test_exact_iou_matches_jax():
    a, b = _random_boxes(0, (40,)), _random_boxes(1, (40,))
    b[:5] = a[:5]  # identical
    b[5:10, 2:] = 0.0  # empty
    b[10:15] = a[10:15] * np.float32([1, 1, 0.5, 0.5])  # inside
    b[15:20, 0] = a[15:20, 0] + 2.0  # disjoint
    b[20:25, 2:] = -b[20:25, 2:]  # negative sizes
    want = np.asarray(jax.jit(jboxes.iou_cxcywh_exact)(jnp.asarray(a),
                                                        jnp.asarray(b)))
    got = tboxes.iou_cxcywh_exact(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got[:5].numpy(), np.ones(5), rtol=1e-6)
    np.testing.assert_array_equal(got[15:20].numpy(), np.zeros(5, np.float32))
    want = np.asarray(jax.jit(jboxes.pairwise_iou_cxcywh_exact)(
        jnp.asarray(a.reshape(2, 20, 4)), jnp.asarray(b[:24].reshape(2, 12, 4))))
    got = tboxes.pairwise_iou_cxcywh_exact(
        torch.from_numpy(a.reshape(2, 20, 4)),
        torch.from_numpy(b[:24].reshape(2, 12, 4)))
    assert got.shape == (2, 20, 12)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _encode_inputs(seed, batch, n, anchors):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0, 1, (batch, n, 2))
    boxes[..., 2:4] = rng.uniform(0.02, 0.9, (batch, n, 2))
    boxes[..., 4] = rng.randint(0, C, (batch, n))
    # a collision: row 3 takes row 1's cell and shape, another class
    boxes[:, 3, :4] = boxes[:, 1, :4] + np.float32([1e-3, 1e-3, 0, 0])
    boxes[:, 3, 4] = (boxes[:, 1, 4] + 1) % C
    # shape-IoU ties: a box exactly the size of a prior that appears twice
    boxes[:, 6, 2:4] = anchors[-1]
    # the right and bottom edges, the origin
    boxes[:, 4, 0] = 1.0
    boxes[:, 5, 1] = 1.0
    boxes[:, 7, :2] = 0.0
    valid = rng.uniform(0, 1, (batch, n)) < 0.8
    valid[:, [1, 3, 4, 5, 6, 7]] = True
    # a padding row on row 1's slot, before it, must not claim it
    boxes[:, 0, :4] = boxes[:, 1, :4]
    valid[:, 0] = False
    return boxes, valid


@pytest.mark.parametrize("grid,anchors,n", [
    (7, ANCHORS, 12),
    (5, ANCHORS + ((0.8, 0.8),), 24),  # a duplicated prior: argmax ties
    (13, ((0.3, 0.3), (0.3, 0.3), (0.05, 0.6), (0.6, 0.05), (0.9, 0.9)), 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_anchor_grid_matches_jax_exactly(grid, anchors, n, seed):
    boxes, valid = _encode_inputs(seed, 3, n, anchors)
    want = np.asarray(jax.vmap(lambda b, v: janchors.encode_anchor_grid(
        b, v, C, anchors, grid))(jnp.asarray(boxes), jnp.asarray(valid)))
    got = tanchors.encode_anchor_grid(torch.from_numpy(boxes),
                                      torch.from_numpy(valid), C, anchors, grid)
    assert got.shape == want.shape == (3, grid, grid, len(anchors) * (5 + C))
    got = got.numpy().reshape(3, -1, 5 + C)
    want = want.reshape(3, -1, 5 + C)
    # the winner of each slot (obj, tx*, ty*, class) exactly; tw* and th*
    # go through log, whose last bit XLA's and torch's may round apart
    exact = [0, 1, 2] + list(range(5, 5 + C))
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got[..., 3:5], want[..., 3:5], rtol=1e-6,
                               atol=1e-7)
    # the duplicated prior never wins a slot: its tie goes to the lower one
    if anchors[0] == anchors[1]:
        assert got.reshape(3, grid * grid, len(anchors), -1)[:, :, 1, 0].sum() == 0


def test_decodes_match_jax():
    rng = np.random.RandomState(3)
    s, nb = 7, len(ANCHORS)
    pred = rng.normal(0, 3, (2, s, s, nb * (5 + C))).astype(np.float32)
    p = pred.reshape(2, s, s, nb, 5 + C)
    p[0, 0, 0, :, 3:5] = [[20.0, -20.0], [9.0, -9.0], [9.5, -9.5]]  # the clip
    p[0, 0, 1, 0, 5:] = 1.0  # a softmax tie: the lower class
    want = np.asarray(jax.jit(janchors.decode_anchor_grid, static_argnums=(
        1, 2, 3))(jnp.asarray(pred), C, ANCHORS, s))
    got = tanchors.decode_anchor_grid(torch.from_numpy(pred), C, ANCHORS, s)
    assert got.shape == (2, s * s * nb, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    assert float(got[0, 0, 4]) == pytest.approx(0.1 * np.exp(9.0), rel=1e-6)

    boxes, valid = _encode_inputs(2, 2, 10, ANCHORS)
    enc = tanchors.encode_anchor_grid(torch.from_numpy(boxes),
                                      torch.from_numpy(valid), C, ANCHORS,
                                      s).numpy()
    want = np.asarray(jax.jit(janchors.decode_anchor_targets, static_argnums=(
        1, 2, 3))(jnp.asarray(enc), C, ANCHORS, s))
    got = tanchors.decode_anchor_targets(torch.from_numpy(enc), C, ANCHORS, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    empty = enc.reshape(2, -1, 5 + C)[..., 0] == 0
    assert empty.any() and not got.numpy()[empty].any()


def _loss_inputs(seed=0, batch=3, s=7, n=6):
    """Targets from random boxes and predictions whose box logits are 0
    on the first image (each decodes exactly to its cell's centre and its
    prior, so an IoU against it is the same float in both packages)."""
    rng = np.random.RandomState(seed)
    boxes, valid = _encode_inputs(seed, batch, n + 2, ANCHORS)
    boxes[..., 2:4] = np.clip(boxes[..., 2:4], 0.05, 0.5)
    y_true = tanchors.encode_anchor_grid(torch.from_numpy(boxes),
                                         torch.from_numpy(valid), C, ANCHORS,
                                         s).numpy()
    y_pred = rng.normal(0, 1.5, y_true.shape).astype(np.float32)
    y_pred.reshape(batch, s, s, len(ANCHORS), 5 + C)[0, ..., 1:5] = 0.0
    return y_true, y_pred, boxes, valid


def _boundary_threshold(y_true, y_pred, boxes, valid, s=7):
    """The largest best-IoU of an unassigned slot of image 0: a threshold
    exactly at a slot's own value (``best <= thr`` keeps it penalised)."""
    dec = tanchors.decode_anchor_grid(torch.from_numpy(y_pred[:1]), C,
                                      ANCHORS, s)[0, :, 2:6]
    ious = tboxes.pairwise_iou_cxcywh_exact(dec, torch.from_numpy(boxes[0, :, :4]))
    best = torch.where(torch.from_numpy(valid[0])[None], ious, 0.0).amax(-1)
    unassigned = torch.from_numpy(y_true[0].reshape(-1, 5 + C)[:, 0] == 0)
    return float(best[unassigned].max())


def _both_losses(y_true, y_pred, boxes, valid, weight, **kw):
    def jtotal(yp):
        terms = jloss(jnp.asarray(y_true), yp, C, ANCHORS,
                      sample_weight=None if weight is None else jnp.asarray(weight),
                      gt_boxes=jnp.asarray(boxes), gt_valid=jnp.asarray(valid),
                      **kw)
        return terms["total"], terms

    (_, jterms), jgrad = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(y_pred))
    yp = torch.from_numpy(y_pred).requires_grad_(True)
    terms = yolo_v2_loss_terms(
        torch.from_numpy(y_true), yp, C, ANCHORS,
        sample_weight=None if weight is None else torch.from_numpy(weight),
        gt_boxes=torch.from_numpy(boxes), gt_valid=torch.from_numpy(valid),
        **kw)
    terms["total"].backward()
    return jterms, np.asarray(jgrad), terms, yp.grad.numpy()


@pytest.mark.parametrize("obj_target", ["one", "iou"])
@pytest.mark.parametrize("ignore", [None, 0.5, "boundary"])
def test_v2_loss_terms_and_gradient_match_jax(obj_target, ignore):
    y_true, y_pred, boxes, valid = _loss_inputs()
    weight = np.float32([1.0, 0.5, 0.0]) if ignore != 0.5 else None
    thr = (_boundary_threshold(y_true, y_pred, boxes, valid)
           if ignore == "boundary"
           else ignore)
    jterms, jgrad, terms, grad = _both_losses(
        y_true, y_pred, boxes, valid, weight, ignore_threshold=thr,
        obj_target=obj_target)
    for k in TERMS:
        assert terms[k].dtype == torch.float32
        np.testing.assert_allclose(terms[k].item(), float(jterms[k]),
                                   rtol=1e-5, err_msg=k)
    scale = np.abs(jgrad).max()
    np.testing.assert_allclose(grad, jgrad, rtol=1e-5, atol=1e-5 * scale)
    if ignore == "boundary":
        # one ulp below the slot's best IoU exempts it: the no-object term
        # drops in both packages
        below = float(np.nextafter(np.float32(thr), np.float32(-1)))
        jb, _, tb, _ = _both_losses(y_true, y_pred, boxes, valid, weight,
                                    ignore_threshold=below,
                                    obj_target=obj_target)
        assert float(tb["no_object_loss"]) < float(terms["no_object_loss"])
        np.testing.assert_allclose(float(tb["no_object_loss"]),
                                   float(jb["no_object_loss"]), rtol=1e-5)


def test_iou_target_takes_no_gradient():
    """obj_target="iou" moves the object term's value but, the target being
    stopped, its gradient is the "one" target's form: 2 (p - t) p (1 - p)
    through the objectness logit only."""
    y_true, y_pred, boxes, valid = _loss_inputs(seed=1)
    _, jgrad, terms, grad = _both_losses(y_true, y_pred, boxes, valid, None,
                                         obj_target="iou")
    live = yolo_v2_loss_terms(torch.from_numpy(y_true),
                              torch.from_numpy(y_pred), C, ANCHORS,
                              obj_target="one")
    assert float(terms["object_loss"]) != float(live["object_loss"])
    # the box-logit gradient equals the "one" target's: no IoU path
    yp = torch.from_numpy(y_pred).requires_grad_(True)
    yolo_v2_loss_terms(torch.from_numpy(y_true), yp, C, ANCHORS,
                       obj_target="one")["box_loss"].backward()
    box_only = yp.grad.numpy().reshape(3, 7, 7, 3, 8)[..., 1:5]
    np.testing.assert_allclose(grad.reshape(3, 7, 7, 3, 8)[..., 1:5], box_only,
                               rtol=1e-6, atol=1e-7)


def test_v2_loss_guards_match_jax():
    y_true, y_pred, _, _ = _loss_inputs()
    for fn, arr in ((jloss, jnp.asarray), (yolo_v2_loss_terms, torch.from_numpy)):
        with pytest.raises(ValueError, match="unknown obj_target 'giou'"):
            fn(arr(y_true), arr(y_pred), C, ANCHORS, obj_target="giou")
        with pytest.raises(ValueError, match="needs gt_boxes/gt_valid"):
            fn(arr(y_true), arr(y_pred), C, ANCHORS, ignore_threshold=0.5)


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(0).normal(size=(2, 6, 4, 5)).astype(np.float32)
    want = np.asarray(jspace_to_depth(jnp.asarray(x), 2))  # NHWC
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    for inp in (nchw.contiguous(), nchw.contiguous(
            memory_format=torch.channels_last)):
        got = space_to_depth(inp, 2)
        assert got.shape == (2, 20, 3, 2)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
        assert got.is_contiguous(memory_format=torch.channels_last)
    # PixelUnshuffle orders the channels (C, bh, bw): not JAX's layout
    shuffled = torch.nn.PixelUnshuffle(2)(nchw.contiguous())
    assert not np.array_equal(shuffled.permute(0, 2, 3, 1).numpy(), want)
    for fn, arr in ((jspace_to_depth, jnp.asarray(x[:, :5])),
                    (space_to_depth, nchw[:, :, :5])):
        with pytest.raises(ValueError, match="not divisible"):
            fn(arr, 2)


def _jax_kmeans_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_kmeans_anchors", ROOT / "tools" / "kmeans_anchors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kmeans_tool_matches_jax(tmp_path, monkeypatch, capsys):
    jtool = _jax_kmeans_tool()
    rng = np.random.RandomState(0)
    wh = np.concatenate([rng.uniform(0.02, 0.1, (60, 2)),
                         rng.uniform(0.3, 0.6, (40, 2)),
                         rng.uniform(0.7, 0.95, (20, 2))]).astype(np.float32)
    for k, seed in ((3, 0), (5, 2)):
        want, want_iou = jtool.kmeans_iou(wh.copy(), k, seed=seed)
        got, got_iou = tkmeans.kmeans_iou(wh.copy(), k, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert got_iou == want_iou
    np.testing.assert_array_equal(tkmeans.shape_iou(wh, wh[:4]),
                                  jtool.shape_iou(wh, wh[:4]))
    # the command line: one JSON line, as the JAX tool prints it
    for i, row in enumerate(wh[:30]):
        (tmp_path / f"img{i:03d}.jpg").write_bytes(b"")
        (tmp_path / f"img{i:03d}.txt").write_text(
            f"{i % 3} 0.5 0.5 {row[0]:.6f} {row[1]:.6f}\n")
    tkmeans.main(["--data", str(tmp_path), "--k", "3"])
    got = json.loads(capsys.readouterr().out)
    monkeypatch.setattr("sys.argv", ["kmeans_anchors.py", "--data",
                                     str(tmp_path), "--k", "3"])
    jtool.main()
    assert got == json.loads(capsys.readouterr().out)
    assert got["boxes"] == 30 and got["train_flag"].startswith(
        "--head anchor --anchors ")
