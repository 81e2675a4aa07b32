"""Parity of the PyTorch port's plain NMS with the JAX package's NMS and with
its Pallas kernel (run in interpret mode, as tests/test_pallas_nms.py runs
it), on the same numpy-seeded inputs. Keep sets, their order and the
suppressed tail are exact. The CUDA kernel is held to the plain version on
the GPU by tests/test_torch_gpu.py and by chip_smoke.py, on chip_smoke's
NMS_CASES; the edge cases among them (IoU exactly at the threshold or one
ulp off, 0.0 against -0.0 confidence ties, one class, identical boxes,
N = 1024) are held to JAX here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NMS_CASES, NMS_TIE_THRESHOLDS, iou_tie_pairs
from keras_object_detection_tpu.core.boxes import iou_cxcywh as jax_iou
from keras_object_detection_tpu.ops import nms as jnms
from keras_object_detection_tpu.ops.pallas_nms import \
    pallas_batched_non_max_suppression
from keras_object_detection_torch.core.boxes import iou_cxcywh
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.ops.nms import (batched_non_max_suppression,
                                                  non_max_suppression,
                                                  top_k_candidates)


def random_rows(seed, b, n, num_classes=3):
    """Clustered boxes so that same-class overlaps are common."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0.1, 0.9, size=(8, 2))
    cls = rng.randint(0, num_classes, size=(b, n))
    conf = rng.uniform(0, 1, size=(b, n))
    xy = centres[rng.randint(0, 8, size=(b, n))] + rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.05, 0.35, size=(b, n, 2))
    return np.concatenate([cls[..., None], conf[..., None], xy, wh],
                          axis=-1).astype(np.float32)


def tied_rows():
    rows = np.zeros((2, 8, 6), np.float32)
    rows[:, :, 0] = [0, 1, 0, 1, 2, 2, 0, 1]
    rows[:, :, 1] = 0.9  # every confidence tied
    rows[:, :, 2:4] = np.linspace(0.1, 0.9, 8)[:, None]
    rows[:, :, 4:6] = 0.4  # neighbours of one class overlap past 0.5
    return rows


def empty_rows():
    rows = random_rows(9, 2, 49)
    rows[..., 1] *= 0.4  # every confidence at or below conf_threshold=0.4
    return rows


CASES = {
    "n8": lambda: random_rows(1, 3, 8),
    "n49": lambda: random_rows(2, 4, 49),
    "n196": lambda: random_rows(3, 2, 196, num_classes=20),
    "n512": lambda: random_rows(4, 2, 512, num_classes=5),
    "tied": tied_rows,
    "empty": empty_rows,
}


def _torch_nms(rows, **kw):
    out, valid = batched_non_max_suppression(torch.from_numpy(rows), **kw)
    return out.numpy(), valid.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_nms_matches_jax_exactly(case):
    rows = CASES[case]()
    want_rows, want_valid = jnms.batched_non_max_suppression(jnp.asarray(rows))
    got_rows, got_valid = _torch_nms(rows)
    assert got_valid.dtype == np.bool_
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows, np.asarray(want_rows))
    if case == "empty":
        assert not got_valid.any()
    else:
        assert got_valid.any() and not got_valid.all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_nms_matches_pallas_kernel_exactly(case):
    rows = CASES[case]()
    want_rows, want_valid = pallas_batched_non_max_suppression(
        jnp.asarray(rows), interpret=True)
    got_rows, got_valid = _torch_nms(rows)
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows, np.asarray(want_rows))


def test_plain_nms_other_thresholds_match_jax():
    rows = random_rows(5, 3, 49)
    want_rows, want_valid = jnms.batched_non_max_suppression(
        jnp.asarray(rows), 0.25, 0.1)
    got_rows, got_valid = _torch_nms(rows, iou_threshold=0.25,
                                     conf_threshold=0.1)
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows, np.asarray(want_rows))


def test_nms_goldens(goldens):
    for case in goldens["nms"]:
        out, valid = non_max_suppression(
            torch.tensor(case["boxes"], dtype=torch.float32))
        expected = np.asarray(case["kept"], np.float32).reshape(-1, 6)
        got = out[valid].numpy()
        assert got.shape == expected.shape
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_conf_filter_is_strict():
    rows = torch.tensor([[0.0, 0.4, 0.5, 0.5, 0.1, 0.1],
                         [0.0, 0.41, 0.2, 0.2, 0.1, 0.1]])
    out, valid = non_max_suppression(rows)
    assert valid.tolist() == [True, False]
    assert out[0, 1].item() == pytest.approx(0.41)


def test_top_k_candidates_stable_on_ties():
    rng = np.random.RandomState(6)
    rows = random_rows(6, 3, 40)
    # heavy ties: 4 distinct confidences over 40 rows
    rows[..., 1] = rng.choice([0.2, 0.5, 0.7, 0.9], size=(3, 40))
    want = np.asarray(jnms.top_k_candidates(jnp.asarray(rows), 17))
    got = top_k_candidates(torch.from_numpy(rows), 17).numpy()
    np.testing.assert_array_equal(got, want)
    # lower index first among ties: jax.lax.top_k's order
    _, idx = jax.lax.top_k(jnp.asarray(rows[..., 1]), 17)
    np.testing.assert_array_equal(got, np.take_along_axis(
        rows, np.asarray(idx)[..., None], axis=1))


def test_top_k_is_a_no_op_at_or_below_k():
    rows = torch.from_numpy(random_rows(7, 2, 49))
    assert top_k_candidates(rows, 49) is rows


def test_cpu_tensor_routes_to_plain_version():
    rows = random_rows(8, 2, 98)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = cuda_nms.auto_batched_non_max_suppression(
        torch.from_numpy(rows), 0.5, 0.4, max_candidates=64)
    assert cuda_nms.LAUNCHES == before
    want_rows, want_valid = jnms.batched_non_max_suppression(
        jnms.top_k_candidates(jnp.asarray(rows), 64))
    assert got_rows.shape == (2, 64, 6)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))


def test_kernel_wrapper_rejects_cpu_tensors():
    before = cuda_nms.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_nms.cuda_batched_non_max_suppression(
            torch.from_numpy(random_rows(0, 1, 49)))
    assert cuda_nms.LAUNCHES == before



# chip_smoke.NMS_CASES the CUDA kernel must reproduce exactly, held to JAX
EDGE_CASES = ["iou tie 0.3", "iou tie 0.5", "iou tie 0.7", "signed zeros",
              "signed zeros as candidates", "one class 4x196",
              "one class 2x1024", "identical boxes 4x49", "3x1024"]


@pytest.mark.parametrize("thr", NMS_TIE_THRESHOLDS)
def test_iou_tie_pairs_sit_on_the_threshold(thr):
    """Two pairs each at float32(thr), one ulp below and one ulp above, by
    the port's IoU and by the JAX package's."""
    pairs = iou_tie_pairs(thr)
    t32 = np.float32(thr)
    want = np.repeat(np.float32([t32, np.nextafter(t32, np.float32(-1)),
                                 np.nextafter(t32, np.float32(2))]), 2)
    got = iou_cxcywh(torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]))
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jax_iou(jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])))[:, 0],
        want)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_nms_matches_jax_on_edge_cases(case):
    rows, iou, conf = NMS_CASES[case]()
    want_rows, want_valid = jnms.batched_non_max_suppression(jnp.asarray(rows),
                                                             iou, conf)
    got_rows, got_valid = _torch_nms(rows, iou_threshold=iou,
                                     conf_threshold=conf)
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows, np.asarray(want_rows))
    if case.startswith("iou tie"):
        # per image: 2 pairs at thr and 2 one ulp above lose their second
        # row, the 2 pairs one ulp below keep both
        assert got_valid.sum(axis=1).tolist() == [8, 8]


@pytest.mark.parametrize("case", [c for c in EDGE_CASES
                                  if not c.endswith("1024")])
def test_plain_nms_matches_pallas_kernel_on_edge_cases(case):
    rows, iou, conf = NMS_CASES[case]()
    want_rows, want_valid = pallas_batched_non_max_suppression(
        jnp.asarray(rows), iou, conf, interpret=True)
    got_rows, got_valid = _torch_nms(rows, iou_threshold=iou,
                                     conf_threshold=conf)
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    np.testing.assert_array_equal(got_rows, np.asarray(want_rows))


@pytest.mark.parametrize("conf_threshold", [0.4, -0.5])
def test_signed_zero_confidences_tie(conf_threshold):
    """0.0 and -0.0 are one confidence: tied rows keep their input order
    (the distinct boxes show it), survivors first, then the rest."""
    rows = NMS_CASES["signed zeros"]()[0]
    assert (np.signbit(rows[..., 1]) & (rows[..., 1] == 0)).any()
    out, valid = _torch_nms(rows, conf_threshold=conf_threshold)
    for image in range(len(rows)):
        # Python's sort is stable and holds -0.0 == 0.0
        order = sorted(range(rows.shape[1]), key=lambda k: -rows[image, k, 1])
        boxes = [tuple(rows[image, k, 2:]) for k in order]
        pos = [boxes.index(tuple(r[2:])) for r in out[image]]
        kept = int(valid[image].sum())
        assert sorted(pos) == list(range(rows.shape[1]))
        assert pos[:kept] == sorted(pos[:kept])
        assert pos[kept:] == sorted(pos[kept:])
