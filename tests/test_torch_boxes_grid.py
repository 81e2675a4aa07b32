"""Parity of the PyTorch port's box geometry and grid decode with the JAX
package on the same numpy-seeded inputs, and with the executed-reference
goldens. Both sides are float32 elementwise arithmetic in the same
operation order, so the comparison is exact."""

import numpy as np
import pytest
import torch

from keras_object_detection_tpu.core import boxes as jboxes
from keras_object_detection_tpu.core.grid import decode_grid as jdecode
from keras_object_detection_torch.core import boxes as tboxes
from keras_object_detection_torch.core.grid import decode_grid


def _boxes(seed, shape):
    # beyond [0, 1] and with negative sizes, to reach the clip and |area| quirks
    return np.random.RandomState(seed).uniform(-0.3, 1.3, shape + (4,)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_matches_jax_exactly(seed):
    a, b = _boxes(seed, (300,)), _boxes(seed + 100, (300,))
    want = np.asarray(jboxes.iou_cxcywh(a, b))
    got = tboxes.iou_cxcywh(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (300, 1)
    np.testing.assert_array_equal(got, want)


def test_corners_match_jax_exactly():
    a = _boxes(3, (64,))
    np.testing.assert_array_equal(
        tboxes.cxcywh_to_corners(torch.from_numpy(a)).numpy(),
        np.asarray(jboxes.cxcywh_to_corners(a)))


@pytest.mark.parametrize("shape", [(49,), (3, 98)])
def test_pairwise_iou_matches_jax_exactly(shape):
    a, b = _boxes(4, shape), _boxes(5, shape)
    want = np.asarray(jboxes.pairwise_iou_cxcywh(a, b))
    got = tboxes.pairwise_iou_cxcywh(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
    assert got.shape == shape + (shape[-1],)
    np.testing.assert_array_equal(got, want)


def test_iou_goldens(goldens):
    for case in goldens["iou"]:
        got = tboxes.iou_cxcywh(torch.tensor(case["boxes1"], dtype=torch.float32),
                                torch.tensor(case["boxes2"], dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(case["iou"], np.float32),
                                   rtol=1e-5, atol=1e-6)


def _grid_with_ties(seed, b, s, c, nb):
    """Random grids where a third of the cells tie their class scores and
    their box confidences, so argmax tie-breaking is exercised."""
    rng = np.random.RandomState(seed)
    p = rng.normal(0, 1, (b, s, s, c + 5 * nb)).astype(np.float32)
    tie = rng.uniform(size=(b, s, s)) < 0.33
    p[..., :c][tie] = 0.5
    for k in range(1, nb):
        p[..., c + 5 * k][tie] = p[..., c][tie]
    return p


@pytest.mark.parametrize("b,s,c,nb", [(2, 7, 3, 2), (3, 7, 20, 2),
                                      (1, 14, 5, 3)])
def test_decode_grid_matches_jax_exactly(b, s, c, nb):
    p = _grid_with_ties(7, b, s, c, nb)
    want = np.asarray(jdecode(p, c, nb, s))
    got = decode_grid(torch.from_numpy(p), c, nb, s).numpy()
    assert got.shape == (b, s * s, 6)
    np.testing.assert_array_equal(got, want)


def test_decode_ties_go_to_the_lower_index():
    p = np.zeros((1, 7, 7, 13), np.float32)
    p[..., 3] = p[..., 8] = 0.7  # both box slots' confidences tie
    p[..., 4:8] = 0.1
    p[..., 9:13] = 0.9
    out = decode_grid(torch.from_numpy(p), 3, 2, 7).numpy()
    assert (out[..., 0] == 0).all()  # tied class scores -> class 0
    np.testing.assert_array_equal(out[..., 4:6], np.float32(0.1))  # slot 0's w, h


def test_decode_goldens(goldens):
    for case in goldens["decode"]:
        got = decode_grid(torch.tensor(case["pred"], dtype=torch.float32),
                          case["num_classes"], case["num_boxes"])
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(case["decoded"], np.float32),
                                   rtol=1e-5, atol=1e-6)
