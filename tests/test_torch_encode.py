"""Parity of the port's batched ``encode_grid`` with the JAX package's
(vmapped over the batch): exact, including first-box-wins collisions,
padding rows that would land in real cells, and boxes on the ``cx == 1.0``
edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.core.grid import encode_grid as jencode
from keras_object_detection_torch.core.grid import encode_grid


def _boxes(seed, batch, n, num_classes):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, n, 5), np.float32)
    boxes[..., 0:2] = rng.uniform(0, 1, (batch, n, 2))
    boxes[..., 2:4] = rng.uniform(0.01, 0.6, (batch, n, 2))
    boxes[..., 4] = rng.randint(0, num_classes, (batch, n))
    # collisions: row 3 repeats row 1's cell with another box and class
    boxes[:, 3, 0:2] = boxes[:, 1, 0:2] + 1e-3
    boxes[:, 3, 4] = (boxes[:, 1, 4] + 1) % num_classes
    # the right and bottom edges
    boxes[:, 4, 0] = 1.0
    boxes[:, 5, 1] = 1.0
    boxes[:, 6, 0:2] = 0.0
    valid = rng.uniform(0, 1, (batch, n)) < 0.8
    valid[:, [1, 3, 4, 5]] = True
    # a padding row in row 1's cell before it must not claim the cell
    boxes[:, 0, 0:2] = boxes[:, 1, 0:2]
    valid[:, 0] = False
    return boxes, valid


@pytest.mark.parametrize("grid,num_classes,num_boxes,n", [
    (7, 3, 2, 12), (7, 20, 2, 64), (14, 5, 3, 30), (4, 2, 1, 9)])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_grid_matches_jax_exactly(grid, num_classes, num_boxes, n, seed):
    boxes, valid = _boxes(seed, 3, n, num_classes)
    want = np.asarray(jax.vmap(
        lambda b, v: jencode(b, v, num_classes, num_boxes, grid))(
            jnp.asarray(boxes), jnp.asarray(valid)))
    got = encode_grid(torch.from_numpy(boxes), torch.from_numpy(valid),
                      num_classes, num_boxes, grid)
    assert got.shape == want.shape == (3, grid, grid, num_classes + 5 * num_boxes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_valid_box_wins_and_padding_is_ignored():
    boxes = np.array([[[0.5, 0.5, 0.2, 0.2, 0], [0.51, 0.52, 0.3, 0.3, 1],
                       [0.55, 0.55, 0.1, 0.1, 2]]], np.float32)
    valid = np.array([[False, True, True]])
    got = encode_grid(torch.from_numpy(boxes), torch.from_numpy(valid), 3)
    cell = got[0, 3, 3]
    assert cell[:3].tolist() == [0.0, 1.0, 0.0] and cell[3] == 1.0
    assert torch.allclose(cell[4:8], torch.tensor([7 * 0.51 - 3, 7 * 0.52 - 3,
                                                   0.3, 0.3]))
    assert got.sum() == cell.sum()  # nothing else written, slot 1 stays 0
