"""The port's tagged images (``utils/viz.py``) against the JAX package's
``utils/viz.py`` (cv2 on both sides): the same image, rows and names give
byte-equal images, plain and with the grid overlay, for boxes inside and
across the image's edges, and for no boxes."""

import numpy as np
import pytest
import torch

from keras_object_detection_tpu.utils import viz as jviz
from keras_object_detection_torch.utils import viz


@pytest.fixture
def names(tmp_path):
    path = tmp_path / "names.txt"
    path.write_text("cat\ndog\nbird\n")
    return str(path)


def rows(seed, n):
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 6), np.float32)
    out[:, 0] = rng.randint(0, 3, n)
    out[:, 1] = rng.uniform(0.1, 1.0, n)
    out[:, 2:4] = rng.uniform(-0.1, 1.1, (n, 2))  # some centres outside
    out[:, 4:6] = rng.uniform(0.05, 0.9, (n, 2))
    return out


@pytest.mark.parametrize("seed,n,shape", [(0, 5, (224, 224)),
                                          (1, 12, (96, 160)), (2, 0, (56, 56))])
@pytest.mark.parametrize("grid", [None, 7, 4])
def test_tagged_images_equal_jax_s(names, seed, n, shape, grid):
    img = np.random.RandomState(seed + 10).randint(
        0, 256, shape + (3,), np.uint8)
    boxes = rows(seed, n)
    if grid is None:
        want = jviz.get_tagged_img(img.copy(), boxes, names)
        got = viz.get_tagged_img(img.copy(), torch.from_numpy(boxes), names)
    else:
        want = jviz.get_grid_tagged_img(img.copy(), boxes, names, grid)
        got = viz.get_grid_tagged_img(img.copy(), boxes, names, grid)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.array_equal(got, want)
    assert n == 0 and grid is None or not np.array_equal(got, img)


def test_write_image_round_trips(tmp_path):
    import cv2

    img = np.random.RandomState(3).randint(0, 256, (32, 48, 3), np.uint8)
    path = str(tmp_path / "x.png")
    viz.write_image(path, img)
    assert np.array_equal(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB),
                          img)
