"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA NMS kernel
has no CPU mode. They skip without a card. This file imports neither JAX nor
the JAX package, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from keras_object_detection_torch.config import tiny_cpu_config
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import build_model
from keras_object_detection_torch.ops import cuda_nms
from keras_object_detection_torch.ops.nms import batched_non_max_suppression

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NMS kernel is CUDA only")
    return torch.device("cuda")


def rows(seed, b, n, num_classes=3, conf=None):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0.1, 0.9, size=(8, 2))
    cls = rng.randint(0, num_classes, size=(b, n))
    c = rng.uniform(0, 1, size=(b, n)) if conf is None else np.full((b, n), conf)
    xy = centres[rng.randint(0, 8, size=(b, n))] + rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.05, 0.35, size=(b, n, 2))
    return np.concatenate([cls[..., None], c[..., None], xy, wh],
                          axis=-1).astype(np.float32)


CASES = {
    "1x49": lambda: rows(0, 1, 49),
    "32x49": lambda: rows(1, 32, 49, num_classes=20),
    "32x98": lambda: rows(2, 32, 98, num_classes=20),
    "4x196": lambda: rows(3, 4, 196),
    "8x512": lambda: rows(4, 8, 512, num_classes=5),
    "2x1024": lambda: rows(5, 2, 1024),
    "tied": lambda: rows(6, 4, 49, conf=0.9),
    "below": lambda: rows(7, 4, 98, conf=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_bit_equal_to_plain_version(cuda, case):
    x = torch.from_numpy(CASES[case]()).to(cuda)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = cuda_nms.cuda_batched_non_max_suppression(x)
    want_rows, want_valid = batched_non_max_suppression(x)
    assert cuda_nms.LAUNCHES == before + 1
    assert torch.equal(got_valid, want_valid)
    assert torch.equal(got_rows, want_rows)


@pytest.mark.parametrize("bad,match", [
    (lambda x: torch.zeros((1, cuda_nms.MAX_N + 1, 6), device=x.device), "cap"),
    (lambda x: x.double(), "float32"),
    (lambda x: x.transpose(0, 1), "contiguous"),
    (lambda x: x[..., :5].contiguous(), r"\(B, N, 6\)"),
])
def test_kernel_rejects_what_it_does_not_take(cuda, bad, match):
    x = torch.from_numpy(rows(8, 2, 49)).to(cuda)
    with pytest.raises(ValueError, match=match):
        cuda_nms.cuda_batched_non_max_suppression(bad(x))


def test_serving_on_the_gpu_goes_through_the_kernel(cuda):
    cfg = tiny_cpu_config()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = InferenceModel(cfg, sd)
    assert model.device.type == "cuda"
    images = np.random.RandomState(9).randint(0, 256, (4, 224, 224, 3), np.uint8)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = model.predict(images)
    assert cuda_nms.LAUNCHES == before + 1
    want_rows, want_valid = batched_non_max_suppression(
        model.predict_decoded(images))
    assert torch.equal(got_valid, want_valid)
    assert torch.equal(got_rows, want_rows)
