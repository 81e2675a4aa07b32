"""The yardstick against the numbers the repository measured before: the
model FLOPs of one image and the least times of K1, K2 and K3."""

import json

import pytest

from portbench import yardstick


def _cfg(preset):
    from keras_object_detection_torch import config

    return json.loads(getattr(config, preset)().to_json())


@pytest.mark.parametrize("preset,gflop", [("voc_full_config", 41.075),
                                           ("yolov3_config", 65.428)])
def test_forward_flops_of_an_image(preset, gflop):
    assert yardstick.model_flops(_cfg(preset), False) / 1e9 == \
        pytest.approx(gflop, abs=5e-4)


def test_training_flops_count_both_gradients_but_the_first_input():
    cfg = _cfg("voc_full_config")
    first = yardstick.conv_shapes(cfg, 1)[0]["macs"]
    assert yardstick.model_flops(cfg, True) == \
        3 * yardstick.model_flops(cfg, False) - 2 * first


def test_bn_statistics_bound_of_the_flagship_step():
    # PERF.md: K2 0.52917 ms and K3 1.05831 ms over the step's 25 launches
    ms, launches = yardstick.bn_step_ms(_cfg("voc_full_config"), 64, 2)
    assert launches == 50
    assert ms == pytest.approx(0.52917 + 1.05831, abs=2e-5)
    _, launches = yardstick.bn_step_ms(_cfg("yolov3_config"), 64, 2)
    assert launches == 144


def test_nms_bound():
    # PERF.md: 2.396e-04 ms at 32 x 512 (bytes)
    assert yardstick.nms_ms(32, 512) == pytest.approx(2.396e-4, rel=1e-3)
