"""The port's ``remat`` (``ModelConfig.remat`` with ``remat_policy``
``"full"`` and ``"dots"``; ``models/layers.py`` ``remat``, applied per
backbone segment and to the head).

``jax.checkpoint`` changes no value, so the port's remat step must equal its
step without remat bit for bit: loss terms, every parameter and the BN
running statistics after two steps (adamw, with mosaic and mixup on), on
darknet_micro + conv (both policies, both BatchNorm paths), and at 32²
MobileNetV2 + GAP dense, VGG16 + flatten_dense (the dropout mask passes
through the recompute unchanged) and a frozen VGG16 + GAP dense,
with the plain BatchNorm and with ``bn_mode="fused"`` (the kernels' plain
versions here). The recompute runs each BatchNorm's forward, and so its
statistics sums (K2 on the card), a second time, and updates no running
statistic again: counted here. Against JAX's remat step (SGD, the JAX
step's own draws): as ``test_torch_train.test_sgd_step_matches_jax``, 1e-5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models.layers import BatchNorm
from keras_object_detection_torch.ops import bn as bn_ops
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _cfg, run_both)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


MODELS = {
    "darknet_micro": dict(backbone="darknet_micro", head="conv",
                          image_size=56),
    "mobilenetv2_gap": dict(backbone="mobilenetv2", head="gap_dense",
                            image_size=32, head_dense_units=64),
    "vgg16_flatten": dict(backbone="vgg16", head="flatten_dense",
                          image_size=32),
    "vgg16_gap_frozen": dict(backbone="vgg16", head="gap_dense",
                             image_size=32, head_dense_units=64,
                             freeze_backbone=True),
}


def _recipe_cfg(model, bn_mode, remat, policy="full"):
    return tconfig.Config(
        grid=tconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=tconfig.ModelConfig(compute_dtype="float32", bn_mode=bn_mode,
                                  remat=remat, remat_policy=policy,
                                  **MODELS[model]),
        data=tconfig.DataConfig(batch_size=4, mosaic_prob=0.75,
                                mixup_prob=0.5),
        train=tconfig.TrainConfig(
            optimizer="adamw", weight_decay=5e-4,
            schedule=tconfig.ScheduleConfig(kind="constant", base_lr=1e-3)))


def _batch(size, seed=0, b=4, n=6):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.2, 0.8, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.1, 0.4, (b, n, 2))
    boxes[..., 4] = rng.randint(0, 3, (b, n))
    return images, boxes, rng.rand(b, n) < 0.8


def _train(cfg, steps=2):
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(cfg)
    batch = _batch(cfg.model.image_size)
    for _ in range(steps):
        state, metrics = step(state, *batch, seed=3)
    return state, metrics


@pytest.mark.parametrize("model,bn_mode,policy", [
    ("darknet_micro", "flax", "full"), ("darknet_micro", "flax", "dots"),
    ("darknet_micro", "fused", "full"), ("darknet_micro", "fused", "dots"),
    ("mobilenetv2_gap", "flax", "full"), ("vgg16_flatten", "flax", "dots"),
    ("vgg16_gap_frozen", "flax", "full")])
def test_remat_step_is_bit_equal_to_the_step_without(model, bn_mode, policy):
    plain, plain_metrics = _train(_recipe_cfg(model, bn_mode, False))
    remat, metrics = _train(_recipe_cfg(model, bn_mode, True, policy))
    assert remat.model.remat_policy == policy
    assert set(metrics) == set(plain_metrics)
    for k in metrics:
        assert torch.equal(metrics[k], plain_metrics[k]), k
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for a, b in zip(remat.opt.mu + remat.opt.nu, plain.opt.mu + plain.opt.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_remat_recomputes_the_statistics_and_updates_them_once(
        monkeypatch, policy):
    """K2's plain version runs once a BatchNorm a step without remat, twice
    under either policy (the recompute); K3's once; the running-statistics
    update once a BatchNorm, whatever the policy."""
    cfg = _recipe_cfg("darknet_micro", "fused", policy is not None,
                      policy or "full")
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    counts = {"k2": 0, "k3": 0, "update": 0}

    def counted(name, fn):
        def wrapped(*args):
            counts[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(bn_ops, "bn_stats_sums_plain",
                        counted("k2", bn_ops.bn_stats_sums_plain))
    monkeypatch.setattr(bn_ops, "bn_grad_sums_plain",
                        counted("k3", bn_ops.bn_grad_sums_plain))
    forward = BatchNorm.forward

    def bn_forward(self, x):  # a forward that updates, or a recompute
        counts["update" if self.updates_running_stats else "recompute"] += 1
        return forward(self, x)

    monkeypatch.setattr(BatchNorm, "forward", bn_forward)
    counts["recompute"] = 0
    make_train_step(cfg)(state, *_batch(56), seed=3)
    monkeypatch.undo()
    assert counts == {"k2": n_bn * (2 if policy else 1), "k3": n_bn,
                      "update": n_bn, "recompute": n_bn if policy else 0}
    assert all(m.updates_running_stats for m in state.model.modules()
               if isinstance(m, BatchNorm))


@pytest.mark.parametrize("kernels,policy", [(False, "full"), (True, "dots")])
def test_remat_step_matches_jax_remat_step(monkeypatch, kernels, policy):
    import test_torch_train

    def remat_cfg(*args, **kwargs):
        c = _cfg(*args, **kwargs)
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, remat=True, remat_policy=policy))

    monkeypatch.setattr(test_torch_train, "_cfg", remat_cfg)
    jstate, jmetrics, state, metrics = run_both(kernels, "sgd")
    assert state.model.remat_policy == policy
    _assert_metrics_match(jmetrics, metrics, kernels)
    _assert_state_matches(jstate, state)
    assert int(jax.device_get(jstate.step)) == state.step == 1
