"""The port's whole train step against the JAX package's ``make_train_step``
on ``darknet_micro`` @56 (C=3, batch 4, float32), with both switch
settings: the plain path (jnp loss, flax BatchNorm) and the kernels' path
(``use_pallas_loss=True``, ``bn_mode="fused"``, the Pallas kernels in
interpret mode on the JAX side, the kernels' plain versions on the port's).

Both steps start from the same weights (``flax_to_torch``) and see the same
augmentation: the JAX step's own draws, derived by repeating its key chain
(``fold_in(rng, step)``, then ``augment_batch``'s splits, per microbatch
``fold_in(akey, i)``).

- SGD (an update linear in the gradient): loss terms, every parameter and
  running statistic to 1e-5;
- nadam (which divides by the gradient's scale, so tiny gradients amplify
  rounding): the loss after an update to 1e-4, the parameters as its test
  says;
- ``grad_accum_steps=2`` with an EMA: loss, parameters, running statistics
  and the EMA to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step,
                                                set_learning_rate)
from test_torch_augment import jax_draws

TERMS = ("box_loss", "object_loss", "no_object_loss", "class_loss", "total")


def _cfg(kernels: bool, optimizer: str, accum: int = 1, ema=None, lr=1e-4):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="conv",
                                  image_size=56, compute_dtype="float32",
                                  bn_mode="fused" if kernels else "flax"),
        data=jconfig.DataConfig(batch_size=4),
        train=jconfig.TrainConfig(
            optimizer=optimizer, use_pallas_loss=kernels,
            grad_accum_steps=accum, ema_decay=ema,
            schedule=jconfig.ScheduleConfig(kind="constant", base_lr=lr)))


def _batch(seed=0, b=4, size=56, n=8):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.1, 0.9, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.1, 0.5, (b, n, 2))
    boxes[..., 4] = rng.randint(0, 3, (b, n))
    valid = np.zeros((b, n), bool)
    valid[:, :5] = True
    return images, boxes, valid


def _port_state(jcfg, jstate):
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    state = create_train_state(tcfg, device="cpu")
    state.model.load_state_dict(flax_to_torch(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats),
        state.model))
    if state.ema is not None:
        state.ema = {k: v.detach().clone()
                     for k, v in state.model.named_parameters()}
    return tcfg, state


def _jax_draws(jcfg, rng, step, accum, batch):
    akey, _ = jax.random.split(jax.random.fold_in(rng, step))
    d = jcfg.data
    kw = dict(strengths=tuple(d.color_jitter), crop_scale=tuple(d.crop_scale),
              crop_ratio=tuple(d.crop_ratio))
    if accum == 1:
        return [jax_draws(akey, batch, **kw)]
    return [jax_draws(jax.random.fold_in(akey, i), batch // accum, **kw)
            for i in range(accum)]


def run_both(kernels, optimizer, accum=1, ema=None, steps=1):
    jcfg = _cfg(kernels, optimizer, accum, ema)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate)
    images, boxes, valid = _batch()
    jstep = jax.jit(jloop.make_train_step(jcfg))
    step = make_train_step(tcfg)
    rng = jax.random.PRNGKey(7)
    for i in range(steps):
        draws = _jax_draws(jcfg, rng, i, accum, 4)
        jstate, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(boxes),
                                 jnp.asarray(valid), rng)
        state, metrics = step(state, images, boxes, valid, seed=0, draws=draws)
    return jstate, jmetrics, state, metrics


def _assert_state_matches(jstate, state, tol=1e-5):
    want = flax_to_torch(jax.device_get(jstate.params),
                         jax.device_get(jstate.batch_stats), state.model)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def _assert_metrics_match(jmetrics, metrics, kernels, tol=1e-5):
    keys = ("total",) if kernels else TERMS
    assert set(metrics) == set(keys) == set(jmetrics)
    for k in keys:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=tol, err_msg=k)


@pytest.mark.parametrize("kernels", [False, True])
def test_sgd_step_matches_jax(kernels):
    jstate, jmetrics, state, metrics = run_both(kernels, "sgd")
    _assert_metrics_match(jmetrics, metrics, kernels)
    _assert_state_matches(jstate, state)
    assert state.step == 1 and int(jstate.step) == 1


@pytest.mark.parametrize("kernels", [False, True])
def test_nadam_step_loss_matches_jax(kernels):
    """Two nadam steps; the second step's loss follows the first update.
    That update is about lr * sign(g) per element (mu_hat / sqrt(nu_hat) at
    count 1), so an element whose gradient is near 0 and differs in sign
    in its last bits moves the other way. A nadam step moves an element by
    at most about 2 lr, so over two steps such an element may part by 8 lr;
    the rest agree to 1e-5, and the next loss to 1e-4."""
    jstate, jmetrics, state, metrics = run_both(kernels, "nadam", steps=2)
    _assert_metrics_match(jmetrics, metrics, kernels, tol=1e-4)
    want = flax_to_torch(jax.device_get(jstate.params),
                         jax.device_get(jstate.batch_stats), state.model)
    got = state.model.state_dict()
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel()
                            for k in want])
    lr = 1e-4
    assert diffs.max() <= 8 * lr + 1e-5
    assert np.mean(diffs <= 1e-5) > 0.99


@pytest.mark.parametrize("kernels", [False, True])
def test_grad_accum_and_ema_match_jax(kernels):
    jstate, jmetrics, state, metrics = run_both(kernels, "sgd", accum=2,
                                                ema=0.9)
    _assert_metrics_match(jmetrics, metrics, kernels)
    _assert_state_matches(jstate, state)
    ema = flax_to_torch(jax.device_get(jstate.ema_params),
                        jax.device_get(jstate.batch_stats))
    for k, v in state.ema.items():
        np.testing.assert_allclose(v.numpy(), ema[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_updated_jax_state_converts_to_the_port_state_dict():
    """After a JAX step the flax params and batch stats still convert to
    the keys and shapes of the port's model, and the batch stats moved."""
    jcfg = _cfg(False, "nadam")
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    images, boxes, valid = _batch()
    new, _ = jax.jit(jloop.make_train_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jax.random.PRNGKey(1))
    tcfg, state = _port_state(jcfg, new)
    sd = flax_to_torch(jax.device_get(new.params),
                       jax.device_get(new.batch_stats), state.model)
    assert {k: v.shape for k, v in sd.items()} == {
        k: v.shape for k, v in state.model.state_dict().items()}
    assert not torch.equal(sd["backbone.blocks.0.bn.running_mean"],
                           torch.zeros(16))


def test_port_draws_follow_seed_and_step():
    jcfg = _cfg(True, "sgd")
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    images, boxes, valid = _batch()
    step = make_train_step(tcfg)

    def losses(seed):
        state = create_train_state(tcfg, torch.Generator().manual_seed(3),
                                   device="cpu")
        set_learning_rate(state, 0.0)  # the weights stay; only draws move
        out = [float(step(state, images, boxes, valid, seed)[1]["total"])
               for _ in range(2)]
        assert state.step == 2
        return out

    a, b = losses(5), losses(5)
    assert a == b and a[0] != a[1]
    assert losses(6)[0] != a[0]


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(tconfig.tiny_cpu_config())


@pytest.mark.parametrize("section,override,error,match", [
    ("model", {"remat": True}, NotImplementedError, "ROADMAP 1.7"),
    ("model", {"freeze_backbone": True}, NotImplementedError, "ROADMAP 1.7"),
    ("model", {"bn_mode": "mxu"}, NotImplementedError, "ROADMAP 1.9"),
    ("model", {"bn_mode": "flax@2"}, NotImplementedError, "ROADMAP 1.9"),
    ("data", {"mosaic_prob": 0.5}, NotImplementedError, "ROADMAP 1.12"),
    ("data", {"mixup_prob": 0.5}, NotImplementedError, "ROADMAP 1.12"),
    ("train", {"multiscale_sizes": (224, 256)}, NotImplementedError,
     "ROADMAP 1.12"),
    ("train", {"optimizer": "adamw"}, NotImplementedError, "ROADMAP 1.7"),
    ("train", {"optimizer": "sgdw"}, NotImplementedError, "ROADMAP 1.7"),
    ("train", {"box_loss_mode": "ciou"}, NotImplementedError, "ROADMAP 1.16"),
    ("train", {"optimizer": "lamb"}, ValueError, "unknown optimizer"),
    ("train", {"ignore_threshold": 0.5}, ValueError, "anchor/fpn"),
])
def test_unported_training_switches_raise(section, override, error, match):
    cfg = tconfig.tiny_cpu_config()
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **override)})
    with pytest.raises(error, match=match):
        make_train_step(cfg)
    with pytest.raises(error, match=match):
        create_train_state(cfg, device="cpu")


def _sgd_update_spread(backbone, size, batch):
    """Largest relative change, over the parameter tensors, of one SGD
    step's update when the weights move by 1e-6 relative."""
    cfg = tconfig.tiny_cpu_config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone=backbone,
                                       image_size=size),
        train=dataclasses.replace(cfg.train, optimizer="sgd"))
    images, boxes, valid = _batch(1, batch, size)
    updates = []
    for nudge in (False, True):
        state = create_train_state(cfg, torch.Generator().manual_seed(2),
                                   device="cpu")
        if nudge:
            noise = torch.Generator().manual_seed(9)
            with torch.no_grad():
                for p in state.model.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=noise))
        before = {k: v.clone() for k, v in state.model.named_parameters()}
        make_train_step(cfg)(state, images, boxes, valid, 11)
        updates.append({k: v.detach() - before[k]
                        for k, v in state.model.named_parameters()})
    return max(((updates[0][k] - updates[1][k]).abs().max()
                / updates[0][k].abs().max()).item()
               for k in updates[0] if not k.endswith("conv.bias"))


def test_step_conditioning():
    """Why the GPU-vs-CPU train checks use darknet_micro @56: at a random
    init darknet_tiny @224's SGD update is ill-conditioned (a 1e-6 change
    of the weights moves it by more than 1e-2), darknet_micro @56's moves
    by less than 1e-3.
    Conv biases feed a training-mode BatchNorm, so their gradient is zero
    up to rounding and is left out."""
    assert _sgd_update_spread("darknet_micro", 56, 4) < 1e-3
    assert _sgd_update_spread("darknet_tiny", 224, 8) > 1e-2


def test_routing_replay_removes_a_max_pool_flip():
    """chip_smoke.routing, which the GPU-vs-CPU gradient checks use: a 1e-7
    relative change of the input flips one max-pool near-tie of this batch
    (1 of 652,288 ReLU and max-pool decisions), which moves that window's
    gradient to a neighbouring pixel and the first conv's weight gradient
    by over 1e-3 in norm; replaying the first forward's routing brings
    every gradient back within 1e-5."""
    from chip_smoke import (routing, routing_differences, synthetic_batch,
                            tiny_train_config)
    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data.augment import (augment_batch,
                                                           sample_augment_draws)
    from keras_object_detection_torch.ops.yolo_loss import fused_yolo_v1_loss
    from keras_object_detection_torch.train.loop import step_generator

    cfg = tiny_train_config()
    g, d, t = cfg.grid, cfg.data, cfg.train
    images, boxes, valid = synthetic_batch(4, 56, 8, "cpu")
    draws = sample_augment_draws(4, step_generator(11, 0), tuple(d.color_jitter),
                                 tuple(d.crop_scale), tuple(d.crop_ratio))
    x, aboxes, avalid = augment_batch(
        images, boxes, valid, draws, hflip_prob=d.hflip_prob,
        color_strengths=tuple(d.color_jitter), crop_ratio=tuple(d.crop_ratio),
        min_visibility=d.min_visibility, out_size=56)
    y_true = encode_grid(aboxes, avalid, g.num_classes, g.num_boxes, g.grid)
    nudged = x * (1 + 1e-7 * torch.randn(
        x.shape, generator=torch.Generator().manual_seed(5)))

    def grads(images, route, replay):
        state = create_train_state(cfg, torch.Generator().manual_seed(1),
                                   device="cpu")
        with routing(route, replay):
            y_pred = state.model(images)
        fused_yolo_v1_loss(y_true, y_pred, g.num_classes, g.num_boxes,
                           t.lambda_coord, t.lambda_noobj,
                           t.noobj_mode).backward()
        return {k: p.grad for k, p in state.model.named_parameters()
                if not k.endswith("conv.bias")}

    def worst(a, b):
        return max((torch.linalg.vector_norm(a[k] - b[k])
                    / torch.linalg.vector_norm(b[k])).item() for k in b)

    route, own = [], []
    want = grads(x, route, False)
    flipped = grads(nudged, own, False)
    assert routing_differences(own, route) == (1, 652288)
    assert worst(flipped, want) > 1e-3
    assert worst(grads(nudged, route, True), want) < 1e-5
