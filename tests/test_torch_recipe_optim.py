"""The port's decoupled-weight-decay optimizers (``adamw`` and ``sgdw``,
``train/optim.py``) against the JAX package's own ``_make_optimizer``
(``optax.adamw`` and ``add_decayed_weights`` + ``optax.sgd(momentum=0.9)``
under ``inject_hyperparams``): 12 steps with a learning-rate swap halfway,
to 1e-7 relative and absolute (one float32 rounding apart at most, as
``tests/test_torch_optim.py`` holds adam, nadam and sgd). Then two whole
train steps with each against JAX's (``tests/test_torch_train.py``'s
darknet_micro step, weight decay 1e-4; tolerances at each test), a frozen
backbone's zero gradients that still decay, and the checkpoint round trip of the new state (the momentum trace,
the weight decay).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch.train import (CheckpointManager,
                                                create_train_state,
                                                make_train_step, optim)
from test_torch_checkpoint import _cfg as ckpt_cfg
from test_torch_checkpoint import _tensors, _trained_state
from test_torch_optim import _problem
from keras_object_detection_torch.models import flax_to_torch
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _batch, _cfg, _jax_draws, _port_state)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["adamw", "sgdw"])
@pytest.mark.parametrize("seed,wd", [(0, 1e-4), (1, 5e-2)])
def test_decoupled_optimizers_match_optax(name, seed, wd):
    params, grads = _problem(seed)
    tx = jloop._make_optimizer(name, 1e-3, wd)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = optim.init_opt_state(name, tparams, 1e-3, wd)
    for i, g in enumerate(grads):
        if i == len(grads) // 2:  # the swap: no re-init on either side
            jstate.hyperparams["learning_rate"] = jnp.asarray(3e-4, jnp.float32)
            optim.set_learning_rate(tstate, 3e-4)
        updates, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optim.apply_updates(tstate, tparams, [torch.from_numpy(x) for x in g])
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-7)
    assert tstate.count == len(grads)
    if name == "sgdw":  # optax's trace is the port's
        jtrace = jstate.inner_state[1][0].trace
        for got, want in zip(tstate.trace, jtrace):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def _run(kernels, optimizer, lr, steps=2):
    """``test_torch_train.run_both`` at learning rate ``lr``."""
    jcfg = _cfg(kernels, optimizer, lr=lr)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate)
    images, boxes, valid = _batch()
    jstep = jax.jit(jloop.make_train_step(jcfg))
    step = make_train_step(tcfg)
    rng = jax.random.PRNGKey(7)
    for i in range(steps):
        jstate, jmetrics = jstep(jstate, jnp.asarray(images),
                                 jnp.asarray(boxes), jnp.asarray(valid), rng)
        state, metrics = step(state, images, boxes, valid, seed=0,
                              draws=_jax_draws(jcfg, rng, i, 1, 4))
    return jstate, jmetrics, state, metrics


def test_sgdw_step_matches_jax():
    """Two steps of the plain path, so the second reads the momentum
    trace: every parameter and running statistic to 1e-5, the second
    step's terms (after an update) to 1e-4, as nadam's. At lr 1e-6: at a
    random init darknet_micro amplifies float32 rounding from step to step
    (see ``tests/test_torch_fit.py``), and at 1e-4 two steps part the first
    layer's weights by 2.4e-4."""
    jstate, jmetrics, state, metrics = _run(False, "sgdw", 1e-6)
    _assert_metrics_match(jmetrics, metrics, False, tol=1e-4)
    _assert_state_matches(jstate, state)


def test_adamw_step_loss_matches_jax():
    """On the kernels' path, as
    ``test_torch_train.test_nadam_step_loss_matches_jax``: adamw's
    first update is about lr * sign(g) per element, so an element whose
    gradient is near 0 and differs in sign in its last bits moves the other
    way; over two steps such an element may part by 8 lr, the rest agree to
    1e-5, and the second step's loss to 1e-4."""
    lr = 1e-4
    jstate, jmetrics, state, metrics = _run(True, "adamw", lr)
    _assert_metrics_match(jmetrics, metrics, True, tol=1e-4)
    want = flax_to_torch(jax.device_get(jstate.params),
                         jax.device_get(jstate.batch_stats), state.model)
    got = state.model.state_dict()
    diffs = np.concatenate([np.abs(got[k].numpy() - want[k].numpy()).ravel()
                            for k in want])
    assert diffs.max() <= 8 * lr + 1e-5
    assert np.mean(diffs <= 1e-5) > 0.99


def test_frozen_backbone_still_decays():
    """A frozen backbone gets zero gradients; adamw's update is then the
    decay alone, ``p + (-lr) * (wd * p)``, as optax gives it for zero
    gradients (adam's part is 0 / (0 + eps) = 0)."""
    cfg = ckpt_cfg(optimizer="adamw")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, freeze_backbone=True),
        train=dataclasses.replace(cfg.train, weight_decay=0.05))
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    before = {k: v.clone() for k, v in state.model.backbone.named_parameters()}
    images, boxes, valid = _batch(b=2)
    make_train_step(cfg)(state, images, boxes, valid, 3)
    lr, wd = np.float32(1e-4), np.float32(0.05)
    for k, v in state.model.backbone.named_parameters():
        p = before[k].detach().numpy()
        np.testing.assert_array_equal(v.detach().numpy(),
                                      p + (-lr) * (wd * p + np.float32(0.0)),
                                      err_msg=k)
        assert not torch.equal(v, before[k]) or not before[k].any()


@pytest.mark.parametrize("name", ["adamw", "sgdw"])
def test_decoupled_optimizer_state_round_trips(tmp_path, name):
    """The checkpoint holds the trace and the weight decay: a restored
    state is bit-equal, and its next step equals the original's."""
    cfg = ckpt_cfg(str(tmp_path), optimizer=name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, weight_decay=3e-3))
    state = _trained_state(cfg)
    manager = CheckpointManager(cfg.train.checkpoint_dir)
    manager.save(1, state, {"val_loss": 1.0})
    template = create_train_state(cfg, torch.Generator().manual_seed(9),
                                  device="cpu")
    restored = manager.restore(template)
    manager.close()
    assert restored.opt.weight_decay == state.opt.weight_decay == \
        np.float32(3e-3)
    assert len(restored.opt.trace) == (
        0 if name == "adamw" else len(list(state.model.parameters())))
    want = _tensors(state)
    want.update({f"trace.{i}": v for i, v in enumerate(state.opt.trace)})
    got = _tensors(restored)
    got.update({f"trace.{i}": v for i, v in enumerate(restored.opt.trace)})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    images, boxes, valid = _batch(b=2)
    step = make_train_step(cfg)
    step(state, images, boxes, valid, 5)
    step(restored, images, boxes, valid, 5)
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
