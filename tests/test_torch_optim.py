"""Parity of the port's optimizers and schedules with the JAX package's.

The optimizers (``train/optim.py``) against ``optax.inject_hyperparams`` of
``optax.adam`` / ``optax.nadam`` / ``optax.sgd`` on a fixed sequence of
gradients, with a learning-rate swap halfway, to 1e-7 (relative and
absolute: an element may land one float32 rounding from optax's, 1.2e-7
relative at most, where XLA's eager kernels and torch's round differently).
The schedules
(``train/schedules.py``) against the JAX package's and the executed
reference's goldens (``tests/golden/schedule_goldens.json``).
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_object_detection_tpu.config import ScheduleConfig as JScheduleConfig
from keras_object_detection_tpu.train import schedules as jsched
from keras_object_detection_torch.config import ScheduleConfig
from keras_object_detection_torch.train import optim, schedules

GOLDEN = pathlib.Path(__file__).parent / "golden" / "schedule_goldens.json"


def _problem(seed, steps=12):
    rng = np.random.RandomState(seed)
    shapes = [(3, 4), (5,), (2, 2, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * rng.choice([1e-4, 1.0, 30.0])).astype(np.float32)
              for s in shapes] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("name", ["adam", "nadam", "sgd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_optimizer_matches_optax(name, seed):
    params, grads = _problem(seed)
    tx = optax.inject_hyperparams(getattr(optax, name))(learning_rate=1e-3)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)

    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = optim.init_opt_state(name, tparams, 1e-3)
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
    assert tstate.count == int(jstate.inner_state[0].count) if name != "sgd" \
        else tstate.count == len(grads)


def test_nadam_is_not_torch_nadam():
    """Why the port writes nadam by hand: torch.optim.NAdam parts from
    optax.nadam, while the port's nadam stays with it."""
    params, grads = _problem(2, steps=3)
    tx = optax.inject_hyperparams(optax.nadam)(learning_rate=1e-3)
    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    mine = [torch.from_numpy(p.copy()) for p in params]
    state = optim.init_opt_state("nadam", mine, 1e-3)
    theirs = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = torch.optim.NAdam(theirs, lr=1e-3)
    for g in grads:
        u, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, u)
        optim.apply_updates(state, mine, [torch.from_numpy(x) for x in g])
        for p, x in zip(theirs, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    gap_torch = max(np.abs(p.detach().numpy() - np.asarray(q)).max()
                    for p, q in zip(theirs, jp))
    gap_mine = max(np.abs(p.numpy() - np.asarray(q)).max() for p, q in zip(mine, jp))
    assert gap_torch > 1e-4 and gap_mine < 1e-6


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.init_opt_state("rmsprop", [torch.zeros(2)], 1e-3)


@pytest.mark.parametrize("kind,kw", [
    ("constant", {"base_lr": 0.5}),
    ("piecewise_warmup", {}),
    ("piecewise_warmup", {"base_lr": 2e-3, "warmup_epochs": 10, "mid_epochs": 20}),
    ("cosine_restarts", {"base_lr": 1e-3, "t_max": 5, "t_mult": 2, "decay": 0.7}),
])
def test_epoch_schedule_matches_jax(kind, kw):
    got = schedules.epoch_schedule(ScheduleConfig(kind=kind, **kw), 200)
    want = jsched.epoch_schedule(JScheduleConfig(kind=kind, **kw), 200)
    np.testing.assert_array_equal(got, want)


def test_cosine_restarts_match_reference_goldens():
    cases = json.load(open(GOLDEN))
    assert cases
    for case in cases:
        p = case["params"]
        got = schedules.cosine_annealing_restarts_lrs(
            p["num_epochs"], p["eta_max"], p["eta_min"], p["t_max"],
            p["t_mult"], p["decay"])
        np.testing.assert_allclose(got, case["lrs"], rtol=1e-6, atol=1e-12)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown schedule"):
        schedules.epoch_schedule(ScheduleConfig(kind="linear"), 3)
