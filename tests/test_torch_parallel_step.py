"""The port's data-parallel train step over 2 gloo ranks on the CPU against
JAX's ``make_train_step`` jitted over a 2-device mesh (conftest's fake CPU
devices: the batch on ``batch_sharding``, the state replicated), on
``darknet_micro`` @56 (C=3, a global batch of 4, 2 a rank, float32, SGD),
from the same weights (``flax_to_torch``) and JAX's own draws of the
global batch, each rank taking its rows.

Cases: every BatchNorm mode (``flax``, ``mxu``, ``flax@1``, whose first
row lies on rank 0, ``flax@3``, whose rows cross into rank 1, and
``fused`` through the plain versions of K2/K3, with the fused loss through
K4/K5's). One module-scoped fixture runs every case in one group of
ranks.

Tolerances: every parameter and running statistic to 1e-5, as
``test_torch_train.py``; the loss terms to 2e-5 relative (there 1e-5):
JAX's own mesh step moves its object loss 1.1e-5 from its single-device
step on these inputs (4.770174 against 4.770120; the port's two ranks
4.770097, its one process 4.770100), the float32 sums cut and reordered
over the two devices. The two ranks' states are bit-equal (the all-reduce
hands every rank the same sums)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from keras_object_detection_tpu.parallel.mesh import (batch_sharding,
                                                      create_mesh,
                                                      replicated_sharding)
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.parallel import distributed
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _batch, _cfg, _jax_draws, _port_state)

METRIC_TOL = 2e-5  # the mesh's reorder of float32 sums (module docstring)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

RNG = jax.random.PRNGKey(7)


def jax_mesh_step(jcfg, jstate, batch, steps=1):
    """JAX's train step jitted over a 2-device data-parallel mesh:
    ``(state, metrics)`` after ``steps`` steps on ``batch``."""
    mesh = create_mesh(data_parallel=2, devices=jax.devices()[:2])
    bs = batch_sharding(mesh)
    state = jax.device_put(jstate, replicated_sharding(mesh))
    step = jax.jit(jloop.make_train_step(jcfg))
    args = [jax.device_put(jnp.asarray(x), bs) for x in batch]
    for _ in range(steps):
        state, metrics = step(state, *args, RNG)
    return jax.device_get(state), jax.device_get(metrics)


def run_ranks(kind, payload, tmp, world=2):
    """``payload`` to ``world`` gloo ranks of ``tests/torch_parallel_worker.py``
    (``kind`` "steps" or "fit"); their outputs by name and rank."""
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "job.pt")
    torch.save(dict(payload, kind=kind, out=tmp), path)
    rc = distributed.launch_local("tests.torch_parallel_worker", [path], world)
    assert rc == 0, f"a rank exited with {rc}"
    return {f[:-3]: torch.load(os.path.join(tmp, f), weights_only=False)
            for f in os.listdir(tmp) if f.endswith(".pt") and f != "job.pt"}


def with_bn(jcfg, bn_mode):
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, bn_mode=bn_mode))


def step_case(jcfg, steps=1, batch=None, draws=None, port_cfg=None,
              jstate0=None):
    """JAX's mesh step of ``jcfg`` and the job the ranks run for it."""
    if jstate0 is None:
        jstate0 = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate0)
    if port_cfg is not None:
        tcfg = port_cfg(tcfg)
    batch = batch if batch is not None else _batch()
    accum = max(jcfg.train.grad_accum_steps, 1)
    if draws is None:
        draws = [_jax_draws(jcfg, RNG, i, accum, 4) for i in range(steps)]
    jstate, jmetrics = jax_mesh_step(jcfg, jstate0, batch, steps)
    job = {"config": tcfg.to_json(), "state_dict": state.model.state_dict(),
           "batch": tuple(torch.from_numpy(x) for x in batch),
           "draws": draws}
    return (jstate, jmetrics, state), job


def loaded(template, result):
    """``template`` (a port ``TrainState``) holding a rank's result."""
    template.model.load_state_dict(result["state_dict"])
    template.ema = result["ema"]
    return template


CASES = {
    "bn_flax": lambda: _cfg(False, "sgd"),
    "bn_mxu": lambda: with_bn(_cfg(False, "sgd"), "mxu"),
    "bn_flax@1": lambda: with_bn(_cfg(False, "sgd"), "flax@1"),
    "bn_flax@3": lambda: with_bn(_cfg(False, "sgd"), "flax@3"),
    # bn_mode "fused" (K2/K3's plain versions) with the fused loss (K4/K5's)
    "fused": lambda: _cfg(True, "sgd"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_steps"))
    want, jobs = {}, {}
    for name, make in CASES.items():
        want[name], jobs[name] = step_case(make())
    return want, run_ranks("steps", {"cases": jobs}, tmp)


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_jax_mesh_step(ranks, case):
    (jstate, jmetrics, template), got = ranks[0][case], ranks[1][f"{case}_0"]
    metrics = {k: torch.tensor(v) for k, v in got["metrics"][-1].items()}
    _assert_metrics_match(jmetrics, metrics, case == "fused",
                          tol=METRIC_TOL)
    _assert_state_matches(jstate, loaded(template, got))


@pytest.mark.parametrize("case", CASES)
def test_dp_ranks_hold_the_same_state(ranks, case):
    a, b = ranks[1][f"{case}_0"], ranks[1][f"{case}_1"]
    assert a["metrics"] == b["metrics"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    # the BatchNorms' sums, one flat gradient all-reduce and one of the
    # metrics a step; no gather without mosaic or mixup
    assert a["counts"]["gathers"] == 0 and a["counts"]["all_reduces"] > 2
