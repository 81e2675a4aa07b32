"""The port's data-parallel train step over 2 gloo ranks against JAX's
``make_train_step`` on a 2-device mesh (as ``test_torch_parallel_step.py``)
on the rest of the recipe: ``grad_accum_steps=2`` with an EMA on the
kernels' path (microbatch i is rows ``i::2`` of each rank's block, the
draws of global microbatch i cut by rank), mosaic and mixup (their
partners drawn over the global batch, which each rank gathers), the micro
FPN (``darknet_micro``, 2 scales, fused BatchNorm) and ``remat``
(the recompute sums its statistics over the ranks again).

Tolerances: as ``test_torch_train.py`` (1e-5) for the state, 2e-5 for
the loss terms (the mesh's own reorder, ``test_torch_parallel_step.py``);
mosaic and mixup as ``test_torch_recipe_augment.py``: JAX's mesh step
against the ranks fed JAX's composed batch (2e-5), and the ranks with
the arms on (the gathered batch) against the port's one-process step on
the same draws (1e-5); the FPN step as ``test_torch_fpn_train.py``
(losses 1e-4, updates 2e-2 of their norm: its 1024-wide BatchNorm
backward cancels three to four digits)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch.models import flax_to_torch
from keras_object_detection_torch.train import StepDraws, make_train_step
from test_torch_fpn_train import _assert_step_matches, fpn_jcfg, jax_state
from test_torch_parallel_step import (METRIC_TOL, RNG, loaded, run_ranks,
                                      step_case)
from test_torch_recipe_augment import (_recipe_jcfg, _without_arms,
                                       jax_composed, jax_step_draws)
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _batch, _cfg, _port_state)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _remat(jcfg):
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, remat=True, remat_policy="full"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_recipe"))
    want, jobs = {}, {}
    want["accum2_ema"], jobs["accum2_ema"] = step_case(
        _cfg(True, "sgd", accum=2, ema=0.9))
    want["remat"], jobs["remat"] = step_case(_remat(_cfg(True, "sgd")))
    jcfg = fpn_jcfg("fused")
    jstate0 = jax_state(jcfg, 0)
    want["fpn"], jobs["fpn"] = step_case(jcfg, jstate0=jstate0)
    want["fpn"] += (jstate0,)
    # mosaic + mixup: JAX's mesh step; the ranks on JAX's composed batch
    # with the arms off, and on the raw batch with the arms on
    jcfg = _recipe_jcfg(0.75, 0.5, 1, False)
    batch = _batch()
    composed = jax_composed(jcfg, RNG, 0, *batch)
    full = jax_step_draws(jcfg, RNG, 0, 4)
    want["mosaic_mixup"], jobs["mosaic_mixup"] = step_case(
        jcfg, batch=batch, draws=[[StepDraws(x.augment) for x in full]],
        port_cfg=_without_arms)
    jobs["mosaic_mixup"]["batch"] = tuple(torch.from_numpy(x)
                                          for x in composed)
    arms = dict(jobs["mosaic_mixup"], batch=tuple(
        torch.from_numpy(x) for x in batch), draws=[full])
    arms["config"] = _port_state(jcfg, jloop.create_train_state(
        jcfg, jax.random.PRNGKey(0)))[0].to_json()
    jobs["mosaic_mixup_arms"] = arms
    return want, run_ranks("steps", {"cases": jobs}, tmp), (jcfg, batch, full)


@pytest.mark.parametrize("case", ["accum2_ema", "remat", "mosaic_mixup"])
def test_dp_recipe_step_matches_jax_mesh_step(ranks, case):
    (jstate, jmetrics, template), got = ranks[0][case], ranks[1][f"{case}_0"]
    kernels = case != "mosaic_mixup"
    metrics = {k: torch.tensor(v) for k, v in got["metrics"][-1].items()}
    _assert_metrics_match(jmetrics, metrics, kernels, tol=METRIC_TOL)
    _assert_state_matches(jstate, loaded(template, got),
                          tol=2e-5 if case == "mosaic_mixup" else 1e-5)
    if case == "accum2_ema":
        ema = flax_to_torch(jstate.ema_params, jstate.batch_stats)
        for k, v in got["ema"].items():
            np.testing.assert_allclose(v.numpy(), ema[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_dp_fpn_step_matches_jax_mesh_step(ranks):
    jstate, jmetrics, template, jstate0 = ranks[0]["fpn"]
    state0 = {k: t.clone() for k, t in template.model.state_dict().items()}
    got = ranks[1]["fpn_0"]
    metrics = {k: torch.tensor(v) for k, v in got["metrics"][-1].items()}
    _assert_step_matches(jstate0, jstate, state0, loaded(template, got),
                         jmetrics, metrics)


def test_dp_mosaic_mixup_gathers_the_global_batch(ranks):
    """With the arms on, each rank gathers the global batch, composes it
    with the global draws and keeps its rows: the one-process step on the
    same batch and draws."""
    jcfg, batch, full = ranks[2]
    got = ranks[1]["mosaic_mixup_arms_0"]
    assert got["counts"]["gathers"] == 3  # images, boxes, valid
    tcfg, state = _port_state(jcfg, jloop.create_train_state(
        jcfg, jax.random.PRNGKey(0)))
    state, metrics = make_train_step(tcfg)(state, *batch, seed=0, draws=full)
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][0][k], float(v), rtol=1e-5,
                                   err_msg=k)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["accum2_ema", "remat", "fpn", "mosaic_mixup",
                                  "mosaic_mixup_arms"])
def test_dp_recipe_ranks_hold_the_same_state(ranks, case):
    a, b = ranks[1][f"{case}_0"], ranks[1][f"{case}_1"]
    assert a["metrics"] == b["metrics"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
