"""The port's tensor parallelism (``parallel/tensor.py``: column-parallel
``Conv2d`` / ``Dense``, BatchNorm on channel shards, the dp x tp step,
``Trainer.fit`` and its whole-tensor checkpoints, the device cache and
serving on a 2-axis mesh) against the JAX package's ``state_sharding`` on
conftest's fake CPU devices.

- **Sharded leaves.** ``state_sharding`` picks exactly JAX's 39 leaves of
  the flagship's nadam state (13 kernels, their ``mu`` and ``nu``), mapped
  by name through ``flax_to_torch``; shapes only (``jax.eval_shape``, the
  port's model on the meta device).
- **The step.** One module-scoped group of 4 gloo ranks, a (2 data, 2
  model) mesh, ``darknet_micro`` @56 (C=3, a global batch of 4, 2 a data
  rank, float32), ``min_elements`` lowered to 4096 so that four convs (and
  with the ``gap_dense`` head its first Dense kernel) shard, against JAX's
  ``make_train_step`` jitted over a (2, 2) mesh with ``state_sharding(
  min_elements=4096)`` in and out, from the same weights and JAX's own
  draws. Every BatchNorm mode (``flax``, ``mxu``, ``flax@1``, ``flax@3``,
  ``fused`` through K2/K3's plain versions with the fused loss through
  K4/K5's), SGD: parameters and running statistics to 1e-5 (as
  ``test_torch_train.py``), loss terms to 2e-5 relative (as
  ``test_torch_parallel_step.py``: the meshes reorder float32 sums). Adam
  (the fused path): the moments ``mu`` and ``nu`` (0.1 g and 0.001 g²) to
  2e-3 of their tensor's norm, or 1e-4 absolute for the conv biases before
  a BatchNorm, whose gradient is 0 up to rounding (the one-process port's
  first-step moments part from JAX's single-device step's by 3.2e-4 to
  4.3e-4 in norm: float32 sums over 4 images of loss ~400); the parameters
  to 2.5 lr, since an Adam update is about ``lr * sign(g)`` and an element
  whose gradient is near 0 and flips sign in its last bits moves the other
  way (``test_torch_train.py``'s nadam reasoning). The rest of the recipe
  under the model axis: ``grad_accum_steps=2`` with an EMA (the EMA to
  1e-5), ``remat``, a frozen backbone (as the steps above), and mosaic
  with mixup (each data rank gathers the global batch; against the port's
  one-process step on the same draws, 1e-5, as
  ``test_torch_parallel_recipe.py``). The four ranks' gathered states are
  bit-equal.
- **Fit and checkpoints.** ``Trainer.fit`` over the (2, 2) ranks against
  JAX's ``Trainer.fit`` on a (2, 2) mesh (``test_torch_parallel_fit.py``'s
  bounds: epochs 1e-4 relative, parameters 1e-4); its whole-tensor
  checkpoint restores into one process bit-equal, and a one-process
  checkpoint restores into the mesh bit-equal.
- **The device cache** on the 2-axis mesh: the sharded layout holds
  ``n_rows / dp`` rows a rank and gathers every batch of two epochs
  bit-equal to the replicated one; the per-device guard as JAX's
  ``tests/test_data.py`` cases.
- **Serving** (``InferenceModel``, ``Int8InferenceModel``, ``Evaluator``)
  on a (2, 2) device mesh of CPU replicas against JAX's (2, 2) mesh
  (``test_torch_sharded_serving.py``'s bounds) and the port's (2, 1) mesh
  (bit-equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.data.pipeline import YoloDataset as JaxDataset
from keras_object_detection_tpu.eval.evaluator import Evaluator as JEvaluator
from keras_object_detection_tpu.eval.evaluator import \
    InferenceModel as JInferenceModel
from keras_object_detection_tpu.parallel.mesh import (batch_sharding,
                                                      create_mesh as
                                                      jcreate_mesh,
                                                      replicated_sharding)
from keras_object_detection_tpu.parallel.mesh import \
    state_sharding as jstate_sharding
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import YoloDataset
from keras_object_detection_torch.data.pipeline import DeviceCachedDataset
from keras_object_detection_torch.eval import Evaluator, InferenceModel
from keras_object_detection_torch.export import Int8InferenceModel
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.parallel import Mesh, create_mesh
from keras_object_detection_torch.parallel.mesh import (TP_MIN_ELEMENTS,
                                                        state_sharding)
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from test_sharded_serving import _setup
from test_torch_data import write_dataset
from test_torch_fit import _jcfg, _load, _logs, _port
from test_torch_parallel_step import (METRIC_TOL, RNG, loaded, run_ranks,
                                      with_bn)
from test_torch_recipe_augment import _recipe_jcfg, jax_step_draws
from test_torch_sharded_serving import clean_images, live
from test_torch_train import (_assert_metrics_match, _assert_state_matches,
                              _batch, _cfg, _jax_draws, _port_state)

MIN_ELEMENTS = 4096  # four of darknet_micro's convs and the GAP Dense_0


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_tp_mesh():
    return jcreate_mesh(data_parallel=2, model_parallel=2,
                        devices=jax.devices()[:4])


def _sharded_paths(shardings):
    """The key paths of the leaves a sharding tree places on an axis."""
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return [path for path, s in flat if any(p is not None for p in s.spec)]


def _keys(path):
    return [getattr(k, "key", getattr(k, "name", getattr(k, "idx", None)))
            for k in path]


def test_state_sharding_picks_jax_s_flagship_leaves():
    """The flagship's nadam state at 448²: JAX shards 39 leaves on a (2, 2)
    mesh, the port's rule the same 39 under their converted names."""
    jcfg = jconfig.voc_full_config()
    shapes = jax.eval_shape(
        lambda: jloop.create_train_state(jcfg, jax.random.PRNGKey(0)))
    jpaths = _sharded_paths(jstate_sharding(jax_tp_mesh(), shapes))
    assert len(jpaths) == 39
    # each sharded leaf: (kind, the parameter path below params / mu / nu)
    want = set()
    for path in jpaths:
        keys = _keys(path)
        kind = next(k for k in keys if k in ("params", "mu", "nu"))
        want.add((kind, tuple(keys[keys.index(kind) + 1:])))
    # the port's names of those parameter paths: flax_to_torch on stand-in
    # leaves whose value is their index
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes.params)
    paths = [tuple(_keys(p)) for p, _ in flat]
    stand_in = flax_to_torch(
        jax.tree_util.tree_unflatten(treedef, [
            np.full((1,) * len(leaf.shape), i, np.float32)
            for i, (_, leaf) in enumerate(flat)]),
        jax.tree_util.tree_map(lambda x: np.zeros((1,), np.float32),
                               shapes.batch_stats))
    name_of = {paths[int(v.reshape(-1)[0])]: k for k, v in stand_in.items()
               if not k.endswith(("running_mean", "running_var"))}
    want = {(kind, name_of[p]) for kind, p in want}

    cfg = tconfig.voc_full_config()
    with torch.device("meta"):
        model = build_model(cfg, torch.Generator())
    params = dict(model.named_parameters())
    tree = {"params": params, "mu": params, "nu": params}
    mesh = Mesh(2, 2, group=object())
    specs = state_sharding(mesh, tree, "model", TP_MIN_ELEMENTS)
    got = {(kind, name) for kind, sub in specs.items()
           for name, spec in sub.items() if spec}
    assert got == want
    sharded = {n for _, n in got}
    assert len(sharded) == 13
    assert all(specs["params"][n] == ("model", None, None, None)
               for n in sharded)
    assert sum(params[n].numel() for n in sharded) == 67_239_936
    assert sum(p.numel() for p in params.values()) == 69_653_342


def test_state_sharding_rule():
    mesh = Mesh(2, 2, group=object())
    tree = {"conv": torch.empty(64, 3, 3, 3), "odd": torch.empty(63, 64),
            "small": torch.empty(8, 8), "bias": torch.empty(4096),
            "step": torch.tensor(3)}
    assert state_sharding(mesh, tree, min_elements=1024) == {
        "conv": ("model", None, None, None), "odd": (), "small": (),
        "bias": (), "step": ()}
    assert state_sharding(Mesh(4), tree, min_elements=1) == {
        k: () for k in tree}


def test_mesh_layout_is_row_major_as_jax_s():
    """A device mesh lays its positions data-major, as ``mesh_utils``
    lays ``(dp, tp)``; serving uses each data row's first device."""
    mesh = create_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    jmesh = jax_tp_mesh()
    assert [d.id for d in jmesh.devices.reshape(-1)] == [0, 1, 2, 3]
    assert mesh.data_devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="mesh 3x2 != 4 devices"):
        create_mesh(3, 2, devices=["cpu"] * 4)


def tp_step_job(jcfg, steps=1):
    """JAX's (2, 2) mesh step of ``jcfg`` with ``state_sharding(
    min_elements=MIN_ELEMENTS)`` and the job the ranks run for it."""
    jstate0 = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate0)
    batch = _batch()
    accum = max(jcfg.train.grad_accum_steps, 1)
    draws = [_jax_draws(jcfg, RNG, i, accum, 4) for i in range(steps)]
    mesh = jax_tp_mesh()
    shardings = jstate_sharding(mesh, jstate0, min_elements=MIN_ELEMENTS)
    jstate = jax.device_put(jstate0, shardings)
    step = jax.jit(jloop.make_train_step(jcfg),
                   out_shardings=(shardings, replicated_sharding(mesh)))
    args = [jax.device_put(jnp.asarray(x), batch_sharding(mesh))
            for x in batch]
    for _ in range(steps):
        jstate, jmetrics = step(jstate, *args, RNG)
    sharded = len(_sharded_paths(shardings))
    want = (jax.device_get(jstate), jax.device_get(jmetrics), state, sharded)
    job = {"config": tcfg.to_json(), "state_dict": state.model.state_dict(),
           "batch": tuple(torch.from_numpy(x) for x in batch),
           "draws": draws}
    return want, job


def model_with(jcfg, **model):
    return dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, **model))


CASES = {
    "bn_flax": lambda: _cfg(False, "sgd"),
    "bn_mxu": lambda: with_bn(_cfg(False, "sgd"), "mxu"),
    "bn_flax@1": lambda: with_bn(_cfg(False, "sgd"), "flax@1"),
    "bn_flax@3": lambda: with_bn(_cfg(False, "sgd"), "flax@3"),
    # bn_mode "fused" (K2/K3's plain versions) with the fused loss (K4/K5's)
    "fused": lambda: _cfg(True, "sgd"),
    "gap_dense": lambda: model_with(_cfg(False, "sgd"), head="gap_dense"),
    "fused_adam": lambda: _cfg(True, "adam"),
    "accum2_ema": lambda: _cfg(True, "sgd", accum=2, ema=0.9),
    "remat": lambda: model_with(_cfg(True, "sgd"), remat=True,
                                remat_policy="full"),
    "frozen": lambda: model_with(_cfg(False, "sgd"), freeze_backbone=True),
}
SHARDED = {"backbone.blocks.1.conv.weight", "backbone.blocks.2.conv.weight",
           "backbone.blocks.3.conv.weight"}


@pytest.fixture(scope="module")
def six(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("six"), 6, seed=1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, six):
    """Every case's JAX step and the ranks' run of all of them, JAX's
    (2, 2) ``Trainer.fit`` and the ranks' fit, and a one-process
    checkpoint the ranks restore: one group of 4 ranks."""
    tmp = tmp_path_factory.mktemp("tp")
    want, jobs = {}, {}
    for name, make in CASES.items():
        want[name], jobs[name] = tp_step_job(make())
    # mosaic + mixup on: the ranks against the port's one-process step on
    # the same batch and draws (test_dp_mosaic_mixup_gathers_the_global_batch)
    jcfg = _recipe_jcfg(0.75, 0.5, 1, False)
    tcfg, state = _port_state(jcfg, jloop.create_train_state(
        jcfg, jax.random.PRNGKey(0)))
    draws = jax_step_draws(jcfg, RNG, 0, 4)
    jobs["mosaic_mixup"] = {
        "config": tcfg.to_json(),
        "state_dict": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
        "batch": tuple(torch.from_numpy(x) for x in _batch()),
        "draws": [draws]}
    state, metrics = make_train_step(tcfg)(state, *_batch(), seed=0,
                                           draws=draws)
    want["mosaic_mixup"] = (state, metrics)
    # the fit: JAX's Trainer on a (2, 2) mesh (its default threshold
    # shards nothing of darknet_micro; the port's ranks shard at 4096)
    jcfg = _jcfg(str(tmp / "jax"), lr=1e-6, epochs=2, map_eval_start_epoch=0,
                 map_eval_every=1)
    jtrainer = jloop.Trainer(jcfg, mesh=jax_tp_mesh(), use_tensorboard=False)
    jstate = jtrainer.init_state()
    init = jax.device_get((jstate.params, jstate.batch_stats))
    jstate = jtrainer.fit(JaxDataset(six, 56, 4, max_boxes=8, shuffle=True,
                                     seed=0),
                          JaxDataset(six, 56, 4, max_boxes=8), state=jstate,
                          verbose=False)
    jtrainer.ckpt.close()
    cfg = _port(jcfg, str(tmp / "torch"))
    cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=-1, model_parallel=2))
    # a one-process checkpoint for the ranks to restore
    one = create_train_state(cfg, torch.Generator().manual_seed(3), "cpu")
    saved = CheckpointManager(str(tmp / "one"))
    saved.save(0, one, {"val_loss": 1.0})
    saved.close()
    got = run_ranks("tp", {
        "cases": jobs, "model_parallel": 2, "min_elements": MIN_ELEMENTS,
        "fit_job": {"config": cfg.to_json(), "train": six,
                    "state_dict": flax_to_torch(*init),
                    "restore": str(tmp / "one")}},
        str(tmp / "ranks"), world=4)
    return want, got, (jtrainer, jstate, str(tmp / "jax"), str(tmp / "torch"),
                       cfg, one)


def test_tp_mosaic_mixup_step_equals_one_process(ranks):
    state, metrics = ranks[0]["mosaic_mixup"]
    got = ranks[1]["mosaic_mixup_0"]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][0][k], float(v), rtol=1e-5,
                                   err_msg=k)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_mesh_step(ranks, case):
    (jstate, jmetrics, template, jsharded), got = (ranks[0][case],
                                                   ranks[1][f"{case}_0"])
    metrics = {k: torch.tensor(v) for k, v in got["metrics"][-1].items()}
    _assert_metrics_match(jmetrics, metrics,
                          CASES[case]().train.use_pallas_loss,
                          tol=METRIC_TOL)
    lr = CASES[case]().train.schedule.base_lr
    _assert_state_matches(jstate, loaded(template, got),
                          tol=2.5 * lr if case == "fused_adam" else 1e-5)
    # JAX's sharded leaves: the kernels (and Adam's mu and nu of each)
    kernels = SHARDED | {"head.block.conv.weight" if case != "gap_dense"
                         else "head.denses.0.weight"}
    assert set(got["sharded"]) == kernels
    # JAX's sharded leaves: each kernel, its moments and its EMA copy
    copies = 1 + 2 * (case == "fused_adam") + (case == "accum2_ema")
    assert jsharded == len(kernels) * copies
    if case == "accum2_ema":
        ema = flax_to_torch(jstate.ema_params, jstate.batch_stats)
        for k, v in got["ema"].items():
            np.testing.assert_allclose(v.numpy(), ema[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    if case == "fused_adam":
        inner = [s for s in jax.tree_util.tree_leaves(
            jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
        for field in ("mu", "nu"):
            want = flax_to_torch(getattr(inner, field), jstate.batch_stats)
            for k, v in got["moments"][field].items():
                w = want[k]
                err = float((v - w).norm())
                assert (err <= 2e-3 * float(w.norm())
                        or float((v - w).abs().max()) <= 1e-4), (field, k)


@pytest.mark.parametrize("case", [*CASES, "mosaic_mixup"])
def test_tp_ranks_hold_the_same_state(ranks, case):
    outs = [ranks[1][f"{case}_{r}"] for r in range(4)]
    for other in outs[1:]:
        assert other["metrics"] == outs[0]["metrics"]
        for k, v in outs[0]["state_dict"].items():
            assert torch.equal(v, other["state_dict"][k]), k
    # the column-parallel layers' gathers (activations and running
    # statistics) over the model group
    assert outs[0]["counts"]["gathers"] > 0


def test_tp_fit_matches_jax_mesh_fit(ranks):
    jtrainer, jstate, jdir, tdir, _, _ = ranks[2]
    got = ranks[1]
    mine, want = _logs(tdir), _logs(jdir)
    assert [r["step"] for r in mine] == [r["step"] for r in want]
    for g, w in zip(mine, want):
        for k in ("total", "val_loss", "val_mAP"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert sorted(int(d) for d in os.listdir(os.path.join(tdir, "ckpt"))
                  if d.isdigit()) == jtrainer.ckpt.all_steps
    want_sd = flax_to_torch(*jax.device_get((jstate.params,
                                             jstate.batch_stats)))
    for k, v in got["fit_0"]["state_dict"].items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    for r in (1, 2, 3):
        for k, v in got["fit_0"]["state_dict"].items():
            assert torch.equal(v, got[f"fit_{r}"]["state_dict"][k]), k
        assert got[f"fit_{r}"]["test"] == got["fit_0"]["test"]


def test_tp_checkpoint_restores_into_one_process_and_back(ranks):
    _, _, _, tdir, cfg, one = ranks[2]
    got = ranks[1]
    single = dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=1, model_parallel=1))
    manager = CheckpointManager(os.path.join(tdir, "ckpt"), writer=False)
    restored = manager.restore(create_train_state(single, device="cpu"),
                               step=manager.latest_step)
    manager.close()
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, got["fit_0"]["state_dict"][k]), k
    for r in range(4):
        back = got[f"restore_{r}"]["state_dict"]
        for k, v in one.model.state_dict().items():
            assert torch.equal(v, back[k]), (r, k)


def test_tp_device_cache_on_a_two_axis_mesh(ranks):
    for rank in range(4):
        out = ranks[1][f"fit_{rank}"]
        assert out["cache_equal"] and out["cache_batches"] == 4
        assert out["cache_rows"] == 4  # 6 images + 1 sentinel, 8 over dp 2


def test_device_cache_guard_on_a_two_axis_mesh(six):
    """JAX's ``test_device_cache_guard_layout_aware`` on a (4, 2) mesh: the
    guard budgets per device; a set too large replicated suggests the
    sharded layout, too large even a shard the disk cache."""
    mesh = Mesh(4, 2, group=object())
    ds = YoloDataset(six, 50000, 2, max_boxes=4)
    with pytest.raises(ValueError, match="sharded"):
        DeviceCachedDataset(ds, "cpu", "replicated", mesh)
    ds_huge = YoloDataset(six, 120000, 2, max_boxes=4)
    with pytest.raises(ValueError, match="cache_dir"):
        DeviceCachedDataset(ds_huge, "cpu", "sharded", mesh)


@pytest.fixture(scope="module")
def conv_setup():
    return _setup()


def test_two_axis_serving_matches_jax_and_the_data_axis(conv_setup):
    """``InferenceModel`` over a (2, 2) mesh of CPU replicas: JAX's (2, 2)
    mesh's candidates to 1e-4 and keep sets exact on clean images; the
    port's (2, 1) mesh bit-equal (the model axis replicates the rows)."""
    cfg, params, stats, imgs = conv_setup
    sd = flax_to_torch(params, stats)
    cfg = live(cfg, sd, imgs)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    two = InferenceModel(tcfg, sd, mesh=create_mesh(2, 2,
                                                    devices=["cpu"] * 4))
    one = InferenceModel(tcfg, sd, mesh=create_mesh(2, devices=["cpu"] * 2))
    assert len(two._replicas) == 2
    jtwo = JInferenceModel(cfg, params, stats, mesh=jax_tp_mesh())
    x = clean_images(jtwo, cfg)
    np.testing.assert_allclose(two.predict_decoded(x).numpy(),
                               np.asarray(jtwo.predict_decoded(x)),
                               atol=1e-4, rtol=1e-4)
    want_rows, want_valid = jtwo.predict(x)
    rows, valid = two.predict(x)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert 0 < int(valid.sum()) < valid.numel()
    np.testing.assert_allclose(rows[valid].numpy(), want_rows[want_valid],
                               atol=1e-4, rtol=1e-4)
    rows1, valid1 = one.predict(x)
    assert torch.equal(rows, rows1) and torch.equal(valid, valid1)
    q2 = Int8InferenceModel(tcfg, sd, mesh=create_mesh(
        2, 2, devices=["cpu"] * 4))
    q1 = Int8InferenceModel(tcfg, sd, mesh=create_mesh(
        2, devices=["cpu"] * 2))
    assert torch.equal(q2.predict_raw(imgs), q1.predict_raw(imgs))


def test_two_axis_evaluator_matches_jax(tmp_path, six):
    jcfg = _jcfg(str(tmp_path))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(1))
    want = JEvaluator(jcfg, mesh=jax_tp_mesh()).evaluate(
        jstate, JaxDataset(six, 56, 4, max_boxes=8))
    cfg = _port(jcfg)
    state = _load(create_train_state(cfg, device="cpu"),
                  *jax.device_get((jstate.params, jstate.batch_stats)))
    ds = YoloDataset(six, 56, 4, max_boxes=8)
    got = Evaluator(cfg, mesh=create_mesh(2, 2, devices=["cpu"] * 4)
                    ).evaluate(state, ds)
    one = Evaluator(cfg, mesh=create_mesh(2, devices=["cpu"] * 2)
                    ).evaluate(state, ds)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6
    assert got["mAP"] == one["mAP"] and got["loss"] == one["loss"]


def test_dryrun_step_on_the_two_axis_mesh(ranks):
    """``parallel/dryrun.py``'s step on the ranks' (2, 2) mesh, one image a
    data rank: ``darknet_tiny``'s head conv (3x3x256x1024) and its Adam
    moments sharded (the dry run asserts at least 3 leaves, as JAX's), a
    finite loss, the same on every rank (it checks that itself)."""
    losses = [ranks[1][f"dryrun_{r}"] for r in range(4)]
    assert np.isfinite(losses[0]) and losses == [losses[0]] * 4
