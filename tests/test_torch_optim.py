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

import bisect
import ctypes
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keras_object_detection_tpu.config import ScheduleConfig as JScheduleConfig
from keras_object_detection_tpu.train import schedules as jsched
from keras_object_detection_torch.config import ScheduleConfig
from keras_object_detection_torch.ops import optim_update
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


def _kernel_spans(launch, sizes):
    """What each block of one K6 launch covers, as ``optim_update.cu``
    walks it: its tensor (the binary search over ``chunk_start``), the
    16-byte vectors from its chunk's start up to ``tail`` and the scalars
    from ``tail`` to the chunk's end."""
    cs = launch.chunk_start
    for block in range(cs[-1]):
        i = bisect.bisect_right(cs, block, hi=len(launch.tensors)) - 1
        tensor = launch.tensors[i]
        start = (block - cs[i]) * optim_update.OPT_CHUNK
        end = min(start + optim_update.OPT_CHUNK, sizes[tensor])
        yield tensor, start, start + (end - start) // 4 * 4, end


def _v3_sizes():
    from chip_smoke import optim_shapes

    return [math.prod(s) for s in optim_shapes("yolov3")]


@pytest.mark.parametrize("sizes", [
    [0, 5, 0, 0, 8192, 8193, 0],  # empty tensors among others
    [1, 3, 7, 4097, 16387, 30, 8191],  # lengths no multiple of 4
    [123_456_789],  # a single tensor of many chunks
    [0, 0],  # nothing to update: no launch
    [3] * (optim_update.OPT_MAX_TENSORS + 7),  # more tensors than a launch takes
    "yolov3",  # YOLOv3's 294 parameter tensors
])
def test_optim_launch_plan_covers_every_value_once(sizes):
    if sizes == "yolov3":
        sizes = _v3_sizes()
        assert len(sizes) == 294
    plan = optim_update.optim_launch_plan(tuple(sizes))
    covered = {i: [] for i in range(len(sizes))}
    for launch in plan:
        assert 0 < len(launch.tensors) <= optim_update.OPT_MAX_TENSORS
        assert launch.chunk_start[0] == 0 and launch.chunk_start[-1] < 2 ** 31
        for tensor, start, tail, end in _kernel_spans(launch, sizes):
            assert start % 4 == 0 and (tail - start) % 4 == 0
            assert start <= tail <= end and end - tail < 4
            covered[tensor].append((start, end))
    for i, n in enumerate(sizes):
        spans = sorted(covered[i])
        assert [a for a, _ in spans] == [b for _, b in [(0, 0)] + spans][:-1]
        assert (spans[-1][1] if spans else 0) == n
        assert all(a < b for a, b in spans)  # no block without values
    want = -(-sum(n > 0 for n in sizes) // optim_update.OPT_MAX_TENSORS)
    assert len(plan) == want


def test_bias_corrections_equal_the_loops_tensors():
    """The host floats K6 takes by value (through ctypes' c_float) are the
    loop's 0-dim tensors, bit for bit, for counts 1 ... 1000."""
    like = torch.zeros(1)
    for count in range(1, 1001):
        got = optim.bias_corrections(count)
        want = (optim._bias_correction(optim.B1, count, like),
                optim._bias_correction(optim.B2, count, like),
                optim._bias_correction(optim.B1, count + 1, like))
        for g, w in zip(got, want):
            assert (np.float32(ctypes.c_float(g).value).view(np.uint32)
                    == w.numpy().view(np.uint32))


@pytest.mark.parametrize("name", ["adam", "nadam", "adamw", "sgd", "sgdw"])
def test_apply_updates_on_cpu_leaves_the_kernel_alone(name):
    params, grads = _problem(3, steps=2)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    plain = [torch.from_numpy(p.copy()) for p in params]
    state = optim.init_opt_state(name, tparams, 1e-3, 1e-4)
    pstate = optim.init_opt_state(name, plain, 1e-3, 1e-4)
    before = optim_update.LAUNCHES
    for g in grads:
        optim.apply_updates(state, tparams, [torch.from_numpy(x) for x in g])
        optim.apply_updates_plain(pstate, plain, [torch.from_numpy(x) for x in g])
    assert optim_update.LAUNCHES == before
    for a, b in zip(tparams, plain):
        assert torch.equal(a, b)


def test_kernel_layout_rules():
    """K6 reads each tensor as its dense storage span: any dense layout
    (channels_last too) passes, a view with gaps does not, and a gradient
    must share its parameter's strides except along dimensions of size 1."""
    p = torch.zeros(8, 3, 3, 3).to(memory_format=torch.channels_last)
    assert optim_update._dense(p) and optim_update._dense(p.permute(2, 0, 3, 1))
    assert not optim_update._dense(torch.zeros(8, 6)[:, ::2])
    assert optim_update._same_layout(torch.zeros_like(p), p)
    assert not optim_update._same_layout(torch.zeros(8, 3, 3, 3), p)
    one = torch.zeros(16, 4, 1, 1).to(memory_format=torch.channels_last)
    assert optim_update._same_layout(torch.zeros(16, 4, 1, 1), one)


def test_kernel_wrapper_refuses_cpu_tensors():
    p = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        optim_update.cuda_optim_update("sgd", p, [torch.zeros(4)], [], [],
                                       torch.tensor(1e-3), [0.0] * 10)
