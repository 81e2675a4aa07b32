"""The port's mosaic and mixup (``data/augment.py`` ``mosaic_batch``,
``mixup_batch``) against the JAX package's on JAX's own draws, and the
train step with them on against JAX's step.

``jax_mosaic_draws`` and ``jax_mixup_draws`` repeat the ``jax.random.split``
chains of ``keras_object_detection_tpu/data/augment.py`` (``mosaic_batch``
:378-384 and ``_mosaic_one`` :301-304 and :377; ``mixup_batch`` :411-418)
and hand JAX's random numbers to the port. Tolerances: u8 pixels within 1
(the final round is half to even in both, but float32 sums of the
resampling may part by an ulp next to a .5), validity exact, boxes within
1.2e-7 absolute (one float32 ulp at 1: XLA on the CPU contracts the box
affine ``b * q + q0`` into one fused multiply-add, torch rounds twice).

``sample_step_draws`` draws each arm from a stream of its own, so with both
probabilities at 0 a step's draws are what they were before the arms
existed, and switching one arm on leaves the others' draws unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu.data import augment as jaug
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.data import augment as taug
from keras_object_detection_torch.data.augment import (MixupDraws,
                                                       MosaicDraws,
                                                       sample_augment_draws)
from keras_object_detection_torch.train import (StepDraws,
                                                create_train_state,
                                                make_train_step,
                                                sample_step_draws)
from keras_object_detection_torch.models import build_model
from keras_object_detection_torch.train.loop import step_generator
from test_torch_augment import jax_draws
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


BOX_ATOL = 1.2e-7


def jax_mosaic_draws(key, batch, center_range=(0.25, 0.75)) -> MosaicDraws:
    """The random numbers ``mosaic_batch(..., key)`` draws."""
    kp, ks, kc = jax.random.split(key, 3)
    perms = np.stack([np.asarray(jax.random.permutation(k, batch))
                      for k in jax.random.split(ks, 3)], axis=1)
    lo, hi = center_range
    center = []
    for k in jax.random.split(kc, batch):
        kx, ky = jax.random.split(k, 2)
        center.append([jax.random.uniform(kx, (), minval=lo, maxval=hi),
                       jax.random.uniform(ky, (), minval=lo, maxval=hi)])
    return MosaicDraws(torch.from_numpy(perms.astype(np.int64)),
                       torch.from_numpy(np.array(center, np.float32)),
                       torch.from_numpy(np.array(jax.random.uniform(kp, (batch,)))))


def jax_mixup_draws(key, batch, alpha=1.5) -> MixupDraws:
    """The random numbers ``mixup_batch(..., key)`` draws."""
    kp, kperm, klam = jax.random.split(key, 3)
    return MixupDraws(
        torch.from_numpy(np.array(jax.random.permutation(kperm, batch),
                                  np.int64)),
        torch.from_numpy(np.array(jax.random.beta(klam, alpha, alpha,
                                                  (batch,)))),
        torch.from_numpy(np.array(jax.random.uniform(kp, (batch,)))))


def jax_step_draws(jcfg, rng, step, batch):
    """One JAX train step's draws (``make_train_step``'s key chain:
    ``fold_in(rng, step)`` -> ``(akey, dkey)``, then per microbatch
    ``fold_in(akey, i)``, the mosaic's and the mixup's splits of it, and
    ``augment_batch``'s)."""
    akey, _ = jax.random.split(jax.random.fold_in(rng, step))
    d = jcfg.data
    accum = max(jcfg.train.grad_accum_steps, 1)
    out = []
    for i in range(accum):
        key = akey if accum == 1 else jax.random.fold_in(akey, i)
        mosaic = mixup = None
        if d.mosaic_prob > 0:
            key, mkey = jax.random.split(key)
            mosaic = jax_mosaic_draws(mkey, batch // accum,
                                      tuple(d.mosaic_center_range))
        if d.mixup_prob > 0:
            key, xkey = jax.random.split(key)
            mixup = jax_mixup_draws(xkey, batch // accum, d.mixup_alpha)
        out.append(StepDraws(
            jax_draws(key, batch // accum, strengths=tuple(d.color_jitter),
                      crop_scale=tuple(d.crop_scale),
                      crop_ratio=tuple(d.crop_ratio)), mosaic, mixup))
    return out


def _inputs(seed, b, size, n=5):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.1, 0.9, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.005, 0.5, (b, n, 2))  # some sub-pixel
    boxes[..., 4] = rng.randint(0, 3, (b, n))
    return images, boxes, rng.rand(b, n) < 0.7


def _assert_batch_matches(want, got):
    wi, gi = np.asarray(want[0]).astype(int), got[0].numpy().astype(int)
    assert got[0].dtype == torch.uint8 and gi.shape == wi.shape
    assert np.abs(wi - gi).max() <= 1
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=BOX_ATOL)


@pytest.mark.parametrize("prob,in_size,out_size,seed", [
    (1.0, 40, None, 0), (0.5, 40, None, 1), (0.5, 40, 56, 2),
    (1.0, 64, 48, 3)])
def test_mosaic_batch_matches_jax(prob, in_size, out_size, seed):
    images, boxes, valid = _inputs(seed, 6, in_size)
    key = jax.random.PRNGKey(seed + 10)
    want = jaug.mosaic_batch(jnp.asarray(images), jnp.asarray(boxes),
                             jnp.asarray(valid), key, prob=prob,
                             out_size=out_size)
    got = taug.mosaic_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                            torch.from_numpy(valid), jax_mosaic_draws(key, 6),
                            prob, out_size)
    _assert_batch_matches(want, got)
    assert got[1].shape == (6, 4 * 5, 5)


def test_mosaic_centre_pixel_belongs_to_the_right_and_bottom():
    """A centre exactly on a pixel centre: that column and row belong to
    the right and bottom quadrants (``>=``), as JAX's owner mask says.
    Four sources of one colour each, so every pixel shows its owner."""
    size, k = 32, 12
    colours = np.array([40, 90, 160, 220], np.uint8)
    images = np.broadcast_to(colours[:, None, None, None],
                             (4, size, size, 3)).copy()
    boxes = np.zeros((4, 1, 5), np.float32)
    valid = np.zeros((4, 1), bool)
    c = (torch.tensor(k, dtype=torch.float32) + 0.5) / size
    draws = MosaicDraws(torch.tensor([[1, 2, 3]] * 4), torch.full((4, 2), c),
                        torch.zeros(4))
    got = taug.mosaic_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                            torch.from_numpy(valid), draws, 1.0)[0][0, ..., 0]
    xs = (jnp.arange(size) + 0.5) / size  # JAX's owner mask at this centre
    assert bool(xs[k] >= float(c)) and not bool(xs[k - 1] >= float(c))
    tl, tr, bl, br = (int(v) for v in colours)
    assert int(got[0, k - 1]) == tl and int(got[0, k]) == tr
    assert int(got[k - 1, 0]) == tl and int(got[k, 0]) == bl
    assert int(got[k, k]) == br and int(got[size - 1, size - 1]) == br


@pytest.mark.parametrize("prob,seed", [(1.0, 0), (0.5, 1), (0.25, 2)])
def test_mixup_batch_matches_jax(prob, seed):
    images, boxes, valid = _inputs(seed, 8, 24)
    key = jax.random.PRNGKey(seed + 20)
    want = jaug.mixup_batch(jnp.asarray(images), jnp.asarray(boxes),
                            jnp.asarray(valid), key, prob=prob, alpha=1.5)
    got = taug.mixup_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                           torch.from_numpy(valid), jax_mixup_draws(key, 8),
                           prob)
    _assert_batch_matches(want, got)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].shape == (8, 10, 5)


def test_port_samplers_draw_the_right_distributions():
    g = torch.Generator().manual_seed(0)
    m = taug.sample_mosaic_draws(4000, g, (0.3, 0.6))
    assert all(torch.equal(torch.sort(m.perms[:, j]).values,
                           torch.arange(4000)) for j in range(3))
    assert 0.3 <= float(m.center.min()) and float(m.center.max()) < 0.6
    assert abs(float(m.apply.mean()) - 0.5) < 0.02
    x = taug.sample_mixup_draws(4000, g, 1.5)
    assert x.lam.dtype == torch.float32
    # Beta(1.5, 1.5): mean 1/2, variance 1/16
    assert abs(float(x.lam.mean()) - 0.5) < 0.02
    assert abs(float(x.lam.var()) - 0.0625) < 0.006
    assert torch.equal(torch.sort(x.perm).values, torch.arange(4000))


def _recipe(mosaic, mixup, accum=1):
    cfg = tconfig.Config(
        grid=tconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=tconfig.ModelConfig(backbone="darknet_micro", image_size=56,
                                  compute_dtype="float32"),
        data=tconfig.DataConfig(batch_size=4, mosaic_prob=mosaic,
                                mixup_prob=mixup),
        train=tconfig.TrainConfig(grad_accum_steps=accum))
    return cfg, build_model(cfg)


@pytest.mark.parametrize("accum", [1, 2])
def test_arms_draw_from_streams_of_their_own(accum):
    cfg, model = _recipe(0.0, 0.0, accum)
    base = sample_step_draws(cfg, model, 4, 7, 3)
    for i, x in enumerate(base):  # as the step drew them before the arms
        micro = i if accum > 1 else None
        want = sample_augment_draws(4 // accum, step_generator(7, 3, micro))
        assert x.mosaic is None and x.mixup is None and x.keep is None
        assert x.augment.order == want.order
        for a, b in zip(x.tensors(), StepDraws(want).tensors()):
            assert torch.equal(a, b)
    for mosaic, mixup in ((0.5, 0.0), (0.0, 0.5), (1.0, 1.0)):
        cfg_on, _ = _recipe(mosaic, mixup, accum)
        on = sample_step_draws(cfg_on, model, 4, 7, 3)
        for x, y in zip(on, base):
            assert (x.mosaic is not None) == (mosaic > 0)
            assert (x.mixup is not None) == (mixup > 0)
            for a, b in zip(StepDraws(x.augment).tensors(), y.tensors()):
                assert torch.equal(a, b)


def jax_composed(jcfg, rng, step, images, boxes, valid):
    """The batch after JAX's mosaic and mixup as its train step composes
    it (per microbatch of rows ``i::accum``, rows put back in place)."""
    akey, _ = jax.random.split(jax.random.fold_in(rng, step))
    d = jcfg.data
    accum = max(jcfg.train.grad_accum_steps, 1)

    @jax.jit
    def compose(im, bx, vl, key):
        if d.mosaic_prob > 0:
            key, mkey = jax.random.split(key)
            im, bx, vl = jaug.mosaic_batch(
                im, bx, vl, mkey, prob=d.mosaic_prob,
                center_range=tuple(d.mosaic_center_range))
        if d.mixup_prob > 0:
            key, xkey = jax.random.split(key)
            im, bx, vl = jaug.mixup_batch(im, bx, vl, xkey, prob=d.mixup_prob,
                                          alpha=d.mixup_alpha)
        return im, bx, vl

    parts = [jax.device_get(compose(
        jnp.asarray(images[i::accum]), jnp.asarray(boxes[i::accum]),
        jnp.asarray(valid[i::accum]),
        akey if accum == 1 else jax.random.fold_in(akey, i)))
        for i in range(accum)]
    out = []
    for j in range(3):
        full = np.zeros((images.shape[0],) + parts[0][j].shape[1:],
                        parts[0][j].dtype)
        for i in range(accum):
            full[i::accum] = parts[i][j]
        out.append(full)
    return out


RECIPE_STEPS = [(0.75, 0.5, 1, False), (0.75, 0.5, 1, True),
                (0.75, 0.5, 2, False)]
ARM_STEPS = [(1.0, 0.0, 1, False), (0.0, 1.0, 1, True), *RECIPE_STEPS]


def _recipe_jcfg(mosaic, mixup, accum, kernels):
    jcfg = _cfg(kernels, "sgd", accum)
    return dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, mosaic_prob=mosaic, mixup_prob=mixup))


def _without_arms(cfg):
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, mosaic_prob=0.0, mixup_prob=0.0))


@pytest.mark.parametrize("mosaic,mixup,accum,kernels", RECIPE_STEPS)
def test_recipe_step_matches_jax(mosaic, mixup, accum, kernels):
    """One SGD step of JAX with mosaic and mixup on against the port's
    step on the batch JAX composed (``jax_composed``) and JAX's crop and
    colour draws: loss terms to 1e-5, as
    ``test_torch_train.test_sgd_step_matches_jax``, every parameter and
    running statistic to 2e-5: the mosaic holds 4x the boxes, so the
    head's gradients, and their float32 rounding, grow (3 of the head
    conv's 589,824 weights land 1.27e-5 apart with two microbatches). The
    port's
    own composition is held to JAX's by ``test_mosaic_batch_matches_jax``
    and ``test_mixup_batch_matches_jax`` (a pixel may sit 1 apart, and at
    a random init one such pixel can flip a max-pool's choice and move a
    gradient by far more than its size) and wired into the step as
    ``test_recipe_step_composes_mosaic_then_mixup`` shows."""
    jcfg = _recipe_jcfg(mosaic, mixup, accum, kernels)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate)
    images, boxes, valid = _batch()
    rng = jax.random.PRNGKey(11)
    jstate, jmetrics = jax.jit(jloop.make_train_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        rng)
    composed = jax_composed(jcfg, rng, 0, images, boxes, valid)
    draws = [StepDraws(x.augment) for x in jax_step_draws(jcfg, rng, 0, 4)]
    state, metrics = make_train_step(_without_arms(tcfg))(
        state, *composed, seed=0, draws=draws)
    _assert_metrics_match(jmetrics, metrics, kernels)
    _assert_state_matches(jstate, state, tol=2e-5)


@pytest.mark.parametrize("mosaic,mixup,accum,kernels", ARM_STEPS)
def test_recipe_step_composes_mosaic_then_mixup(mosaic, mixup, accum,
                                                kernels):
    """The port's step with the arms on equals, bit for bit, its step
    without them fed ``mixup_batch(mosaic_batch(batch))`` of each
    microbatch (rows ``i::accum``) on the same draws."""
    tcfg = tconfig.Config.from_json(
        _recipe_jcfg(mosaic, mixup, accum, kernels).to_json())
    images, boxes, valid = (torch.from_numpy(a) for a in _batch())
    draws = jax_step_draws(_recipe_jcfg(mosaic, mixup, accum, kernels),
                           jax.random.PRNGKey(11), 0, 4)
    parts = []
    for i, x in enumerate(draws):
        rows = slice(i, None, accum)
        batch = (images[rows], boxes[rows], valid[rows])
        if mosaic > 0:
            batch = taug.mosaic_batch(*batch, x.mosaic, mosaic)
        if mixup > 0:
            batch = taug.mixup_batch(*batch, x.mixup, mixup)
        parts.append(batch)
    composed = []
    for j in range(3):
        full = torch.zeros((4,) + parts[0][j].shape[1:], dtype=parts[0][j].dtype)
        for i in range(accum):
            full[i::accum] = parts[i][j]
        composed.append(full)

    def run(cfg, batch, step_draws):
        state = create_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
        return make_train_step(cfg)(state, *batch, seed=0, draws=step_draws)

    on, on_metrics = run(tcfg, (images, boxes, valid), draws)
    off, off_metrics = run(_without_arms(tcfg), composed,
                           [StepDraws(x.augment) for x in draws])
    for k in on_metrics:
        assert torch.equal(on_metrics[k], off_metrics[k]), k
    want = off.model.state_dict()
    for k, v in on.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_step_refuses_draws_without_the_switched_on_arms():
    jcfg = _cfg(False, "sgd")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(
        jcfg.data, mosaic_prob=0.5))
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate)
    draws = jax_draws(jax.random.PRNGKey(1), 4)
    with pytest.raises(ValueError, match="mosaic"):
        make_train_step(tcfg)(state, *_batch(), seed=0, draws=draws)
