"""The transfer-learning recipe's train step and weight files, against the
JAX package:

- one ``freeze_backbone`` nadam step of vgg16 + conv head and of
  mobilenetv2 + gap_dense head (kernels' switches on), from the same
  converted init and augmentation draws as JAX's ``make_train_step``: the
  loss, the head's gradients, the optimizer state, the updated head, and a
  backbone whose parameters, running statistics and moments stay
  bit-unchanged;
- the eval-mode loss after 4 nadam steps at ``voc_full_config()``'s base
  learning rate (fault 3.2 of the port's ROADMAP), darknet_tiny in float32;
- darknet ``.weights`` files: the port's save is byte-equal to JAX's
  ``save_darknet_backbone``, and its load gives JAX's
  ``load_darknet_backbone`` weights.

Tolerances: float32 1e-5 for a step's loss, 1e-4 of each tensor's largest
value for its gradient and moments (sums in another order, through
BatchNorms of a few rows); a nadam update moves an element by about
lr * sign(g), so the updated parameters are compared as
``test_torch_train.py`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models import darknet_import as jdarknet
from keras_object_detection_tpu.train import loop as jloop
from keras_object_detection_torch.models import darknet_import, flax_to_torch
from keras_object_detection_torch.train import make_eval_step, make_train_step
from keras_object_detection_torch.train.optim import ONE_MINUS_B1
from test_torch_model import randomized_variables
from test_torch_train import _batch, _jax_draws, _port_state


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(backbone, head, size, kernels, lr=1e-4, **model):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=2, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone=backbone, head=head,
                                  image_size=size, compute_dtype="float32",
                                  bn_mode="fused" if kernels else "flax",
                                  **model),
        data=jconfig.DataConfig(batch_size=4),
        train=jconfig.TrainConfig(
            optimizer="nadam", use_pallas_loss=kernels,
            schedule=jconfig.ScheduleConfig(kind="constant", base_lr=lr)))


def _jax_moments(jstate):
    """(mu, nu) of optax's nadam state as the port's state-dict keys."""
    adam = jstate.opt_state.inner_state[0]
    stats = jax.device_get(jstate.batch_stats)
    return (flax_to_torch(jax.device_get(adam.mu), stats),
            flax_to_torch(jax.device_get(adam.nu), stats))


@pytest.mark.parametrize("backbone,head,kernels", [
    ("vgg16", "conv", False), ("mobilenetv2", "gap_dense", True)])
def test_frozen_backbone_step_matches_jax(backbone, head, kernels):
    jcfg = _cfg(backbone, head, 64, kernels, freeze_backbone=True,
                head_dense_units=64)
    jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    # a head of non-trivial weights and statistics (predicted w, h away
    # from the sqrt's steep start, every term of the loss in play) on the
    # backbone's own init
    params = dict(jax.device_get(jstate.params))
    stats = dict(jax.device_get(jstate.batch_stats))
    top = next(k for k in params if not k.endswith("Backbone_0"))
    v = randomized_variables({"params": params[top],
                              "batch_stats": stats.get(top, {})}, seed=1)
    params[top] = v["params"]
    if top in stats:
        stats[top] = v["batch_stats"]
    jstate = jstate.replace(params=params, batch_stats=stats)
    tcfg, state = _port_state(jcfg, jstate)
    model = state.model
    assert model.freeze_backbone and not model.backbone.training
    before = {k: v.clone() for k, v in model.state_dict().items()}
    images, boxes, valid = _batch(size=64)
    images[..., 0] = 255 - images[..., 0]  # not a grey batch
    draws = _jax_draws(jcfg, jax.random.PRNGKey(7), 0, 1, 4)
    jstate, jmetrics = jax.jit(jloop.make_train_step(jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jax.random.PRNGKey(7))
    state, metrics = make_train_step(tcfg)(state, images, boxes, valid, seed=0,
                                           draws=draws)
    np.testing.assert_allclose(float(metrics["total"]),
                               float(jmetrics["total"]), rtol=1e-5)
    assert model.backbone.training is False and model.head.training

    names = [n for n, _ in model.named_parameters()]
    mu, nu = _jax_moments(jstate)
    after = model.state_dict()
    for i, name in enumerate(names):
        p = dict(model.named_parameters())[name]
        if name.startswith("backbone."):
            assert p.grad is None  # no backward through the frozen backbone
            assert torch.equal(after[name], before[name]), name
            assert not state.opt.mu[i].any() and not state.opt.nu[i].any()
            continue
        if name in ("head.block.conv.bias", "head.denses.0.bias"):
            continue  # feeds a training-mode BN, which removes it: rounding
        ref = np.abs(mu[name].numpy()).max() / float(ONE_MINUS_B1) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / ref,
                                   mu[name].numpy() / float(ONE_MINUS_B1) / ref,
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(state.opt.mu[i].numpy() / ref,
                                   mu[name].numpy() / ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        nu_ref = np.abs(nu[name].numpy()).max() + 1e-30
        np.testing.assert_allclose(state.opt.nu[i].numpy() / nu_ref,
                                   nu[name].numpy() / nu_ref, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for k, v in after.items():
        if k.startswith("backbone.") and "running" in k:
            assert torch.equal(v, before[k]), k  # eval-mode BN: no update
    want = flax_to_torch(jax.device_get(jstate.params),
                         jax.device_get(jstate.batch_stats), model)
    diffs = np.concatenate([np.abs(after[k].numpy() - want[k].numpy()).ravel()
                            for k in want if k.startswith("head.")])
    # the first nadam update is lr * 1.4737 * sign(g): an element whose
    # gradient is rounding (a bias before a training-mode BN) may flip
    assert diffs.max() <= 3 * 1e-4 + 1e-5 and np.mean(diffs <= 1e-6) > 0.99
    for k in want:
        if k.startswith("backbone."):
            assert torch.equal(after[k], want[k]), k  # JAX's is unchanged too
    assert state.opt.count == 1


def test_eval_loss_after_nadam_steps_matches_jax():
    """Fault 3.2: 4 nadam steps at voc_full_config's base lr (1e-3) from one
    converted init, then each package's eval step (BatchNorm on its running
    statistics). darknet_tiny @224, float32, C=3, batch 4, plain path.

    At this lr the trajectory is chaotic: JAX against itself, its weights
    moved by 1e-7 relative, parts by several per cent in eval loss after 4
    steps. So the yardstick is that spread: the port's eval loss lies within
    twice JAX's largest distance from itself over three such nudges (the
    first train loss to 1e-5)."""
    lr = jconfig.voc_full_config().train.schedule.base_lr
    assert lr == 1e-3
    jcfg = _cfg("darknet_tiny", "conv", 224, False, lr=lr)
    jcfg = dataclasses.replace(jcfg, grid=dataclasses.replace(jcfg.grid, grid=7))
    images, boxes, valid = _batch(size=224)
    evals = _batch(seed=1, size=224)
    rng = jax.random.PRNGKey(3)
    jstep = jax.jit(jloop.make_train_step(jcfg))
    jeval = jax.jit(jloop.make_eval_step(jcfg))

    def jax_run(noise_seed=None):
        jstate = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
        if noise_seed is not None:
            r = np.random.RandomState(noise_seed)
            jstate = jstate.replace(params=jax.tree_util.tree_map(
                lambda q: q * (1 + 1e-7 * r.randn(*q.shape)).astype(np.float32),
                jstate.params))
        losses = []
        for _ in range(4):
            jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(valid), rng)
            losses.append(float(m["total"]))
        return jstate, losses, float(jeval(jstate, *map(jnp.asarray, evals))[0])

    jstate0 = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    tcfg, state = _port_state(jcfg, jstate0)
    step = make_train_step(tcfg)
    losses = []
    for i in range(4):
        state, m = step(state, images, boxes, valid, seed=0,
                        draws=_jax_draws(jcfg, rng, i, 1, 4))
        losses.append(float(m["total"]))
    loss = float(make_eval_step(tcfg)(state, *evals)[0])
    _, jlosses, jloss = jax_run()
    spread = max(abs(jax_run(k)[2] / jloss - 1) for k in range(3))
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    assert np.isfinite(loss) and np.isfinite(jloss) and spread > 0
    assert abs(loss / jloss - 1) <= 2 * spread, (loss, jloss, spread)


def _train_mode_loss(cfg, model, images, boxes, valid):
    """The plain loss of ``model``'s weights on a batch with BatchNorm on
    the batch's statistics (a copy in train mode: no state moves)."""
    import copy

    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data.augment import preprocess_eval_batch
    from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms

    g, t = cfg.grid, cfg.train
    model = copy.deepcopy(model).train()
    with torch.no_grad():
        y_true = encode_grid(torch.from_numpy(boxes), torch.from_numpy(valid),
                             g.num_classes, g.num_boxes, g.grid)
        y_pred = model(preprocess_eval_batch(torch.from_numpy(images)))
        return float(yolo_v1_loss_terms(
            y_true, y_pred.reshape(y_true.shape), g.num_classes, g.num_boxes,
            t.lambda_coord, t.lambda_noobj)["total"])


def test_eval_mode_loss_outgrows_train_mode_in_jax_as_in_the_port():
    """Fault 3.2 at the flagship's depth: darknet24 (@96, grid 2, float32,
    batch 4), 6 nadam steps at lr 1e-3. nadam moves every weight by about
    lr * 1.47 a step whatever its gradient's size, so each filter's norm
    grows; training-mode BatchNorm does not see it, while the running
    statistics (momentum 0.99) lag it, and in eval mode the mismatch
    compounds through 25 BatchNorms. Which trajectory blows up how far
    hangs on rounding: JAX from the init and from three nudges of it (1e-5
    relative) ends with eval / train-mode loss ratios from about 1e2 to
    1e4, the port (from the same init) inside that spread. So the 1e11
    eval loss after the card's 8 flagship steps is the reference's
    behaviour, not the port's. ``-s`` prints the ratios."""
    jcfg = _cfg("darknet24", "conv", 96, False, lr=1e-3)
    jcfg = dataclasses.replace(jcfg, grid=dataclasses.replace(jcfg.grid, grid=2))
    images, boxes, valid = _batch(size=96)
    evals = _batch(seed=1, size=96)
    rng = jax.random.PRNGKey(3)
    jmodel = jloop.build_model(jcfg)
    jstep = jax.jit(jloop.make_train_step(jcfg))
    jeval = jax.jit(jloop.make_eval_step(jcfg))

    @jax.jit
    def jtrain_mode(params, stats):
        from keras_object_detection_tpu.core.grid import encode_grid
        from keras_object_detection_tpu.losses.yolo import yolo_v1_loss_terms

        y, _ = jmodel.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(evals[0], jnp.float32) / 255.0,
                            train=True, mutable=["batch_stats"])
        yt = jax.vmap(lambda b, v: encode_grid(b, v, 3, 2, 2))(
            jnp.asarray(evals[1]), jnp.asarray(evals[2]))
        return yolo_v1_loss_terms(yt, y.reshape(yt.shape), 3, 2, 5.0,
                                  0.5)["total"]

    init = jloop.create_train_state(jcfg, jax.random.PRNGKey(0))
    ratios = []
    for seed in (None, 0, 1, 2):
        js = init
        if seed is not None:
            r = np.random.RandomState(seed)
            js = js.replace(params=jax.tree_util.tree_map(
                lambda q: q * (1 + 1e-5 * r.randn(*q.shape)).astype(np.float32),
                js.params))
        for _ in range(6):
            js, _ = jstep(js, jnp.asarray(images), jnp.asarray(boxes),
                          jnp.asarray(valid), rng)
        ratios.append(float(jeval(js, *map(jnp.asarray, evals))[0])
                      / float(jtrain_mode(js.params, js.batch_stats)))
    tcfg, state = _port_state(jcfg, init)
    step = make_train_step(tcfg)
    for i in range(6):
        state, _ = step(state, images, boxes, valid, seed=0,
                        draws=_jax_draws(jcfg, rng, i, 1, 4))
    ours = (float(make_eval_step(tcfg)(state, *evals)[0])
            / _train_mode_loss(tcfg, state.model, *evals))
    print(f"eval / train-mode loss after 6 steps: JAX {ratios}, port {ours}")
    assert np.median(ratios) > 100
    assert ours > 10 and min(ratios) / 10 <= ours <= 10 * max(ratios)


def _darknet_state(seed=0):
    """darknet_tiny's flax variables, randomised, and the port's state."""
    cfg = jconfig.Config(grid=jconfig.GridConfig(grid=7, num_classes=3),
                         model=jconfig.ModelConfig(backbone="darknet_tiny",
                                                   image_size=64))
    from keras_object_detection_tpu.models.yolo import build_model as jbuild
    v = jax.device_get(jbuild(cfg).init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 64, 64, 3))))
    v = randomized_variables(v, seed)
    return v, flax_to_torch(v["params"], v["batch_stats"])


@pytest.mark.parametrize("num_convs", [None, 4])
def test_darknet_weights_match_jax(tmp_path, num_convs):
    """Save: the port's file is JAX's byte for byte (bias folded into the
    rolling mean, the epsilon rescale inverted). Load (a whole file and a
    .conv.4 prefix): the port's tensors are JAX's, the rest untouched."""
    v, sd = _darknet_state()
    ours, theirs = tmp_path / "port.weights", tmp_path / "jax.weights"
    info = darknet_import.save_darknet_backbone(sd, str(ours),
                                                num_convs=num_convs, seen=12)
    jdarknet.save_darknet_backbone(v["params"], v["batch_stats"], str(theirs),
                                   num_convs=num_convs, seen=12)
    assert ours.read_bytes() == theirs.read_bytes()
    assert info["saved_convs"] == (num_convs or 6)

    _, fresh = _darknet_state(seed=1)
    loaded, info = darknet_import.load_darknet_backbone(fresh, str(theirs))
    jp, js, jinfo = jdarknet.load_darknet_backbone(
        jax.device_get(_darknet_state(seed=1)[0]["params"]),
        jax.device_get(_darknet_state(seed=1)[0]["batch_stats"]), str(theirs))
    want = flax_to_torch(jax.device_get(jp), jax.device_get(js))
    assert info == {k: jinfo[k] for k in info}
    assert info["loaded_convs"] == (num_convs or 6) and info["seen"] == 12
    for k, t in loaded.items():
        assert torch.equal(t, want[k]), k
        if k.startswith("backbone.blocks."):
            block = int(k.split(".")[2])
            same = torch.equal(t, fresh[k])
            assert same == (block >= (num_convs or 6)) or not fresh[k].any(), k


def test_darknet_weights_round_trip_the_eval_function(tmp_path):
    """save -> load gives the same eval-mode backbone function (bias folded
    into the mean, epsilon rescaled), and the checks raise."""
    from keras_object_detection_torch.models.backbones import BACKBONES

    _, sd = _darknet_state()
    path = tmp_path / "d.weights"
    darknet_import.save_darknet_backbone(sd, str(path))
    loaded, _ = darknet_import.load_darknet_backbone(sd, str(path), strict=True)
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    outs = []
    for state in (sd, loaded):
        bb = BACKBONES["darknet_tiny"](torch.float32,
                                       generator=torch.Generator()).eval()
        bb.load_state_dict({k[len("backbone."):]: v for k, v in state.items()
                            if k.startswith("backbone.")})
        with torch.no_grad():
            outs.append(bb(x))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
    data = path.read_bytes()
    (tmp_path / "short.weights").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="trailing bytes"):
        darknet_import.load_darknet_backbone(sd, str(tmp_path / "short.weights"))
    with pytest.raises(EOFError):
        darknet_import.load_darknet_backbone(
            sd, str(tmp_path / "short.weights"), strict=True)
    (tmp_path / "long.weights").write_bytes(data + b"\0" * 8)
    with pytest.raises(ValueError, match="bigger network"):
        darknet_import.load_darknet_backbone(sd, str(tmp_path / "long.weights"))
