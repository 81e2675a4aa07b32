"""The port's YOLOv3 models against the JAX package's, with JAX's weights
through ``flax_to_torch``:

- Darknet-53's table and downsample indices; a narrow residual table
  (``RESIDUAL``, 48², every grammar entry, two taps) through both
  ``DarknetBackbone``s: features and taps coarse -> fine to 1e-5, the tap
  segments (each tap's downsample starts one), and the flags' errors;
- the FPN head over that table's taps, narrowed (``base_filters`` 16, 3
  scales), and ``darknet_micro`` + 2 scales (JAX's FPN tests' model)
  through ``build_model``: each scale's grid in eval and training mode and
  the running statistics, float32 to 1e-4 (relative, and of the output's
  largest magnitude) and bfloat16 at the v1 model tests' 5e-2 (the
  micro model's bfloat16 training mode against JAX's float32 forward, see
  its test);
- the real ``yolov3_config()`` by shapes only (JAX's ``eval_shape``, the
  port on the ``meta`` device): 13 / 26 / 52 grids of 75, every converted
  name and shape, 61,652,353 parameters as JAX's ``count_params`` has them;
- the guards JAX raises, remat ``full`` / ``dots`` over the residual FPN
  model bit-equal to the step without, a frozen backbone, and the darknet
  ``.weights`` loader over a residual table in network order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models import darknet as jdarknet
from keras_object_detection_tpu.models import darknet_import as jimport
from keras_object_detection_tpu.models.summary import \
    count_params as jcount_params
from keras_object_detection_tpu.models.yolo import FPNHead as JFPNHead
from keras_object_detection_tpu.models.yolo import YoloV1 as JYoloV1
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models import darknet as tdarknet
from keras_object_detection_torch.models import darknet_import
from keras_object_detection_torch.models.summary import count_params
from keras_object_detection_torch.models.yolo import (FPNHead, YoloV1,
                                                      backbone_feature_size)
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from test_torch_model import randomized_variables

# a narrow table in Darknet-53's grammar: stride-2 convs and residual
# stages of 1 and 2 units, 48² -> 6²; the taps (before the last two
# downsamples) 32 channels at 12² and 16 at 24²
RESIDUAL = ((3, 8, 1, 1), (3, 16, 2, 1), ("R", 16, 1), (3, 32, 2, 1),
            ("R", 32, 2), (3, 64, 2, 1), ("R", 64, 1))
ANCHORS6 = ((0.8, 0.7), (0.5, 0.6), (0.35, 0.3),
            (0.2, 0.25), (0.12, 0.1), (0.05, 0.06))
ANCHORS9 = ANCHORS6 + ((0.03, 0.04), (0.6, 0.2), (0.15, 0.5))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _images(seed, b=2, size=48):
    return np.random.RandomState(seed).uniform(0, 1, (b, size, size, 3)).astype(
        np.float32)


def _init(module, *shapes, seed=0):
    """``module``'s variables, every leaf drawn by ``randomized_variables``:
    only the init's shapes are needed (``eval_shape`` compiles nothing)."""
    variables = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(seed), *[jnp.zeros(s) for s in shapes],
        train=False))
    return randomized_variables(variables, seed)


def test_darknet53_table_and_downsamples_match_jax():
    assert tdarknet.DARKNET53_CONFIG == jdarknet.DARKNET53_CONFIG
    for name, table in jdarknet.ARCHITECTURES.items():
        assert tdarknet.ARCHITECTURES[name] == table
        assert tdarknet._downsample_indices(table) == \
            jdarknet._downsample_indices(table)
    assert set(tdarknet.ARCHITECTURES) == set(jdarknet.ARCHITECTURES)


def _backbones(table, taps, seed=0):
    jb = jdarknet.DarknetBackbone(architecture=table, return_taps=taps,
                                  activation="leaky_relu")
    v = _init(jb, (1, 48, 48, 3), seed=seed)
    tb = tdarknet.DarknetBackbone(table, "leaky_relu",
                                  generator=torch.Generator(),
                                  return_taps=taps)
    tb.load_state_dict({k.replace("backbone.", "", 1): t for k, t in
                        flax_to_torch({"DarknetBackbone_0": v["params"]},
                                      {"DarknetBackbone_0":
                                       v["batch_stats"]}).items()})
    return jb, v, tb


def test_residual_backbone_and_taps_match_jax():
    jb, v, tb = _backbones(RESIDUAL, 2)
    # blocks[i] is ConvBlock_i: 2 + 2 * 1 + 1 + 2 * 2 + 1 + 2 * 1 convs
    assert len(tb.blocks) == 12 == len(v["params"])
    assert tb.tap_channels == (32, 16) and tb.out_channels == 64
    # a segment a conv or a residual unit; each tap's downsample starts one
    assert [g[0] for g in tb._groups] == [0, 1, ("R", 2), 4, ("R", 5),
                                          ("R", 7), 9, ("R", 10)]
    assert tb.tap_segments == (6, 3)
    x = _images(1)
    for train in (False, True):
        out = jax.jit(jb.apply, static_argnames=("train", "mutable"))(
            v, jnp.asarray(x), train=train,
            **({"mutable": ("batch_stats",)} if train else {}))
        want, want_taps = out[0] if train else out
        with torch.no_grad():
            got, taps = tb.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert [tuple(t.shape) for t in taps] == [(2, 32, 12, 12),
                                                  (2, 16, 24, 24)]
        for g, w in zip((got, *taps), (want, *want_taps)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                       rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("kwargs,match", [
    ({"return_tap": True, "return_taps": 1}, "exclusive"),
    ({"return_taps": 4}, "4 taps need 4 downsamples; the table has 3")])
def test_tap_flags_raise_as_jax(kwargs, match):
    with pytest.raises(ValueError, match=match):
        _init(jdarknet.DarknetBackbone(architecture=RESIDUAL, **kwargs),
              (1, 48, 48, 3))
    with pytest.raises(ValueError, match=match):
        tdarknet.DarknetBackbone(RESIDUAL, generator=torch.Generator(),
                                 **kwargs)


class _JaxPyramid(fnn.Module):
    """JAX's DarknetBackbone (RESIDUAL, 2 taps) + a narrowed FPNHead, as
    ``YoloV1`` composes them."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        x, taps = jdarknet.DarknetBackbone(
            architecture=RESIDUAL, activation="leaky_relu", dtype=self.dtype,
            return_taps=2)(x.astype(self.dtype), train=train)
        return JFPNHead(24, num_scales=3, base_filters=16,
                        dtype=self.dtype)(x, taps, train=train)


class _Pyramid(torch.nn.Module):
    def __init__(self, dtype):
        super().__init__()
        g = torch.Generator()
        self.dtype = dtype
        self.backbone = tdarknet.DarknetBackbone(
            RESIDUAL, "leaky_relu", dtype, generator=g, return_taps=2)
        self.head = FPNHead(64, self.backbone.tap_channels, 24, 3, 16,
                            dtype=dtype, generator=g)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.head(*self.backbone(x))


def _assert_scales(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_narrow_residual_fpn_matches_jax(dtype, tol):
    jm = _JaxPyramid(jnp.dtype(dtype))
    v = _init(jm, (1, 48, 48, 3), seed=2)
    assert set(v["params"]) == {"DarknetBackbone_0", "FPNHead_0"}
    model = _Pyramid(getattr(torch, dtype))
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    assert len(model.head.blocks) == 20 and len(model.head.convs) == 3
    x = _images(3)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    with torch.no_grad():
        _assert_scales(model.eval()(torch.from_numpy(x)),
                       apply(v, jnp.asarray(x)), tol)
        want, updates = apply(v, jnp.asarray(x), train=True,
                              mutable=("batch_stats",))
        got = model.train()(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == [(6, 6), (12, 12), (24, 24)]
    _assert_scales(got, want, tol)
    stats = flax_to_torch(v["params"], jax.device_get(updates["batch_stats"]),
                          model)
    for k, t in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(), rtol=tol,
                                       atol=tol, err_msg=k)


def fpn_jcfg(scales=2, anchors=ANCHORS6, size=56, grid=7, dtype="float32",
             **model):
    """JAX's FPN tests' model: darknet_micro + the FPN head."""
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=grid, num_boxes=2, num_classes=3,
                                anchors=anchors),
        model=jconfig.ModelConfig(backbone="darknet_micro", head="fpn",
                                  fpn_scales=scales, image_size=size,
                                  compute_dtype=dtype,
                                  activation="leaky_relu", **model))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_micro_fpn_model_matches_jax(dtype, tol):
    """In bfloat16 training mode the 1024-wide head's batch statistics over
    2 images put each package's grids 4-9 % (in norm) from the float32
    forward, and from each other by as much: there the yardstick is JAX's
    float32 forward, from which the port must lie about as far as JAX's own
    bfloat16 forward does (1.25x + 1e-3), as chip_smoke.py's
    ``compare_paths`` holds bfloat16 gradients."""
    jcfg = fpn_jcfg(dtype=dtype)
    jm = jbuild(jcfg)
    v = _init(jm, (1, 56, 56, 3), seed=4)
    model = build_model(tconfig.Config.from_json(jcfg.to_json()))
    model.load_state_dict(flax_to_torch(v["params"], v["batch_stats"], model))
    assert isinstance(model.head, FPNHead)
    x = np.random.RandomState(5).uniform(0, 1, (2, 56, 56, 3)).astype(
        np.float32)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        assert [tuple(g.shape) for g in got] == [(2, 7, 7, 24), (2, 14, 14, 24)]
        _assert_scales(got, apply(v, jnp.asarray(x)), tol)
        want, updates = apply(v, jnp.asarray(x), train=True,
                              mutable=("batch_stats",))
        got = model.train()(torch.from_numpy(x))
    if dtype == "float32":
        _assert_scales(got, want, tol)
    else:
        f32, _ = jax.jit(jbuild(fpn_jcfg()).apply, static_argnames=(
            "train", "mutable"))(v, jnp.asarray(x), train=True,
                                 mutable=("batch_stats",))
        for g, w, f in zip(got, want, f32):
            assert _rel(g.numpy(), f) <= 1.25 * _rel(w, f) + 1e-3
    stats = flax_to_torch(v["params"], jax.device_get(updates["batch_stats"]),
                          model)
    for k, t in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(), rtol=tol,
                                       atol=tol, err_msg=k)


def test_full_width_yolov3_names_shapes_and_count_match_jax():
    """yolov3_config() at 416² by shapes only: JAX's init tree converts to
    exactly the port's keys and shapes; 13 / 26 / 52 grids of 3 * 25."""
    jcfg = jconfig.yolov3_config()
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 416, 416, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    cfg = tconfig.yolov3_config()
    assert cfg.to_json() == jcfg.to_json()
    with torch.device("meta"):
        model = build_model(cfg, torch.Generator())
        out = model(torch.empty(1, 416, 416, 3))
    assert [tuple(o.shape) for o in out] == [(1, 13, 13, 75), (1, 26, 26, 75),
                                             (1, 52, 52, 75)]
    sd = flax_to_torch(zeros["params"], zeros["batch_stats"], model)
    assert set(sd) == set(model.state_dict())
    assert len(model.backbone.blocks) == 52 and len(model.head.blocks) == 20
    assert model.backbone.tap_channels == (512, 256)
    # the concatenations [upsampled, tap]: 256 + 512 at 26², 128 + 256 at 52²
    assert tuple(sd["head.blocks.7.conv.weight"].shape) == (256, 768, 1, 1)
    assert tuple(sd["head.blocks.14.conv.weight"].shape) == (128, 384, 1, 1)
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert count_params(cfg) == n_params == 61_652_353
    # chip_smoke.YOLOV3_VALUES: with the BatchNorm running statistics
    assert sum(v.numel() for v in sd.values()) == 61_704_961
    # the darknet loader walks the 52 backbone convs in network order
    assert len(darknet_import._blocks(model.state_dict())) == 52


def test_count_params_matches_jax_at_micro_size():
    jcfg = fpn_jcfg(scales=3, anchors=ANCHORS9, size=64, grid=8)
    assert count_params(tconfig.Config.from_json(jcfg.to_json())) == \
        jcount_params(jcfg)


@pytest.mark.parametrize("override,anchors,match", [
    (dict(passthrough=True), ANCHORS6, "passthrough is a YOLOv2 anchor-head"),
    (dict(backbone="vgg16"), ANCHORS6,
     "head='fpn' supports darknet backbones only"),
    (dict(), ANCHORS6[:5], "divisible by num_scales=2"),
    (dict(), (), "requires GridConfig.anchors|divisible by num_scales")])
def test_guards_raise_as_jax(override, anchors, match):
    jcfg = fpn_jcfg(anchors=anchors)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, **override))
    with pytest.raises(ValueError, match=match):
        jbuild(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))
    with pytest.raises(ValueError, match=match):
        build_model(tconfig.Config.from_json(jcfg.to_json()))
    kw = dict(backbone=jcfg.model.backbone, head="fpn", anchors=anchors,
              fpn_scales=2, passthrough=jcfg.model.passthrough)
    with pytest.raises(ValueError, match=match):
        JYoloV1(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))
    with pytest.raises(ValueError, match=match):
        YoloV1(generator=torch.Generator(), **kw)


@pytest.mark.parametrize("taps,match", [
    ([(1, 12, 12, 32)], "needs 2 backbone taps, got 1"),
    ([(1, 12, 12, 32), (1, 20, 20, 16)], "has spatial size 20, expected 24")])
def test_fpn_head_tap_checks_raise_as_jax(taps, match):
    """A wrong tap count, and a tap that is not twice the scale before it."""
    x = (1, 6, 6, 64)
    head = JFPNHead(24, num_scales=3, base_filters=16)
    with pytest.raises(ValueError, match=match):
        head.init(jax.random.PRNGKey(0), jnp.zeros(x),
                  [jnp.zeros(t) for t in taps])
    g = torch.Generator()
    with pytest.raises(ValueError, match=match):
        FPNHead(64, [t[-1] for t in taps], 24, 3, 16, generator=g)(
            torch.zeros(x).permute(0, 3, 1, 2),
            [torch.zeros(t).permute(0, 3, 1, 2) for t in taps])


def _remat_cfg(remat, policy="full", freeze=False):
    cfg = tconfig.Config.from_json(fpn_jcfg(scales=3, anchors=ANCHORS9,
                                            size=48, grid=6).to_json())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=remat,
                                       remat_policy=policy,
                                       freeze_backbone=freeze),
        data=dataclasses.replace(cfg.data, batch_size=4),
        train=dataclasses.replace(cfg.train, optimizer="adam",
                                  ignore_threshold=0.5, obj_target="iou",
                                  schedule=tconfig.ScheduleConfig(
                                      kind="constant", base_lr=1e-3)))


def _steps(cfg, steps=1):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 48, 48, 3)).astype(np.uint8)
    boxes = np.zeros((4, 6, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.2, 0.8, (4, 6, 2))
    boxes[..., 2:4] = rng.uniform(0.05, 0.6, (4, 6, 2))
    boxes[..., 4] = rng.randint(0, 3, (4, 6))
    valid = rng.rand(4, 6) < 0.8
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(cfg)
    for _ in range(steps):
        state, metrics = step(state, images, boxes, valid, seed=3)
    return state, metrics


@pytest.fixture()
def residual_micro(monkeypatch):
    """darknet_micro's name on RESIDUAL: the FPN model over residual
    stages and two taps (base_filters 512, 3 scales at 6 / 12 / 24). The
    backbones' shape probes are cached by name, so they are cleared."""
    backbone_feature_size.cache_clear()
    monkeypatch.setitem(tdarknet.ARCHITECTURES, "darknet_micro", RESIDUAL)
    yield
    backbone_feature_size.cache_clear()


@pytest.fixture()
def plain_step(residual_micro):
    return _steps(_remat_cfg(False))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_fpn_remat_is_bit_equal_to_the_step_without(policy, plain_step):
    plain, plain_metrics = plain_step
    remat, metrics = _steps(_remat_cfg(True, policy))
    assert remat.model.backbone.tap_segments == \
        plain.model.backbone.tap_segments
    for k in metrics:
        assert torch.equal(metrics[k], plain_metrics[k]), k
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_frozen_backbone_hands_the_taps_to_the_trained_head(residual_micro):
    before = create_train_state(_remat_cfg(False, freeze=True),
                                torch.Generator().manual_seed(0),
                                device="cpu").model.state_dict()
    state, metrics = _steps(_remat_cfg(False, freeze=True), steps=2)
    for k, v in state.model.state_dict().items():
        moved = not torch.equal(v, before[k])
        assert moved == k.startswith("head."), k
    assert torch.isfinite(metrics["total"])


@pytest.mark.parametrize("num_convs", [None, 6])
def test_darknet_weights_walk_the_residual_table_as_jax(tmp_path, num_convs):
    """JAX's save of the RESIDUAL backbone (or its first 6 convs, a
    residual unit cut in half), loaded by the port: JAX's own load."""
    jb, v, _ = _backbones(RESIDUAL, 0, seed=6)
    wrap = lambda t: {"DarknetBackbone_0": t}  # noqa: E731
    path = str(tmp_path / "r.weights")
    jimport.save_darknet_backbone(wrap(v["params"]), wrap(v["batch_stats"]),
                                  path, num_convs=num_convs, seen=7)
    _, fresh_v, fresh = _backbones(RESIDUAL, 0, seed=8)
    fresh = {f"backbone.{k}": t for k, t in fresh.state_dict().items()}
    jp, js, jinfo = jimport.load_darknet_backbone(
        wrap(fresh_v["params"]), wrap(fresh_v["batch_stats"]), path)
    loaded, info = darknet_import.load_darknet_backbone(fresh, path)
    assert info == {k: jinfo[k] for k in info}
    assert info["loaded_convs"] == (num_convs or 12)
    want = flax_to_torch(jax.device_get(jp), jax.device_get(js))
    for k, t in loaded.items():
        assert torch.equal(t, want[k]), k
