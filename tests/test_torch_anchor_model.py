"""The port's YOLOv2 models against the JAX package's, ``darknet_micro`` @56
(S = 7, the JAX tests' three anchors, C = 3, float32): the backbone's tap
(the table's downsample indices and the feature map before the last one,
1e-5), the forward of the plain anchor head and of the passthrough head in
eval and training mode with the running statistics (1e-5 relative, and
1e-5 of the output's largest magnitude absolute: the randomized weights
give outputs near 5, whose float32 sums part by up to 4e-5), the converter's
names taken from JAX's own ``init`` tree (at full width too: Darknet-19 +
passthrough at 416², 125 channels), the guards' errors, and remat
(``full``, ``dots``) with passthrough bit-equal to the step without."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models import darknet as jdarknet
from keras_object_detection_tpu.models.yolo import YoloV1 as JYoloV1
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models import darknet as tdarknet
from keras_object_detection_torch.models.layers import ConvBlock
from keras_object_detection_torch.models.yolo import (PassthroughConvHead,
                                                      YoloV1)
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)
from test_torch_model import randomized_variables

ANCHORS = ((0.1, 0.15), (0.4, 0.3), (0.8, 0.8))
# darknet's cfg/yolo-voc.cfg priors in 13-cell units, as image ratios
VOC_ANCHORS = tuple((w / 13, h / 13) for w, h in (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (9.47112, 4.84053), (11.2364, 10.0071)))


def anchor_cfg(passthrough=True, backbone="darknet_micro", size=56, grid=7,
               anchors=ANCHORS, classes=3, head="anchor", **model):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=grid, num_boxes=2, num_classes=classes,
                                anchors=anchors),
        model=jconfig.ModelConfig(backbone=backbone, head=head,
                                  image_size=size, compute_dtype="float32",
                                  passthrough=passthrough, **model))


def _pair(jcfg, seed=0):
    jmodel = jbuild(jcfg)
    size = jcfg.model.image_size
    variables = randomized_variables(jax.device_get(jax.jit(
        jmodel.init, static_argnames="train")(
            jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
            train=False)), seed)
    model = build_model(tconfig.Config.from_json(jcfg.to_json()))
    model.load_state_dict(flax_to_torch(variables["params"],
                                        variables["batch_stats"], model))
    return jmodel, variables, model


def _images(seed, b=2, size=56):
    return np.random.RandomState(seed).uniform(0, 1, (b, size, size, 3)).astype(
        np.float32)


def test_downsample_indices_and_tap_match_jax():
    for name, table in tdarknet.ARCHITECTURES.items():
        assert tdarknet._downsample_indices(table) == \
            jdarknet._downsample_indices(jdarknet.ARCHITECTURES[name])
    x = _images(1)
    jb = jdarknet.DarknetBackbone(
        architecture=jdarknet.ARCHITECTURES["darknet_micro"], return_tap=True)
    variables = randomized_variables(jax.device_get(
        jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x))), 0)
    want, want_tap = jax.jit(jb.apply)(variables, jnp.asarray(x))
    tb = tdarknet.DarknetBackbone(tdarknet.ARCHITECTURES["darknet_micro"],
                                  generator=torch.Generator(), return_tap=True)
    sd = {k.replace("backbone.", "", 1): v for k, v in flax_to_torch(
        {"DarknetBackbone_0": variables["params"]},
        {"DarknetBackbone_0": variables["batch_stats"]}).items()}
    tb.load_state_dict(sd)
    with torch.no_grad():
        got, tap = tb.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(tap.shape) == (2, 64, 14, 14) and tb.tap_channels == 64
    np.testing.assert_allclose(tap.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_tap), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    # the tap starts a segment of its own; darknet24's is a strided conv
    assert tb._groups[tb.tap_segments[0]] == ["M", 0]
    d24 = tdarknet.DarknetBackbone(generator=torch.Generator(),
                                   return_tap=True)
    assert d24.tap_channels == 1024 and d24._groups[d24.tap_segments[0]][0] == 21
    # the FPN's taps: the same first tap, then the one before the downsample
    # before it
    d24 = tdarknet.DarknetBackbone(generator=torch.Generator(), return_taps=2)
    assert d24.tap_channels == (1024, 1024)
    assert [d24._groups[i][0] for i in d24.tap_segments] == [21, "M"]
    with pytest.raises(ValueError, match="1 taps need 1 downsamples"):
        tdarknet.DarknetBackbone(((3, 8, 1, 1),), generator=torch.Generator(),
                                 return_tap=True)


@pytest.mark.parametrize("passthrough,activation", [(True, "leaky_relu"),
                                                    (False, "relu")])
def test_anchor_model_forward_matches_jax(passthrough, activation):
    """With leaky_relu the backbone's blocks leak and the head's stay ReLU,
    as in JAX."""
    jcfg = anchor_cfg(passthrough, activation=activation)
    jmodel, variables, model = _pair(jcfg)
    assert isinstance(model.head, PassthroughConvHead) == passthrough
    assert model.backbone.blocks[0].activation == activation
    assert all(m.activation == "relu" for m in model.head.modules()
               if isinstance(m, ConvBlock))
    x = _images(2)
    apply = jax.jit(jmodel.apply, static_argnames=("train", "mutable"))
    want = np.asarray(apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, 7, 7, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    # training mode: batch statistics, and the running statistics after
    want, updates = apply(variables, jnp.asarray(x), train=True,
                          mutable=("batch_stats",))
    want = np.asarray(want)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    stats = flax_to_torch(variables["params"],
                          jax.device_get(updates["batch_stats"]), model)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_full_width_yolov2_names_and_shapes_match_jax():
    """Darknet-19 + passthrough at 416², S = 13, darknet's 5 VOC priors,
    C = 20: JAX's ``init`` tree (by ``eval_shape``) converts to exactly the
    port's keys and shapes, 125 output channels, the head's 1280-channel
    conv after the fold."""
    jcfg = anchor_cfg(True, "darknet19", 416, 13, VOC_ANCHORS, 20,
                      activation="leaky_relu")
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 416, 416, 3)), train=False))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    assert "PassthroughConvHead_0" in zeros["params"]
    with torch.device("meta"):
        model = build_model(tconfig.Config.from_json(jcfg.to_json()),
                            torch.Generator())
        out = model(torch.empty(1, 416, 416, 3))
    assert tuple(out.shape) == (1, 13, 13, 125)
    sd = flax_to_torch(zeros["params"], zeros["batch_stats"], model)
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["head.blocks.2.conv.weight"].shape) == (1024, 1280, 3, 3)
    assert tuple(sd["head.conv.weight"].shape) == (125, 1024, 1, 1)
    assert model.head.block == 2 and model.backbone.tap_channels == 512
    # chip_smoke.YOLOV2_VALUES: the full-width count its phase checks
    assert sum(v.numel() for v in sd.values()) == 41_244_093


@pytest.mark.parametrize("override,match", [
    (dict(head="conv", passthrough=True), "passthrough requires head='anchor'"),
    (dict(backbone="vgg16", head="anchor", passthrough=True),
     "passthrough supports darknet backbones only, got 'vgg16'"),
    (dict(head="anchor", anchors=()), "requires GridConfig.anchors")])
def test_guards_raise_as_jax(override, match):
    anchors = override.pop("anchors", ANCHORS)
    jcfg = anchor_cfg(**{"passthrough": False, **override, "anchors": anchors})
    with pytest.raises(ValueError, match=match):
        size = jcfg.model.image_size
        jbuild(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    with pytest.raises(ValueError, match=match):
        build_model(tconfig.Config.from_json(jcfg.to_json()))
    if anchors:
        with pytest.raises(ValueError, match=match):
            JYoloV1(**{k: v for k, v in override.items()},
                    anchors=anchors).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3)))
        with pytest.raises(ValueError, match=match):
            YoloV1(generator=torch.Generator(), anchors=anchors, **override)


def _remat_cfg(remat, policy="full", freeze=False):
    cfg = tconfig.Config.from_json(anchor_cfg().to_json())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=remat,
                                       remat_policy=policy,
                                       freeze_backbone=freeze),
        data=dataclasses.replace(cfg.data, batch_size=4),
        train=dataclasses.replace(cfg.train, optimizer="adam",
                                  ignore_threshold=0.6, obj_target="iou",
                                  schedule=tconfig.ScheduleConfig(
                                      kind="constant", base_lr=1e-3)))


def _steps(cfg, steps=1):
    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 56, 56, 3)).astype(np.uint8)
    boxes = np.zeros((4, 6, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.2, 0.8, (4, 6, 2))
    boxes[..., 2:4] = rng.uniform(0.1, 0.4, (4, 6, 2))
    boxes[..., 4] = rng.randint(0, 3, (4, 6))
    valid = rng.rand(4, 6) < 0.8
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    step = make_train_step(cfg)
    for _ in range(steps):
        state, metrics = step(state, images, boxes, valid, seed=3)
    return state, metrics


@pytest.fixture(scope="module")
def plain_step():
    return _steps(_remat_cfg(False))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_passthrough_remat_is_bit_equal_to_the_step_without(policy,
                                                             plain_step):
    plain, plain_metrics = plain_step
    remat, metrics = _steps(_remat_cfg(True, policy))
    assert remat.model.remat_policy == policy
    for k in metrics:
        assert torch.equal(metrics[k], plain_metrics[k]), k
    want = plain.model.state_dict()
    for k, v in remat.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_frozen_backbone_hands_the_tap_to_the_trained_head():
    before = create_train_state(_remat_cfg(False, freeze=True),
                                torch.Generator().manual_seed(0),
                                device="cpu").model.state_dict()
    state, metrics = _steps(_remat_cfg(False, freeze=True), steps=2)
    after = state.model.state_dict()
    for k, v in after.items():
        moved = not torch.equal(v, before[k])
        assert moved == (k.startswith("head.") and "num_batches" not in k), k
    assert torch.isfinite(metrics["total"])
