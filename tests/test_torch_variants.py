"""The v1 transfer-learning family of the port against the JAX package's:
``VGG16Backbone``, ``MobileNetV2Backbone``, darknet19, ``GAPDenseHead`` (with
and without BatchNorm), ``MultiConvDenseHead`` (eval mode, and training
mode with JAX's own dropout mask), ``flat_output``, ``count_params``, and
the weight init (flax's ``lecun_normal``: fault 3.1 of the port's ROADMAP).

The flax variables are randomised from a numpy seed
(``test_torch_model.randomized_variables``) and carried across with
``flax_to_torch``. Tolerances: float32 1e-4 (sums in another order),
bfloat16 5e-2 (the frameworks round to bf16 at other points), as
``test_torch_model.py``; integer and mask outputs exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models import backbones as jbackbones
from keras_object_detection_tpu.models import yolo as jyolo
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models import backbones, yolo
from test_torch_model import randomized_variables


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfg(backbone, head, size, dtype="float32", **model):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=2, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone=backbone, head=head,
                                  image_size=size, compute_dtype=dtype,
                                  **model))


def _images(size, batch=2, seed=2):
    return np.random.RandomState(seed).uniform(
        0, 1, (batch, size, size, 3)).astype(np.float32)


def _variables(module, x, seed, **kw):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    return randomized_variables(jax.device_get(v), seed)


def _sub_state(variables, top, prefix):
    """A flax submodule's variables as a port module's state dict: the
    converter's keys under ``prefix`` (``backbone.`` / ``head.``)."""
    sd = flax_to_torch({top: variables["params"]},
                       {top: variables.get("batch_stats", {})}
                       if variables.get("batch_stats") else {})
    return {k[len(prefix):]: v for k, v in sd.items()}


def _nchw(x, dtype="float32"):
    t = torch.from_numpy(x).to(TDT[dtype]).permute(0, 3, 1, 2)
    return t.contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert np.abs(want).max() > 0.1  # the weights give O(1) outputs
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_train_close(got, want, want_f32):
    """bf16 in training mode, where every BatchNorm normalises by batch
    statistics of a few rows: a last-bit difference of two bf16 roundings
    grows through the layers, and JAX's own flax and fused BatchNorms part
    by up to 0.16 on these inputs (0.21 from float32). So the yardstick is
    the float32 forward: the port's bf16 output lies no further from it
    than JAX's bf16 output does (1.25x, + 1e-3), and within 5e-2 of JAX's
    bf16 output in norm."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ours, theirs = _rel(got, want_f32), _rel(want, want_f32)
    assert ours <= 1.25 * theirs + 1e-3, (ours, theirs)
    assert _rel(got, want) <= TOL["bfloat16"], _rel(got, want)


NARROW_VGG = ((8, 1), (16, 2), (16, 1), (24, 1), (24, 1))
NARROW_MNV2 = ((1, 8, 1, 1), (2, 8, 2, 2), (2, 16, 1, 2), (3, 16, 2, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vgg16_backbone_matches_jax(dtype):
    x = _images(64)
    jm = jbackbones.VGG16Backbone(dtype=JDT[dtype], widths=NARROW_VGG)
    v = _variables(jm, x, 0)
    want = jm.apply(v, jnp.asarray(x))
    tm = backbones.VGG16Backbone(TDT[dtype], NARROW_VGG,
                                 generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(_sub_state(v, "VGG16Backbone_0", "backbone."))
    with torch.no_grad():
        got = tm(_nchw(x, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (2, 24, 2, 2)
    assert len(tm.convs) == 6 and all(c.bias is not None for c in tm.convs)
    _close(_nhwc(got), want, dtype)


@pytest.mark.parametrize("bn_mode", ["flax", "fused"])
@pytest.mark.parametrize("train,dtype", [(False, "float32"), (True, "float32"),
                                         (True, "bfloat16")])
def test_mobilenetv2_backbone_matches_jax(bn_mode, train, dtype):
    """A narrow schedule with a t=1 block, stride-2 SAME depthwise convs on
    even sizes (0 low, 1 high), and residual blocks; in training mode the
    running statistics after one forward at momentum 0.999 too."""
    x = _images(32, batch=3)
    jm = jbackbones.MobileNetV2Backbone(dtype=JDT[dtype], bn_mode=bn_mode,
                                        schedule=NARROW_MNV2)
    v = _variables(jm, x, 1)
    want, upd = jm.apply(v, jnp.asarray(x), train=train,
                         mutable=["batch_stats"])
    tm = backbones.MobileNetV2Backbone(
        TDT[dtype], NARROW_MNV2, generator=torch.Generator().manual_seed(0),
        bn_mode=bn_mode)
    tm.load_state_dict(_sub_state(v, "MobileNetV2Backbone_0", "backbone."))
    tm.train(train)
    assert [b.residual for b in tm.blocks] == [False, False, True, False,
                                               True, True]
    assert all(bn.momentum == 0.999 and bn.eps == 1e-3
               for bn in tm.modules() if hasattr(bn, "running_var"))
    assert tm.blocks[1].convs[1].groups == 16
    with torch.no_grad():
        got = tm(_nchw(x, dtype))
    assert got.shape == (3, 1280, 4, 4) and got.dtype == TDT[dtype]
    if train and dtype == "bfloat16":
        f32 = jm.clone(dtype=jnp.float32).apply(v, jnp.asarray(x), train=True,
                                                mutable=["batch_stats"])[0]
        _bf16_train_close(_nhwc(got), want, np.asarray(f32))
    else:
        _close(_nhwc(got), want, dtype)
    if train:
        stats = _sub_state({"params": v["params"],
                            "batch_stats": upd["batch_stats"]},
                           "MobileNetV2Backbone_0", "backbone.")
        for k, t in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(),
                                           rtol=TOL[dtype], atol=TOL[dtype],
                                           err_msg=k)
                assert not torch.equal(t, torch.from_numpy(np.asarray(
                    flax_to_torch({"MobileNetV2Backbone_0": v["params"]},
                                  {"MobileNetV2Backbone_0":
                                   v["batch_stats"]})["backbone." + k])))


def _models(cfg, seed, size, **yolo_kw):
    """The JAX model with randomised variables and the port's with them."""
    if yolo_kw:
        jm = jyolo.YoloV1(**dict(
            backbone=cfg.model.backbone, head=cfg.model.head, grid=2,
            num_classes=3, num_boxes=2,
            compute_dtype=JDT[cfg.model.compute_dtype],
            head_dense_units=cfg.model.head_dense_units,
            head_batchnorm=cfg.model.head_batchnorm,
            activation=cfg.model.activation, bn_mode=cfg.model.bn_mode),
            **yolo_kw)
    else:
        jm = jyolo.build_model(cfg)
    v = _variables(jm, _images(size, 1), seed, train=False)
    tcfg = tconfig.Config.from_json(cfg.to_json())
    tm = build_model(tcfg)
    if yolo_kw:
        tm = yolo.YoloV1(
            tcfg.model.backbone, tcfg.model.head, 2, 3, 2,
            TDT[cfg.model.compute_dtype], tcfg.model.activation,
            generator=torch.Generator().manual_seed(0),
            bn_mode=tcfg.model.bn_mode, image_size=size,
            head_dense_units=tcfg.model.head_dense_units,
            head_batchnorm=tcfg.model.head_batchnorm, **yolo_kw).eval()
    tm.load_state_dict(flax_to_torch(v["params"], v.get("batch_stats", {}), tm))
    return jm, v, tm


@pytest.mark.parametrize("activation,dtype", [("relu", "float32")])
def test_darknet19_matches_jax(activation, dtype):
    """darknet19's 18 ConvBlocks + the conv head. The registry's LeakyReLU
    default never applies through the model: YoloV1 passes the config's
    activation, as the JAX model does."""
    cfg = _cfg("darknet19", "conv", 64, dtype, activation=activation)
    jm, v, tm = _models(cfg, 3, 64)
    assert len(tm.backbone.blocks) == 18
    assert {b.activation for b in tm.backbone.blocks} == {activation}
    assert backbones.BACKBONES["darknet19"](
        torch.float32, generator=torch.Generator()).blocks[0].activation \
        == "leaky_relu"
    x = _images(64)
    want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 13)
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("head_batchnorm,bn_mode", [
    (False, "flax"), (True, "flax"), (True, "fused"), (True, "mxu"),
    (True, "flax@1")])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gap_dense_head_matches_jax(head_batchnorm, bn_mode, train, dtype):
    """darknet_micro + GAPDenseHead: GAP (float32 sums, one rounding),
    Dense, the 2-D BatchNorm of every mode (fused through the kernels'
    plain versions), ReLU, the float32 Dense; in training mode the running
    statistics too."""
    cfg = _cfg("darknet_micro", "gap_dense", 56, dtype, head_dense_units=48,
               head_batchnorm=head_batchnorm, bn_mode=bn_mode)
    jm, v, tm = _models(cfg, 4, 56)
    assert (tm.head.bn is not None) == head_batchnorm
    x = _images(56, batch=3)
    want, upd = jm.apply(v, jnp.asarray(x), train=train,
                         mutable=["batch_stats"])
    tm.train(train)
    got = tm(torch.from_numpy(x))
    assert got.shape == (3, 2, 2, 13)
    if train and dtype == "bfloat16":
        f32 = jyolo.build_model(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="float32"))).apply(
                v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
        _bf16_train_close(got.detach().numpy(), want, np.asarray(f32))
    else:
        _close(got.detach().numpy(), want, dtype)
    if train:
        stats = flax_to_torch(v["params"], upd["batch_stats"], tm)
        for k, t in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), stats[k].numpy(),
                                           rtol=TOL[dtype], atol=TOL[dtype],
                                           err_msg=k)


def _dropout_run(x, train, dtype):
    """JAX's MultiConvDenseHead on NHWC features: output, updated stats and,
    in training mode, the keep mask its Dropout drew (from
    capture_intermediates: kept where the output is not 0 or the input
    was 0)."""
    head = jyolo.MultiConvDenseHead(grid=2, cell_depth=13, dense_units=(8, 16),
                                    dtype=JDT[dtype])
    v = _variables(head, x, 5)
    (y, state) = head.apply(v, jnp.asarray(x, JDT[dtype]), train=train,
                            rngs={"dropout": jax.random.PRNGKey(9)},
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=True)
    mask = None
    if train:
        inter = state["intermediates"]
        dense_in = np.asarray(inter["Dense_1"]["__call__"][0]
                              .astype(jnp.float32))
        dropped = np.asarray(inter["Dropout_0"]["__call__"][0]
                             .astype(jnp.float32))
        mask = (dropped != 0) | (dense_in == 0)
        assert 0.3 < mask.mean() < 0.7
    return head, v, y, state["batch_stats"], mask


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_conv_dense_head_matches_jax(train, dtype):
    """4 ConvBlocks (stride 2 on the second), NHWC flatten, the Dense stack,
    dropout with JAX's own mask in training mode, the float32 Dense."""
    x = np.random.RandomState(6).normal(0, 1, (2, 4, 4, 16)).astype(np.float32)
    _, v, want, stats, mask = _dropout_run(x, train, dtype)
    th = yolo.MultiConvDenseHead(16, 2, 13, 4, (8, 16), dtype=TDT[dtype],
                                 generator=torch.Generator().manual_seed(0))
    th.load_state_dict(_sub_state(v, "MultiConvDenseHead_0", "head."))
    th.train(train)
    keep = None if mask is None else torch.from_numpy(mask)
    got = th(_nchw(x, dtype), keep)
    assert got.shape == (2, 2, 2, 13)
    _close(got.detach().numpy(), want, dtype)
    if train:
        sd = _sub_state({"params": v["params"], "batch_stats": stats},
                        "MultiConvDenseHead_0", "head.")
        for k, t in th.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(t.numpy(), sd[k].numpy(),
                                           rtol=TOL[dtype], atol=TOL[dtype])
        # another mask gives another output: the mask is what JAX drew
        other = th(_nchw(x, dtype), ~keep)
        assert not np.allclose(other.detach().numpy(), got.detach().numpy())


def test_dropout_takes_a_mask_or_a_generator_never_the_global_rng():
    from keras_object_detection_torch.models.layers import Dropout

    d = Dropout(0.5).train()
    x = torch.ones(64, 32)
    with pytest.raises(ValueError, match="mask"):
        d(x)
    a = d(x, torch.Generator().manual_seed(3))
    torch.manual_seed(0)
    b = d(x, torch.Generator().manual_seed(3))
    torch.manual_seed(1)
    c = d(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.equal(b, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(d.eval()(x, None), x)
