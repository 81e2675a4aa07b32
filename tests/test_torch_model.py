"""Parity of the PyTorch port's model with the JAX package's on the same
weights: the flax variables, randomised from a numpy seed, are carried
across with ``flax_to_torch`` and both forwards see the same images.

Tolerances: float32 1e-4 (the conv sums run in another order); bfloat16
5e-2 (the two frameworks round to bf16 at different points)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.models.layers import ConvBlock as JConvBlock
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models.layers import ConvBlock, same_padding


def randomized_variables(variables, seed):
    """Replace every flax leaf with numpy-seeded values: He-scaled kernels
    and non-trivial biases and BN statistics, so every term of the forward
    matters and the detections spread across the thresholds."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = np.shape(x)
        if name == "kernel":
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            v = rng.normal(0, std, shape)
        elif name == "bias":
            v = rng.normal(0, 0.1, shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = rng.normal(0, 0.2, shape)
        else:  # var
            v = rng.uniform(0.5, 2.0, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_model_and_variables(cfg, seed):
    model = jbuild(cfg)
    size = cfg.model.image_size
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, size, size, 3)), train=False)
    return model, randomized_variables(jax.device_get(variables), seed)


def port_model(cfg, variables):
    model = build_model(tconfig.Config.from_json(cfg.to_json()))
    model.load_state_dict(flax_to_torch(variables["params"],
                                        variables["batch_stats"], model))
    return model


def _cfg(backbone, size, dtype):
    return jconfig.Config(
        grid=jconfig.GridConfig(grid=7, num_boxes=2, num_classes=3),
        model=jconfig.ModelConfig(backbone=backbone, head="conv",
                                  image_size=size, compute_dtype=dtype))


@pytest.mark.parametrize("backbone,size", [("darknet_micro", 56),
                                           ("darknet_tiny", 224)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_forward_matches_jax(backbone, size, dtype, tol):
    cfg = _cfg(backbone, size, dtype)
    jmodel, variables = jax_model_and_variables(cfg, seed=1)
    images = np.random.RandomState(2).uniform(0, 1, (2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), train=False))
    with torch.no_grad():
        got = port_model(cfg, variables)(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (2, 7, 7, 13)
    assert np.abs(want).max() > 0.5  # the weights give O(1) outputs
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("padding,stride,size", [
    (1, 1, 9), (0, 1, 8), (3, 2, 15), ("SAME", 1, 7), ("SAME", 2, 14),
    ("SAME", 2, 15)])
@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
def test_conv_block_matches_flax(padding, stride, size, activation):
    """Including XLA's SAME at stride 2, which pads 0 low and 1 high when
    the total is odd (14 -> 7 with a 3x3 kernel)."""
    k = 3 if padding != 3 else 7
    block = JConvBlock(8, k, stride, padding, activation=activation)
    x = np.random.RandomState(3).normal(0, 1, (2, size, size, 5)).astype(
        np.float32)
    variables = randomized_variables(jax.device_get(
        block.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=4)
    want = np.asarray(block.apply(variables, jnp.asarray(x)))

    tblock = ConvBlock(5, 8, k, stride, padding, activation,
                       generator=torch.Generator().manual_seed(0)).eval()
    p, s = variables["params"], variables["batch_stats"]
    sd = {"conv.weight": np.transpose(p["Conv_0"]["kernel"], (3, 2, 0, 1)),
          "conv.bias": p["Conv_0"]["bias"],
          "bn.weight": p["BatchNorm_0"]["scale"],
          "bn.bias": p["BatchNorm_0"]["bias"],
          "bn.running_mean": s["BatchNorm_0"]["mean"],
          "bn.running_var": s["BatchNorm_0"]["var"]}
    tblock.load_state_dict({n: torch.tensor(np.array(v)) for n, v in sd.items()})
    with torch.no_grad():
        got = tblock(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_same_padding_follows_xla():
    assert same_padding(14, 3, 2) == (0, 1)
    assert same_padding(15, 3, 2) == (1, 1)
    assert same_padding(7, 3, 1) == (1, 1)
    assert same_padding(7, 1, 1) == (0, 0)


def test_eval_bn_runs_in_float32_like_installed_flax():
    """bf16 input, f32 statistics: flax's normalize promotes to f32 and
    casts once, so the port must match it bit for bit."""
    x = np.random.RandomState(5).normal(0, 3, (2, 4, 4, 6)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-3,
                       dtype=jnp.bfloat16)
    variables = randomized_variables(
        jax.device_get(bn.init(jax.random.PRNGKey(0), xb)), seed=6)
    want = np.asarray(bn.apply(variables, xb).astype(jnp.float32))

    from keras_object_detection_torch.models.layers import BatchNorm
    tbn = BatchNorm(6).eval()
    tbn.load_state_dict({
        "weight": torch.tensor(variables["params"]["scale"]),
        "bias": torch.tensor(variables["params"]["bias"]),
        "running_mean": torch.tensor(variables["batch_stats"]["mean"]),
        "running_var": torch.tensor(variables["batch_stats"]["var"])})
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tbn(xt).permute(0, 2, 3, 1).float().numpy()
    # rsqrt may differ in its last f32 bit between XLA and torch; after
    # the bf16 cast the two agree to one bf16 ulp at most
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_training_mode_bn_raises():
    """Training-mode BatchNorm is ported for every bn_mode of the JAX
    package (flax, fused, mxu, flax@N); a malformed mode raises ValueError,
    as JAX's make_batch_norm does."""
    for mode in ("flax", "fused", "mxu", "flax@4"):
        cfg = tconfig.tiny_cpu_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bn_mode=mode))
        assert build_model(cfg).train().backbone.blocks[0].bn.bn_mode == mode
    for mode in ("flax@0", "flax@", "mxu@2", "pallas"):
        cfg = tconfig.tiny_cpu_config()
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bn_mode=mode))
        with pytest.raises(ValueError, match="bn_mode"):
            build_model(cfg)


@pytest.mark.parametrize("bn_mode", ["flax", "fused"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_training_mode_forward_matches_jax(bn_mode, dtype, tol):
    """The whole model in training mode: outputs and the updated running
    statistics of every BatchNorm against the JAX model's."""
    cfg = _cfg("darknet_micro", 56, dtype)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_mode=bn_mode))
    jmodel, variables = jax_model_and_variables(cfg, seed=7)
    images = np.random.RandomState(8).uniform(0, 1, (3, 56, 56, 3)).astype(
        np.float32)
    want, updates = jmodel.apply(variables, jnp.asarray(images), train=True,
                                 mutable=["batch_stats"])
    model = port_model(cfg, variables).train()
    got = model(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    stats = flax_to_torch(variables["params"],
                          jax.device_get(updates["batch_stats"]), model)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), rtol=tol,
                                       atol=tol, err_msg=k)


@pytest.mark.parametrize("override,item", [
    ({"head": "fpn"}, "requires GridConfig.anchors"),
    ({"head": "fpn", "fpn_scales": 2}, "requires GridConfig.anchors"),
    ({"backbone": "darknet53", "head": "flatten_dense"}, (1, 7, 7, 13)),
    ({"backbone": "darknet53", "head": "gap_dense"}, (1, 7, 7, 13)),
    ({"backbone": "darknet53"}, (1, 7, 7, 13))])
def test_unported_parts_raise(override, item):
    """What were the FPN family's refusals: the FPN head without priors
    raises ValueError, as JAX's build_model does; Darknet-53 pairs with the
    v1 heads and gives JAX's output shape (by shapes: JAX's eval_shape,
    the port on the meta device)."""
    cfg = tconfig.tiny_cpu_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             **override))
    jcfg = jconfig.Config.from_json(cfg.to_json())
    x = jnp.zeros((1, 224, 224, 3))
    if isinstance(item, str):
        with pytest.raises(ValueError, match=item):
            jbuild(jcfg).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError, match=item):
            build_model(cfg)
        return
    model = jbuild(jcfg)
    want = jax.eval_shape(lambda: model.apply(
        model.init(jax.random.PRNGKey(0), x), x)).shape
    with torch.device("meta"):
        got = build_model(cfg, torch.Generator())(torch.empty(1, 224, 224, 3))
    assert tuple(got.shape) == tuple(want) == item


@pytest.mark.parametrize("kwargs,want", [
    ({"architecture": (("R", 64, 1),)}, "residual"),
    ({"return_tap": True, "return_taps": 1}, "exclusive"),
    ({"return_taps": 2}, "two taps")])
def test_unported_backbone_grammar_raises(kwargs, want):
    """What were the grammar's refusals: a residual entry builds (1x1 32 ->
    3x3 64, added back), return_tap with return_taps raises ValueError as
    in JAX, and return_taps=2 returns the two feature maps before the last
    two downsamples, coarse -> fine."""
    from keras_object_detection_torch.models.darknet import DarknetBackbone
    if want == "exclusive":
        with pytest.raises(ValueError, match=want):
            DarknetBackbone(generator=torch.Generator(), **kwargs)
        return
    model = DarknetBackbone(generator=torch.Generator(), in_channels=64,
                            **kwargs).eval()
    x = torch.rand(1, 64, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x)
    if want == "residual":
        assert [tuple(b.conv.weight.shape) for b in model.blocks] == [
            (32, 64, 1, 1), (64, 32, 3, 3)]
        assert torch.equal(out, x + model.blocks[1](model.blocks[0](x)))
    else:  # darknet24 at 64²: 1x1 features, taps at 2x2 and 4x4
        feats, taps = out
        assert [tuple(t.shape[2:]) for t in taps] == [(2, 2), (4, 4)]
        assert tuple(feats.shape[2:]) == (1, 1)


def _full_width_shapes():
    model = jbuild(jconfig.voc_full_config())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 448, 448, 3)), train=False))
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)


def test_full_width_state_dict_matches_jax_tree():
    """voc_full_config: Darknet-24 + conv head, 25 ConvBlocks x 6 leaves +
    the final 1x1 conv's kernel and bias = 152 tensors, 69,681,758 values."""
    variables = _full_width_shapes()
    model = build_model(tconfig.voc_full_config())
    sd = flax_to_torch(variables["params"], variables["batch_stats"], model)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert len(sd) == 152
    assert sum(v.numel() for v in sd.values()) == 69_681_758
    assert next(model.parameters()).dtype == torch.float32
    assert model.compute_dtype == torch.bfloat16


def _tiny_variables():
    cfg = _cfg("darknet_micro", 56, "float32")
    return cfg, jax_model_and_variables(cfg, seed=0)[1]


def test_converter_raises_on_extra_key():
    _, v = _tiny_variables()
    v["params"]["ConvHead_0"]["Dense_0"] = {"kernel": np.zeros((4, 4))}
    with pytest.raises(ValueError, match="unknown flax module"):
        flax_to_torch(v["params"], v["batch_stats"])
    _, v = _tiny_variables()
    v["params"]["DarknetBackbone_0"]["ConvBlock_0"]["Conv_0"]["extra"] = \
        np.zeros(3)
    with pytest.raises(ValueError, match="unknown flax leaf"):
        flax_to_torch(v["params"], v["batch_stats"])


def test_converter_raises_on_missing_key():
    _, v = _tiny_variables()
    del v["batch_stats"]["DarknetBackbone_0"]["ConvBlock_2"]["BatchNorm_0"]["var"]
    with pytest.raises(ValueError, match="lacks"):
        flax_to_torch(v["params"], v["batch_stats"])


def test_converter_raises_on_keys_the_model_lacks():
    cfg, v = _tiny_variables()
    block = v["params"]["DarknetBackbone_0"]["ConvBlock_0"]
    v["params"]["DarknetBackbone_0"]["ConvBlock_9"] = block
    v["batch_stats"]["DarknetBackbone_0"]["ConvBlock_9"] = \
        v["batch_stats"]["DarknetBackbone_0"]["ConvBlock_0"]
    model = build_model(tconfig.Config.from_json(cfg.to_json()))
    with pytest.raises(ValueError, match="model lacks"):
        flax_to_torch(v["params"], v["batch_stats"], model)
    # and a model with a missing conv raises through load_state_dict too
    sd = flax_to_torch(v["params"], v["batch_stats"])
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd)


@pytest.mark.parametrize("factory", ["tiny_cpu_config", "voc_full_config"])
def test_config_json_round_trips_between_packages(factory):
    jcfg = getattr(jconfig, factory)()
    tcfg = tconfig.Config.from_json(jcfg.to_json())
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == getattr(tconfig, factory)()
    back = jconfig.Config.from_json(tcfg.to_json())
    assert back == jcfg
