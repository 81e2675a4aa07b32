"""The port's int8 serving (``export/quantize.py``, ``export/int8_serving.py``,
``ops/int8_conv.py``) against the JAX package's ``export/`` on the CPU, on
JAX's variables (seeded, with non-trivial BatchNorm statistics) carried over
by ``flax_to_torch``.

Exact: the plans, the folds, ``w_q`` / ``w_scale`` / biases (the port's OHWI
kernels are JAX's HWIO through ``int8_serving.hwio``), the weight-only
``q`` / ``scale``, and the s32 accumulator of the int8 conv on the same int8
inputs. To a stated tolerance: the whole int8 forward (the float32 rescale
may be one FMA in XLA and two roundings here, and a value one ulp off before
a ``round`` moves an int8 value by one downstream), the calibration scales
(an argmin of 16 float32 MSEs), the bias corrections and the served rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keras_object_detection_tpu import config as jconfig
from keras_object_detection_tpu.export import int8_serving as J
from keras_object_detection_tpu.export import quantize as JQ
from keras_object_detection_tpu.models import backbones as jbackbones
from keras_object_detection_tpu.models import darknet as jdarknet
from keras_object_detection_tpu.models.yolo import build_model as jbuild
from keras_object_detection_torch import config as tconfig
from keras_object_detection_torch.eval.evaluator import InferenceModel
from keras_object_detection_torch.export import int8_serving as T
from keras_object_detection_torch.export import quantize as TQ
from keras_object_detection_torch.models import backbones as tbackbones
from keras_object_detection_torch.models import build_model, flax_to_torch
from keras_object_detection_torch.models import darknet as tdarknet
from keras_object_detection_torch.ops import int8_conv

from test_torch_model import randomized_variables
from test_torch_serving import near_boundary


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers on the same
    cores, and these small tensors gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


ANCHORS5 = ((0.14, 0.14), (0.19, 0.2), (0.26, 0.26), (0.35, 0.35),
            (0.41, 0.47))
ANCHORS6 = ((0.08, 0.1), (0.12, 0.18), (0.2, 0.15), (0.3, 0.4), (0.5, 0.45),
            (0.7, 0.7))
# Darknet-53's grammar at micro size (JAX's test_int8_serving.RES_MICRO):
# stride-2 convs and residual stages, 56² -> 7², the FPN tap at 14²
RES_MICRO = ((3, 16, 1, 1), (3, 32, 2, 1), ("R", 32, 2), (3, 64, 2, 1),
             ("R", 64, 1), (3, 64, 2, 1))


@pytest.fixture(scope="module", autouse=True)
def res_micro():
    """``darknet_res_micro`` in both packages' registries."""
    jdarknet.ARCHITECTURES["darknet_res_micro"] = RES_MICRO
    jbackbones.BACKBONES["darknet_res_micro"] = (
        lambda dtype, activation="leaky_relu", bn_mode="flax":
        jdarknet.DarknetBackbone(architecture=RES_MICRO, activation=activation,
                                 dtype=dtype, bn_mode=bn_mode))
    tdarknet.ARCHITECTURES["darknet_res_micro"] = RES_MICRO
    tbackbones.BACKBONES["darknet_res_micro"] = tbackbones._darknet("darknet_res_micro",
                                                            "leaky_relu")
    yield
    for registry in (jdarknet.ARCHITECTURES, jbackbones.BACKBONES,
                     tdarknet.ARCHITECTURES, tbackbones.BACKBONES):
        del registry["darknet_res_micro"]


def micro_cfg(anchors=(), nms="hard", **model):
    """JAX's ``_micro_cfg``: ``tiny_cpu_config()`` with darknet_micro at
    56² (float32)."""
    cfg = jconfig.tiny_cpu_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, anchors=anchors),
        model=dataclasses.replace(cfg.model, **{
            "backbone": "darknet_micro", "image_size": 56, **model}),
        eval=dataclasses.replace(cfg.eval, nms_mode=nms))


PLANS = {
    "conv": lambda: micro_cfg(),
    "anchor": lambda: micro_cfg(ANCHORS5, head="anchor"),
    "passthrough": lambda: micro_cfg(ANCHORS5, head="anchor",
                                     passthrough=True),
    "leaky": lambda: micro_cfg(activation="leaky_relu"),
    "fpn residual": lambda: micro_cfg(ANCHORS6, head="fpn", fpn_scales=2,
                                      backbone="darknet_res_micro",
                                      activation="leaky_relu"),
}


def variables(cfg, seed):
    """``(params, batch_stats)`` of ``cfg``'s JAX model, every leaf drawn
    from numpy (``randomized_variables``: BN means N(0, 0.2), variances
    U(0.5, 2), scales U(0.5, 1.5))."""
    size = cfg.model.image_size
    shapes = jax.eval_shape(lambda: jbuild(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    v = randomized_variables(shapes, seed)
    return v["params"], v["batch_stats"]


def port(cfg, params, batch_stats):
    """The port's config and ``state_dict`` of JAX's ``cfg`` and variables."""
    return (tconfig.Config.from_json(cfg.to_json()),
            flax_to_torch(params, batch_stats))


def images(seed, n=2):
    return np.random.RandomState(seed).randint(0, 256, (n, 56, 56, 3),
                                               np.uint8)


def assert_layers_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        for k in w:
            t = g[k].detach()
            if t.dim() == 4:
                t = T.hwio(t)
            np.testing.assert_array_equal(t.numpy(), np.asarray(w[k]),
                                          err_msg=f"layer {i} {k}")


def as_tuple(y):
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def assert_forward_close(got, want):
    """The int8 forward's tolerance against JAX's op-by-op forward: every
    value within 1e-4 of its grid's scale (max |y|); seen: 2e-6. (JAX's
    jitted program is no reference to hold it to: XLA fuses the rescale, a
    value one ulp off before a ``round`` moves an int8 value by one, and on
    the FPN + residual plan its own jitted and op-by-op grids part by 3-9 %
    of the scale.)"""
    for g, w in zip(as_tuple(got), as_tuple(want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-4 * scale, (np.abs(g - w).max(),
                                                     scale)


# --- plans, folds, kernels --------------------------------------------------


@pytest.mark.parametrize("backbone", sorted(J._TABLES))
def test_conv_plans_and_layer_counts_match_jax(backbone):
    for n_taps in (0, 1, 2):
        assert T.conv_plan(backbone, n_taps) == J.conv_plan(backbone, n_taps)
    for name, make in PLANS.items():
        cfg = dataclasses.replace(make(), model=dataclasses.replace(
            make().model, backbone=backbone))
        steps, blocks, finals = J._head_plan(cfg)
        assert T._head_plan(tconfig.Config.from_json(cfg.to_json())) == (
            steps, blocks, finals)
        # the layer list's length, from the plans, is the model's ConvBlock
        # and final conv count
        tcfg = tconfig.Config.from_json(cfg.to_json())
        if name == "passthrough" and backbone == "darknet53":
            continue  # its taps do not fold onto the grid at 56²
        with torch.device("meta"):
            model = build_model(tcfg, torch.Generator())
        n_layers = sum(1 for s in T.conv_plan(backbone, T._n_taps(tcfg))
                       if s[0] == "conv") + blocks + finals
        modules = [n for n, _ in model.named_modules()
                   if n.endswith(".conv") or n.startswith("head.convs.")]
        assert n_layers == len([n for n in modules if "." in n]), name
    with pytest.raises(ValueError, match="darknet"):
        T.conv_plan("vgg16")


def test_fold_and_quantize_kernel_are_jax_s():
    rng = np.random.RandomState(0)
    args = (rng.normal(0, 0.1, (3, 3, 4, 8)), rng.normal(0, 0.1, 8),
            rng.uniform(0.5, 1.5, 8), rng.normal(0, 0.2, 8),
            rng.normal(0, 0.3, 8), rng.uniform(0.5, 2.0, 8))
    args = tuple(a.astype(np.float32) for a in args)
    for got, want in zip(T.fold_conv_bn(*args), J.fold_conv_bn(*args)):
        np.testing.assert_array_equal(got, want)
    w = J.fold_conv_bn(*args)[0]
    for got, want in zip(T._quantize_kernel(w), J._quantize_kernel(w)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("float_tail", [0, 2])
def test_int8_layers_equal_jax(name, float_tail):
    cfg = PLANS[name]()
    params, stats = variables(cfg, 3)
    tcfg, sd = port(cfg, params, stats)
    jplan, jl = J.build_int8_layers(cfg, params, stats, float_tail=float_tail)
    tplan, tl = T.build_int8_layers(tcfg, sd, float_tail, "cpu")
    assert tplan == tuple(jplan)
    assert_layers_equal(tl, jl)


@pytest.mark.parametrize("kernel,stride,pad,size,cin,cout", [
    (3, 1, 1, 9, 3, 16), (3, 2, 1, 10, 16, 8), (1, 1, 0, 6, 16, 24),
    (3, 1, 0, 7, 8, 20), (7, 2, 3, 13, 3, 16), (3, 1, "SAME", 7, 16, 8),
    (3, 2, "SAME", 9, 5, 12), (3, 2, "SAME", 8, 8, 16), (1, 1, "SAME", 5, 40, 8),
])
def test_int8_conv_accumulator_equals_jax(kernel, stride, pad, size, cin,
                                          cout):
    """The s32 accumulator of ``ops/int8_conv.py`` on the CPU (the plain
    float64 GEMM) equals JAX's ``_int8_conv`` (``lax.conv_general_dilated``
    with int32 sums) on the same int8 operands, read with unit scales and a
    zero bias (|acc| < 2**24, exact in float32); and it equals an int64
    sum over the same patches."""
    rng = np.random.RandomState(kernel * 100 + size)
    xq = rng.randint(-127, 128, (2, size, size, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (kernel, kernel, cin, cout)).astype(np.int8)
    layer = {"w_q": jnp.asarray(wq), "w_scale": jnp.ones(cout, jnp.float32),
             "bias": jnp.zeros(cout, jnp.float32)}
    want = np.asarray(J._int8_conv(jnp.asarray(xq), jnp.float32(1.0), layer,
                                   stride, pad))
    w_ohwi = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    got = int8_conv.int8_conv2d(torch.from_numpy(xq), w_ohwi, stride, pad)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    a, _ = int8_conv.im2col(torch.from_numpy(xq), kernel, stride, pad)
    assert a.shape[1] % 8 == 0
    acc64 = a.long() @ int8_conv._kernel_matrix(w_ohwi, a.shape[1]).long().t()
    np.testing.assert_array_equal(acc64[:, :cout].reshape(got.shape).numpy(),
                                  got.numpy())


# --- the forward ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("float_tail", [0, 2])
def test_int8_forward_matches_jax(name, float_tail):
    """``int8_forward`` against JAX's, op by op, on the same layers and
    images (``assert_forward_close``), and with every conv float32
    (``float_tail`` all) the float ``InferenceModel`` to 1e-3, as in
    JAX's tests."""
    cfg = PLANS[name]()
    params, stats = variables(cfg, 4)
    tcfg, sd = port(cfg, params, stats)
    x = images(5)
    g, act = cfg.grid.grid, cfg.model.activation
    head_act = act if cfg.model.head == "fpn" else "relu"
    jplan, jl = J.build_int8_layers(cfg, params, stats, float_tail=float_tail)
    want = J.int8_forward(jplan, jl, jnp.asarray(x), g, act,
                          head_activation=head_act)
    tplan, tl = T.build_int8_layers(tcfg, sd, float_tail, "cpu")
    got = T.int8_forward(tplan, tl, torch.from_numpy(x), g, act,
                         head_activation=head_act)
    assert_forward_close(got, want)
    if float_tail:
        return
    _, fl = T.build_int8_layers(tcfg, sd, 10 ** 9, "cpu")
    folded = T.int8_forward(tplan, fl, torch.from_numpy(x), g, act,
                            head_activation=head_act)
    served = InferenceModel(tcfg, sd, device="cpu").predict_raw(x)
    for f, s in zip(as_tuple(folded), as_tuple(served)):
        np.testing.assert_allclose(f.numpy(), s.numpy(), atol=1e-3,
                                   rtol=1e-4)


def test_int8_inference_model_matches_jax():
    """``Int8InferenceModel`` on the anchor head: ``predict_raw`` close to
    JAX's op-by-op forward, ``predict_decoded`` to 1e-4 of JAX's served
    (jitted) one, ``predict``'s mask exact on a seed
    whose candidates sit 1e-5 clear of every decision and its rows to 1e-4;
    the footprint equal; staged latency with the fused keys."""
    cfg = PLANS["anchor"]()
    params, stats = variables(cfg, 6)
    tcfg, sd = port(cfg, params, stats)
    jm = J.Int8InferenceModel(cfg, params, stats)
    tm = T.Int8InferenceModel(tcfg, sd, device="cpu")
    for seed in range(30, 40):
        x = images(seed, 3)
        decoded = np.asarray(jm.predict_decoded(x))
        if not near_boundary(decoded, cfg.eval):
            break
    else:
        pytest.fail("no clean seed")
    jplan = J.build_int8_layers(cfg, params, stats)[0]
    assert_forward_close(tm.predict_raw(x), J.int8_forward(
        jplan, jm._layers, jnp.asarray(x), cfg.grid.grid))
    np.testing.assert_allclose(tm.predict_decoded(x).numpy(), decoded,
                               rtol=1e-4, atol=1e-4)
    want_rows, want_valid = jm.predict(x)
    got_rows, got_valid = tm.predict(x)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    assert 0 < want_valid.sum() < want_valid.size
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=1e-4,
                               atol=1e-4)
    single = tm.predict_single(x[0])
    assert torch.equal(single, got_rows[0][got_valid[0]])
    assert tm.memory_footprint() == jm.memory_footprint()
    lat = tm.benchmark_latency(x[:1], runs=1, staged=True, pipeline_k=1)
    assert set(lat) == {"p50_ms", "min_ms", "mean_ms", "batch",
                        "pipelined_per_call_ms"}


def _scale_candidates(x: np.ndarray):
    """The 16 (scale, MSE) of ``_optimal_act_scale``'s sweep, in float64."""
    x = x.astype(np.float64)
    absmax = np.abs(x).max()
    out = []
    for r in T._CLIP_RATIOS:
        s = max(r * absmax, 1e-12) / 127.0
        q = np.clip(np.round(x / s), -127, 127)
        out.append((s, np.mean((q * s - x) ** 2)))
    return sorted(out, key=lambda t: t[1])


@pytest.mark.parametrize("name,bias_tol", [("passthrough", 1e-5),
                                           ("fpn residual", 2e-2)])
def test_calibration_and_bias_correction_match_jax(monkeypatch, name,
                                                   bias_tol):
    """Static scales: where the sweep's best MSE is clearly apart from the
    runner-up (by more than 0.1 %, in float64 on the port's own input),
    the port's scale is JAX's to 1e-5 (the inputs' maxima differ in the last
    bits); elsewhere it is one of the two. Bias corrections, with JAX's
    scales for both (the passthrough plan's tap and reorg; the FPN plan's
    residuals, prediction branches and routes): every bias within
    ``bias_tol`` of the largest bias, and on average within 1e-3 of it.
    Each correction is a mean over images and positions, whose last bit
    differs between torch's and XLA's sums; the next layer's int8 input,
    ``act(y_int8 + correction)``, then moves by one step where it sat
    within an ulp of a rounding point: about 1.5e-5 of the values, a few
    in each of the FPN head's 1024-wide layers, and each shifts the means
    after it (seen on the FPN plan: 9.3e-3 at most, 2.1e-4 on average; on
    the passthrough plan 2.2e-7 at most)."""
    cfg = PLANS[name]()
    params, stats = variables(cfg, 7)
    tcfg, sd = port(cfg, params, stats)
    calib = images(8, 4)
    seen = []
    original = T._optimal_act_scale
    monkeypatch.setattr(T, "_optimal_act_scale",
                        lambda x: seen.append(x.numpy()) or original(x))
    got = T.calibrate_activation_scales(tcfg, sd, calib, device="cpu")
    want = J.calibrate_activation_scales(cfg, params, stats, calib)
    assert len(got) == len(want) == len(seen) > 0
    unclear = 0
    for g, w, x in zip(got, want, seen):
        (s1, e1), (s2, e2) = _scale_candidates(x)[:2]
        if e2 - e1 > 1e-3 * e1:
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            unclear += 1
            assert min(abs(g - s1) / s1, abs(g - s2) / s2) < 1e-5
    assert unclear < len(got)
    # the same static scales for both (JAX's): each rounding then sees the
    # same grid
    tplan, tl = T.bias_corrected_layers(tcfg, sd, calib, act_scales=want,
                                        device="cpu")
    jplan, jl = J.bias_corrected_layers(cfg, params, stats, calib,
                                        act_scales=want)
    assert tplan == tuple(jplan)
    got_b = np.concatenate([t["bias"].numpy() for t in tl if "bias" in t])
    want_b = np.concatenate([np.asarray(w["bias"]) for w in jl if "bias" in w])
    top = np.abs(want_b).max()
    assert np.abs(got_b - want_b).max() <= bias_tol * top
    assert np.abs(got_b - want_b).mean() <= 1e-3 * top
    for t, w in zip(tl, jl):
        if "b" in w:  # the float32 final convs: untouched
            np.testing.assert_array_equal(t["b"].numpy(), np.asarray(w["b"]))
        if "a_scale" in w:
            np.testing.assert_allclose(float(t["a_scale"]),
                                       float(w["a_scale"]), rtol=1e-5)


def test_int8_model_options_and_guards():
    cfg = PLANS["conv"]()
    params, stats = variables(cfg, 9)
    tcfg, sd = port(cfg, params, stats)
    calib = images(10, 4)
    static = T.Int8InferenceModel(tcfg, sd, calib_images=calib, device="cpu")
    assert sum("a_scale" in layer for layer in static.layers) == sum(
        "w_q" in layer for layer in static.layers)
    corrected = T.Int8InferenceModel(tcfg, sd, calib_images=calib,
                                     bias_correct=True, act_quant="dynamic",
                                     device="cpu")
    assert not any("a_scale" in layer for layer in corrected.layers)
    for kwargs, match in [(dict(bias_correct=True), "calib_images"),
                          (dict(act_quant="static"), "calib_images"),
                          (dict(act_quant="bogus"), "act_quant"),
                          (dict(calib_images=calib, qat_steps=1,
                                bias_correct=True), "exclusive")]:
        with pytest.raises(ValueError, match=match):
            T.Int8InferenceModel(tcfg, sd, device="cpu", **kwargs)
    # a mesh with a model axis serves as JAX's shard_map does: the model
    # axis replicates the data axis's rows, served once a data row
    # (tests/test_torch_tensor_parallel.py holds it against JAX's)
    from keras_object_detection_torch.parallel import Mesh
    meshed = T.Int8InferenceModel(tcfg, sd, device="cpu",
                                  mesh=Mesh(1, 2, (torch.device("cpu"),) * 2))
    assert len(meshed._replicas) == 1
    assert torch.equal(meshed.predict_raw(calib), T.Int8InferenceModel(
        tcfg, sd, device="cpu").predict_raw(calib))
    for head in ("gap_dense", "flatten_dense"):
        dense = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, head=head))
        with pytest.raises(ValueError, match="head='conv'"):
            T.build_int8_layers(dense, sd, device="cpu")


def test_select_serving_model_modes():
    cfg = PLANS["conv"]()
    params, stats = variables(cfg, 12)
    tcfg, sd = port(cfg, params, stats)
    m, info = T.select_serving_model(tcfg, sd, "float", device="cpu")
    assert type(m) is InferenceModel and info == {"mode": "float"}
    m, info = T.select_serving_model(tcfg, sd, "int8", device="cpu")
    assert isinstance(m, T.Int8InferenceModel) and info == {"mode": "int8"}
    m, info = T.select_serving_model(tcfg, sd, "auto", probe_runs=2,
                                     device="cpu")
    assert set(info) == {"mode", "probe_batch", "float_p50_ms", "int8_p50_ms",
                         "chosen"}
    assert info["chosen"] == ("int8" if info["int8_p50_ms"]
                              <= info["float_p50_ms"] else "float")
    assert isinstance(m, T.Int8InferenceModel if info["chosen"] == "int8"
                      else InferenceModel)
    assert m.predict_single(images(13)[0]).shape[1] == 6
    with pytest.raises(ValueError, match="float|int8|auto"):
        T.select_serving_model(tcfg, sd, "bogus", device="cpu")


# --- weight-only int8 -------------------------------------------------------


def test_quantize_params_and_weight_only_model_match_jax():
    """``quantize_params``: JAX's ``q`` and ``scale`` trees, carried into
    the port's layout by ``flax_to_torch`` (HWIO -> OIHW, Dense transposed;
    a ``(1, 1, 1, cout)`` scale becomes ``(cout, 1, 1, 1)``), equal the
    port's; the same tensors stay float32; the sizes equal; and
    ``QuantizedInferenceModel.predict`` matches JAX's (mask exact, rows to
    1e-4)."""
    cfg = PLANS["conv"]()
    params, stats = variables(cfg, 14)
    tcfg, sd = port(cfg, params, stats)
    jq = JQ.quantize_params(params)
    leaf = lambda x: isinstance(x, dict) and ("q" in x or "f32" in x)  # noqa
    pick = lambda key: jax.tree_util.tree_map(  # noqa: E731
        lambda d: np.asarray(d.get(key, d.get("f32")), np.float32), jq,
        is_leaf=leaf)
    want_q, want_scale = (flax_to_torch(pick(k), stats) for k in ("q", "scale"))
    names = {n for n, _ in build_model(tcfg).named_parameters()}
    tq = TQ.quantize_params({k: v for k, v in sd.items() if k in names})
    quantized = {n for n, l in tq.items() if "q" in l}
    assert quantized and quantized < names
    for n, l in tq.items():
        if "q" in l:
            np.testing.assert_array_equal(l["q"].float().numpy(),
                                          want_q[n].numpy(), err_msg=n)
            np.testing.assert_array_equal(l["scale"].numpy(),
                                          want_scale[n].numpy(), err_msg=n)
        else:
            np.testing.assert_array_equal(l["f32"].numpy(), want_q[n].numpy())
    jleaves = jax.tree_util.tree_leaves(jq, is_leaf=leaf)
    assert len(quantized) == sum("q" in d for d in jleaves)
    assert TQ.quantized_size_bytes(tq) == JQ.quantized_size_bytes(jq)

    jm = JQ.QuantizedInferenceModel(cfg, params, stats)
    tm = TQ.QuantizedInferenceModel(tcfg, sd, device="cpu")
    x = images(15, 3)
    want_rows, want_valid = jm.predict(x)
    got_rows, got_valid = tm.predict(x)
    np.testing.assert_array_equal(got_valid.numpy(), want_valid)
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=1e-4,
                               atol=1e-4)
    assert tm.memory_footprint() == dict(zip(
        ("quantized_bytes", "float_bytes"), JQ.quantized_size_bytes(jq)))
