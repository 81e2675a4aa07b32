"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels (NMS,
the fused loss forward and backward, the BN statistics forward and backward)
have no CPU mode. They skip without a card. This file imports neither JAX
nor the JAX package, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from keras_object_detection_torch.config import tiny_cpu_config
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import build_model
import dataclasses

from keras_object_detection_torch.ops import bn, cuda_nms, yolo_loss
from keras_object_detection_torch.ops.nms import batched_non_max_suppression
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


def rows(seed, b, n, num_classes=3, conf=None):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0.1, 0.9, size=(8, 2))
    cls = rng.randint(0, num_classes, size=(b, n))
    c = rng.uniform(0, 1, size=(b, n)) if conf is None else np.full((b, n), conf)
    xy = centres[rng.randint(0, 8, size=(b, n))] + rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.05, 0.35, size=(b, n, 2))
    return np.concatenate([cls[..., None], c[..., None], xy, wh],
                          axis=-1).astype(np.float32)


CASES = {
    "1x49": lambda: rows(0, 1, 49),
    "32x49": lambda: rows(1, 32, 49, num_classes=20),
    "32x98": lambda: rows(2, 32, 98, num_classes=20),
    "4x196": lambda: rows(3, 4, 196),
    "8x512": lambda: rows(4, 8, 512, num_classes=5),
    "2x1024": lambda: rows(5, 2, 1024),
    "tied": lambda: rows(6, 4, 49, conf=0.9),
    "below": lambda: rows(7, 4, 98, conf=0.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_bit_equal_to_plain_version(cuda, case):
    x = torch.from_numpy(CASES[case]()).to(cuda)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = cuda_nms.cuda_batched_non_max_suppression(x)
    want_rows, want_valid = batched_non_max_suppression(x)
    assert cuda_nms.LAUNCHES == before + 1
    assert torch.equal(got_valid, want_valid)
    assert torch.equal(got_rows, want_rows)


@pytest.mark.parametrize("bad,match", [
    (lambda x: torch.zeros((1, cuda_nms.MAX_N + 1, 6), device=x.device), "cap"),
    (lambda x: x.double(), "float32"),
    (lambda x: x.transpose(0, 1), "contiguous"),
    (lambda x: x[..., :5].contiguous(), r"\(B, N, 6\)"),
])
def test_kernel_rejects_what_it_does_not_take(cuda, bad, match):
    x = torch.from_numpy(rows(8, 2, 49)).to(cuda)
    with pytest.raises(ValueError, match=match):
        cuda_nms.cuda_batched_non_max_suppression(bad(x))


def test_serving_on_the_gpu_goes_through_the_kernel(cuda):
    cfg = tiny_cpu_config()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = InferenceModel(cfg, sd)
    assert model.device.type == "cuda"
    images = np.random.RandomState(9).randint(0, 256, (4, 224, 224, 3), np.uint8)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = model.predict(images)
    assert cuda_nms.LAUNCHES == before + 1
    want_rows, want_valid = batched_non_max_suppression(
        model.predict_decoded(images))
    assert torch.equal(got_valid, want_valid)
    assert torch.equal(got_rows, want_rows)


def loss_rows(seed, n, c=20, b=2):
    rng = np.random.RandomState(seed)
    d = c + 5 * b
    t = np.zeros((n, d), np.float32)
    obj = rng.uniform(size=n) < 0.3
    t[np.arange(n), rng.randint(c, size=n)] = obj
    t[:, c] = obj
    t[:, c + 1:c + 5] = rng.uniform([0, 0, 0.02, 0.02], [1, 1, 0.6, 0.6],
                                    (n, 4)) * obj[:, None]
    p = rng.uniform(-0.3, 1.0, (n, d)).astype(np.float32)
    return t, p


@pytest.mark.parametrize("n,c,b", [(64 * 49, 20, 2), (2 * 49, 5, 3), (1, 3, 2)])
@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
def test_loss_kernels_match_plain_versions(cuda, n, c, b, noobj_mode):
    t, p = (torch.from_numpy(x).to(cuda) for x in loss_rows(n, n, c, b))
    g = torch.tensor(0.75, device=cuda)
    before = (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES)
    got = yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b, noobj_mode=noobj_mode)
    dp = yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b,
                                              noobj_mode=noobj_mode)
    assert (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = yolo_loss.yolo_v1_loss_forward_plain(t, p, c, b,
                                                noobj_mode=noobj_mode)
    want_dp = yolo_loss.yolo_v1_loss_backward_plain(t, p, g, c, b,
                                                    noobj_mode=noobj_mode)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the same operations in the same order, no FMA contraction
    torch.testing.assert_close(dp, want_dp, rtol=1e-6, atol=1e-7)


def test_fused_loss_on_the_gpu_goes_through_the_kernels(cuda):
    t, p = (torch.from_numpy(x).to(cuda).reshape(2, 7, 7, 30)
            for x in loss_rows(9, 98))
    p.requires_grad_(True)
    before = (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES)
    yolo_loss.fused_yolo_v1_loss(t, p, 20).backward()
    assert (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    cpu = p.detach().cpu().requires_grad_(True)
    yolo_loss.fused_yolo_v1_loss(t.cpu(), cpu, 20).backward()
    torch.testing.assert_close(p.grad.cpu(), cpu.grad, rtol=1e-5, atol=1e-6)


BN_SHAPES = [(64, 64, 56, 56), (8, 192, 28, 28), (3, 24, 7, 7), (5, 32, 13, 11),
             (2, 1024, 7, 7), (7, 20, 5, 3)]


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_kernels_match_plain_versions(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = dy.contiguous(memory_format=torch.channels_last)
    before = (bn.STATS_LAUNCHES, bn.GRAD_STATS_LAUNCHES)
    m = x.numel() // shape[1]
    got = bn.cuda_bn_stats_sums(x)
    mean = got[0] / m
    rstd = torch.rsqrt(torch.clamp_min(got[1] / m - mean * mean, 0.0) + 1e-3)
    got_g = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
    assert (bn.STATS_LAUNCHES, bn.GRAD_STATS_LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
    want = bn.bn_stats_sums_plain(x)
    want_g = bn.bn_grad_sums_plain(dy, x, mean, rstd)
    scale = want.abs().amax(dim=1, keepdim=True) + 1
    torch.testing.assert_close(got / scale, want / scale, rtol=1e-5, atol=1e-5)
    scale = want_g.abs().amax(dim=1, keepdim=True) + 1
    torch.testing.assert_close(got_g / scale, want_g / scale, rtol=1e-5,
                               atol=1e-5)
    again = bn.cuda_bn_stats_sums(x)
    assert torch.equal(again, got)  # a fixed summation order


def test_bn_kernels_reject_other_layouts(cuda):
    x = torch.randn(2, 16, 5, 5, device=cuda)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        bn.cuda_bn_stats_sums(x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bn.cuda_bn_stats_sums(x.half().contiguous(
            memory_format=torch.channels_last))


def _micro_config():
    """darknet_micro @56 (4 backbone ConvBlocks + the head's: 5 launches of
    each BN kernel and one of each loss kernel per step), both kernel
    switches on, SGD (an update linear in the gradient). darknet_micro is
    well conditioned where darknet_tiny @224 at a random init is not (see
    chip_smoke.tiny_train_config)."""
    cfg = tiny_cpu_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone="darknet_micro",
                                       image_size=56, bn_mode="fused"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=True,
                                  optimizer="sgd"))


def _micro_batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (4, 56, 56, 3), np.uint8)
    boxes = np.zeros((4, 8, 5), np.float32)
    boxes[:, :3] = [[0.5, 0.5, 0.3, 0.3, 1], [0.2, 0.3, 0.2, 0.3, 2],
                    [0.8, 0.7, 0.25, 0.2, 0]]
    valid = np.zeros((4, 8), bool)
    valid[:, :3] = True
    return images, boxes, valid


@pytest.fixture
def no_tf32():
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _counts():
    return (bn.STATS_LAUNCHES, bn.GRAD_STATS_LAUNCHES,
            yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES)


def test_train_step_on_the_gpu_goes_through_the_kernels(cuda, no_tf32):
    """The whole step on the GPU agrees with the same step on the CPU
    (float32, TF32 off) from the same weights and draws. The augmentation
    differs by up to ~1e-5 between the devices (the crop windows' exp and
    sqrt round differently), which can flip a max-pool near-tie and move
    a window's gradient to its neighbour; at this seed none flips.
    test_train_gradients_match_the_cpu_on_identical_inputs checks the
    gradients over several seeds from identical inputs."""
    cfg = _micro_config()
    images, boxes, valid = _micro_batch(3)
    gpu = create_train_state(cfg, torch.Generator().manual_seed(0))
    cpu = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg)
    before = _counts()
    gpu, m_gpu = step(gpu, images, boxes, valid, 5)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [5, 5, 1, 1]
    cpu, m_cpu = step(cpu, images, boxes, valid, 5)
    torch.testing.assert_close(m_gpu["total"].cpu(), m_cpu["total"], rtol=1e-4,
                               atol=1e-4)
    for (k, a), b in zip(gpu.model.state_dict().items(),
                         cpu.model.state_dict().values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4, msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_whole_train_step_loss_and_stats_match_the_cpu(cuda, no_tf32, seed):
    """Loss and BN running statistics, continuous in the augmented
    inputs, agree to 1e-4 after the whole step at every seed."""
    cfg = _micro_config()
    images, boxes, valid = _micro_batch(10 + seed)
    step = make_train_step(cfg)
    gpu, m_gpu = step(create_train_state(cfg, torch.Generator().manual_seed(seed)),
                      images, boxes, valid, seed)
    cpu, m_cpu = step(create_train_state(cfg, torch.Generator().manual_seed(seed),
                                         "cpu"), images, boxes, valid, seed)
    torch.testing.assert_close(m_gpu["total"].cpu(), m_cpu["total"], rtol=1e-4,
                               atol=0)
    want = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4, atol=1e-4,
                                       msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_gradients_match_the_cpu_on_identical_inputs(cuda, no_tf32, seed):
    """From the same augmented images and grid, the GPU's forward (K2),
    loss (K4), backward (K5, K3) and running statistics agree with the
    CPU's plain versions: loss, y_pred and every parameter's gradient in
    norm to 1e-4 (conv biases, zero up to rounding under a training-mode
    BatchNorm, left out). The GPU follows the CPU's ReLU and max-pool
    routing (chip_smoke.routing): at a near-tie the two devices' rounding
    may pick different elements, which moves a gradient to a neighbour."""
    from chip_smoke import routing
    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data.augment import (augment_batch,
                                                           sample_augment_draws)
    cfg = _micro_config()
    g, d, t = cfg.grid, cfg.data, cfg.train
    images, boxes, valid = (torch.from_numpy(x) for x in _micro_batch(20 + seed))
    draws = sample_augment_draws(4, torch.Generator().manual_seed(seed),
                                 tuple(d.color_jitter), tuple(d.crop_scale),
                                 tuple(d.crop_ratio))
    x, aboxes, avalid = augment_batch(
        images, boxes, valid, draws, hflip_prob=d.hflip_prob,
        color_strengths=tuple(d.color_jitter), crop_ratio=tuple(d.crop_ratio),
        min_visibility=d.min_visibility, out_size=56)
    y_true = encode_grid(aboxes, avalid, g.num_classes, g.num_boxes, g.grid)
    out, route = {}, []
    for dev in ("cpu", cuda):
        state = create_train_state(cfg, torch.Generator().manual_seed(seed), dev)
        before = _counts()
        with routing(route, replay=dev != "cpu"):
            y_pred = state.model(x.to(dev))
        loss = yolo_loss.fused_yolo_v1_loss(y_true.to(dev), y_pred, g.num_classes,
                                            g.num_boxes, t.lambda_coord,
                                            t.lambda_noobj, t.noobj_mode)
        loss.backward()
        launched = [a - b for a, b in zip(_counts(), before)]
        out[str(dev)] = (loss.detach().cpu(), y_pred.detach().cpu(),
                         {k: p.grad.cpu() for k, p in
                          state.model.named_parameters()},
                         {k: v.cpu() for k, v in state.model.state_dict().items()
                          if "running" in k}, launched)
    (c_loss, c_pred, c_grad, c_stats, c_n), (g_loss, g_pred, g_grad, g_stats,
                                            g_n) = out["cpu"], out[str(cuda)]
    assert c_n == [0, 0, 0, 0] and g_n == [5, 5, 1, 1]
    torch.testing.assert_close(g_loss, c_loss, rtol=1e-4, atol=0)
    assert ((g_pred - c_pred).abs().max() / c_pred.abs().max()).item() <= 1e-4
    for k, want in c_grad.items():
        if k.endswith("conv.bias"):
            continue
        err = (torch.linalg.vector_norm(g_grad[k] - want)
               / torch.linalg.vector_norm(want)).item()
        assert err <= 1e-4, (k, err)
    for k, want in c_stats.items():
        torch.testing.assert_close(g_stats[k], want, rtol=1e-4, atol=1e-4, msg=k)
