"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels (NMS,
the fused loss forward and backward, the BN statistics forward and backward,
at the flagship's, the transfer family's and the multiscale shapes, and the
multi-tensor optimizer update at the flagship's and YOLOv3's parameter
lists) have no
CPU mode, and the paths that run them (serving, the train step, the
frozen-backbone and GAP-head steps, the recipe step with remat, the mAP
accumulator, ``Trainer.fit``, the pinned-memory prefetch), and the YOLOv2
anchor family's card-side cases (K2/K3 at its 21 BatchNorm shapes, K1
behind the top-k cut, the v2 loss on the card, a passthrough step), and the
int8 route (``ops/int8_conv.py``), int8 serving and soft / fast NMS on the
card, and data parallelism on the card (mesh serving over ``[cuda:0,
cuda:0]``, a one-rank NCCL step). They skip
without a card. This file imports neither JAX nor the JAX package, so on a
machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import NMS_CASES, NMS_TIMED
from keras_object_detection_torch.config import tiny_cpu_config
from keras_object_detection_torch.eval import InferenceModel
from keras_object_detection_torch.models import build_model
from keras_object_detection_torch.ops import bn, cuda_nms, optim_update, yolo_loss
from keras_object_detection_torch.ops.nms import batched_non_max_suppression
from keras_object_detection_torch.train import (create_train_state,
                                                make_train_step)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_kernel_bit_equal_to_plain_version(cuda, case):
    """chip_smoke.NMS_CASES: the serving shapes, N = 63 ... 1024 around each
    cluster-size step, batch 64, one class, identical boxes, confidence ties
    with 0.0 against -0.0, pairs whose IoU is exactly the threshold or one
    ulp off at 0.3, 0.5 and 0.7, both densities. The kernel equals the
    plain version on the same CUDA input and on the CPU."""
    rows, iou, conf = NMS_CASES[case]()
    x = torch.from_numpy(rows).to(cuda)
    before = cuda_nms.LAUNCHES
    got_rows, got_valid = cuda_nms.cuda_batched_non_max_suppression(x, iou, conf)
    assert cuda_nms.LAUNCHES == before + 1
    for where in (x, x.cpu()):
        want_rows, want_valid = batched_non_max_suppression(where, iou, conf)
        assert torch.equal(got_valid.cpu(), want_valid.cpu())
        assert torch.equal(got_rows.cpu(), want_rows.cpu())


@pytest.mark.parametrize("bad,match", [
    (lambda x: torch.zeros((1, cuda_nms.MAX_N + 1, 6), device=x.device), "cap"),
    (lambda x: x.double(), "float32"),
    (lambda x: x.transpose(0, 1), "contiguous"),
    (lambda x: x[..., :5].contiguous(), r"\(B, N, 6\)"),
])
def test_kernel_rejects_what_it_does_not_take(cuda, bad, match):
    x = torch.from_numpy(NMS_TIMED["32x49"]()[:2]).to(cuda)
    with pytest.raises(ValueError, match=match):
        cuda_nms.cuda_batched_non_max_suppression(bad(x))


@pytest.mark.parametrize("case", ["1x49", "32x49", "8x512", "2x1024"])
def test_kernel_replays_in_a_cuda_graph(cuda, case):
    from chip_smoke import nms_graph_replays

    x = torch.from_numpy(NMS_TIMED[case]()).to(cuda)
    assert nms_graph_replays(cuda_nms, x)


@pytest.mark.parametrize("n,cluster", [(1, 1), (49, 1), (64, 1), (65, 2),
                                       (196, 4), (512, 8), (1024, 8)])
def test_kernel_is_one_cuda_launch_of_a_cluster_per_image(cuda, n, cluster):
    from chip_smoke import cuda_launches, nms_rows

    shape = cuda_nms.kernel_shape(n)
    assert shape["cluster"] == cluster
    assert shape["threads"] >= n and shape["smem_bytes"] <= 227 * 1024
    x = torch.from_numpy(nms_rows(3, 2, n)).to(cuda)
    assert len(cuda_launches(
        lambda: cuda_nms.cuda_batched_non_max_suppression(x))) == 1


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


def test_mesh_serving_on_the_gpu_runs_the_kernel_once_a_shard(cuda):
    """A device mesh of two replicas on one card serves each half of the
    batch as one device serves it, through K1 once a shard."""
    from keras_object_detection_torch.parallel import create_mesh

    cfg = tiny_cpu_config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, conf_threshold=0.0))
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    one = InferenceModel(cfg, sd)
    meshed = InferenceModel(cfg, sd, mesh=create_mesh(
        devices=[one.device, one.device]))
    images = np.random.RandomState(9).randint(0, 256, (4, 224, 224, 3), np.uint8)
    want = [one.predict(images[i:i + 2]) for i in (0, 2)]
    before = cuda_nms.LAUNCHES
    rows, valid = meshed.predict(images)
    assert cuda_nms.LAUNCHES == before + 2
    assert torch.equal(rows, torch.cat([r for r, _ in want]))
    assert torch.equal(valid, torch.cat([v for _, v in want]))


def test_one_rank_nccl_step_is_the_one_device_step(cuda):
    """The data-parallel step over a one-rank NCCL group adds no collective
    and gives the one-device step's bits (deterministic cuDNN)."""
    import torch.distributed as dist

    from chip_smoke import deterministic_cudnn, tiny_train_config
    from keras_object_detection_torch.parallel import distributed

    cfg = tiny_train_config()
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (4, 56, 56, 3)).astype(np.uint8)
    boxes = np.tile(np.array([0.5, 0.5, 0.3, 0.3, 1.0], np.float32), (4, 2, 1))
    valid = np.ones((4, 2), bool)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{distributed.free_port()}", rank=0, world_size=1)
    try:
        out = []
        for group in (None, dist.group.WORLD):
            state = create_train_state(cfg, torch.Generator().manual_seed(0))
            distributed.reset_counts()
            with deterministic_cudnn():
                state, m = make_train_step(cfg, group=group)(
                    state, images, boxes, valid, 3)
            out.append((m["total"], state.model.state_dict()))
        assert distributed.ALL_REDUCES == distributed.GATHERS == 0
    finally:
        dist.destroy_process_group()
    assert torch.equal(out[0][0], out[1][0])
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def _loss_tensors(kind, n, device):
    from chip_smoke import loss_case

    t, p, c, b = loss_case(kind, n)
    return torch.from_numpy(t).to(device), torch.from_numpy(p).to(device), c, b


LOSS_SIZES = [1, 97, 3135, 3136, 3137, 12544]
LOSS_KINDS = ["C20 B2", "C5 B3", "ties C3 B2"]


@pytest.mark.parametrize("n", LOSS_SIZES)
@pytest.mark.parametrize("kind", LOSS_KINDS)
@pytest.mark.parametrize("noobj_mode", ["selected", "all"])
def test_loss_kernels_match_plain_versions(cuda, kind, n, noobj_mode):
    """K4 within 1e-6 relative of its plain sums and the same bits on a
    second call; K5 bit-equal to its plain version (the same operations in
    the same order, no FMA contraction). Sizes around the flagship's 3,136
    rows and batch 256's 12,544, and rows that are not a multiple of the
    kernels' 16-row chunks."""
    t, p, c, b = _loss_tensors(kind, n, cuda)
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
    assert ((got - want).abs() <= 1e-6 * want.abs()).all(), (got, want)
    assert torch.equal(dp, want_dp)
    again = yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b, noobj_mode=noobj_mode)
    assert torch.equal(again, got)  # a fixed summation order


def test_loss_kernels_fill_the_card_in_one_launch_each(cuda):
    """At the flagship's 3,136 rows each kernel runs at least one block per
    SM of the H100 (132), and a call is one CUDA launch."""
    from chip_smoke import cuda_launches

    t, p, c, b = _loss_tensors("C20 B2", 3136, cuda)
    g = torch.tensor(1.0, device=cuda)
    assert yolo_loss.kernel_blocks(3136, backward=False) >= 132
    assert yolo_loss.kernel_blocks(3136, backward=True) >= 132
    assert len(cuda_launches(
        lambda: yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b))) == 1
    assert len(cuda_launches(
        lambda: yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b))) == 1


def test_a_captured_graph_counts_one_kernel_a_call(cuda):
    """cuda_launches' count without the profiler (the kernel nodes of a
    captured CUDA graph) reads two for two torch ops and one for a call of
    K1, K4 or K5."""
    from chip_smoke import graph_kernel_launches, nms_rows

    x = torch.from_numpy(nms_rows(3, 2, 512)).to(cuda)
    t, p, c, b = _loss_tensors("C20 B2", 3136, cuda)
    g = torch.tensor(1.0, device=cuda)
    assert graph_kernel_launches(lambda: (x + 1.0) * 2.0) == 2
    for fn in (lambda: cuda_nms.cuda_batched_non_max_suppression(x),
               lambda: yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b),
               lambda: yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b)):
        assert graph_kernel_launches(fn) == 1


@pytest.mark.parametrize("n", [97, 3137])
def test_loss_kernels_take_unaligned_rows(cuda, n):
    """Rows whose data pointer is not 16-byte aligned go through the
    kernels' one-float-a-lane copy and give the same bits."""
    from chip_smoke import offset_view

    t, p, c, b = _loss_tensors("ties C3 B2", n, cuda)
    g = torch.tensor(0.5, device=cuda)
    ts, ps = offset_view(t), offset_view(p)
    assert ts.data_ptr() % 16 and ps.data_ptr() % 16
    assert torch.equal(yolo_loss.cuda_yolo_v1_loss_forward(ts, ps, c, b),
                       yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b))
    assert torch.equal(yolo_loss.cuda_yolo_v1_loss_backward(ts, ps, g, c, b),
                       yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b))


@pytest.mark.parametrize("n", [1, 3136, 12544])
def test_loss_kernels_replay_in_a_cuda_graph(cuda, n):
    from chip_smoke import loss_graph_replays

    t, p, c, b = _loss_tensors("C20 B2", n, cuda)
    g = torch.tensor(0.75, device=cuda)
    assert loss_graph_replays(yolo_loss, t, p, g, c, b)


def _wide(device):
    """C = 2000, B = 2: 16 rows of it need more shared memory than a block
    of the H100 gets."""
    t = torch.zeros(5, 2010, device=device)
    return t, t.clone(), 2000, 2


@pytest.mark.parametrize("bad,match", [
    (lambda t, p, c, b: (t.double(), p.double(), c, b), "float32"),
    (lambda t, p, c, b: (t.t().contiguous().t(), p, c, b), "contiguous"),
    (lambda t, p, c, b: (t[:, :-1].contiguous(), p[:, :-1].contiguous(), c, b),
     r"\(N, C \+ 5B\)"),
    (lambda t, p, c, b: (t.cpu(), p.cpu(), c, b), "CUDA"),
    (lambda t, p, c, b: (t[:, :20].repeat(1, 3), p[:, :20].repeat(1, 3), 15, 9),
     "B <= 8"),
    (lambda t, p, c, b: _wide(t.device), "too wide"),
])
def test_loss_kernels_reject_what_they_do_not_take(cuda, bad, match):
    t, p, c, b = _loss_tensors("C20 B2", 97, cuda)
    t, p, c, b = bad(t, p, c, b)
    g = torch.tensor(1.0, device=t.device)
    with pytest.raises(ValueError, match=match):
        yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b)
    with pytest.raises(ValueError, match=match):
        yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b)


def test_fused_loss_on_the_gpu_goes_through_the_kernels(cuda):
    from chip_smoke import loss_rows

    t, p = (torch.from_numpy(x).to(cuda).reshape(2, 7, 7, 30)
            for x in loss_rows(9, 98, 20, 2))
    p.requires_grad_(True)
    before = (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES)
    yolo_loss.fused_yolo_v1_loss(t, p, 20).backward()
    assert (yolo_loss.FORWARD_LAUNCHES, yolo_loss.BACKWARD_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    cpu = p.detach().cpu().requires_grad_(True)
    yolo_loss.fused_yolo_v1_loss(t.cpu(), cpu, 20).backward()
    torch.testing.assert_close(p.grad.cpu(), cpu.grad, rtol=1e-5, atol=1e-6)


BN_SHAPES = [(64, 64, 56, 56), (8, 192, 28, 28), (3, 24, 7, 7), (5, 32, 13, 11),
             (2, 1024, 7, 7), (7, 20, 5, 3), (64, 1024, 7, 7),
             (64, 1280, 14, 14), (64, 4960)]


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_kernels_match_plain_versions(cuda, shape, dtype):
    """Within 1e-5 of the plain sums, one launch counted a call, and the
    same bits from call to call (a fixed summation order)."""
    from chip_smoke import kernel_layout_tensor

    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    x = kernel_layout_tensor(x)
    dy = kernel_layout_tensor(dy)
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
    assert torch.equal(bn.cuda_bn_stats_sums(x), got)
    assert torch.equal(bn.cuda_bn_grad_sums(dy, x, mean, rstd), got_g)


def _bn_inputs(shape, device, seed=4):
    from chip_smoke import bn_inputs

    gen = torch.Generator(device=device).manual_seed(seed)
    return bn_inputs(shape, torch.bfloat16, gen, device)


@pytest.mark.parametrize("shape", [(64, 1024, 7, 7), (64, 1280, 14, 14),
                                   (64, 4960), (64, 64, 28, 28), (5, 7)])
def test_bn_kernels_replay_in_a_cuda_graph(cuda, shape):
    """Three K2 and K3 calls in one CUDA graph give the eager bits on each
    of two replays: every tile's ticket counter is back at 0 after a
    launch."""
    from chip_smoke import bn_graph_replays

    assert bn_graph_replays(bn, *_bn_inputs(shape, cuda))


@pytest.mark.parametrize("shape", [(64, 1024, 7, 7), (64, 4960), (5, 32, 13, 11),
                                   (64, 16, 56, 56)])
def test_bn_kernels_take_unaligned_views(cuda, shape):
    """Inputs whose data pointer is not 16-byte aligned (an offset view in
    the kernels' layout) take the one-channel-a-load path: within 1e-5 of
    the plain sums, the same bits from call to call."""
    from chip_smoke import bn_offset_view, bn_rel_err

    x, dy, mean, rstd = _bn_inputs(shape, cuda)
    xs, dys = bn_offset_view(x), bn_offset_view(dy)
    assert xs.data_ptr() % 16 and dys.data_ptr() % 16
    assert bn.kernel_layout(xs) and bn.kernel_layout(dys)
    got = bn.cuda_bn_stats_sums(xs)
    got_g = bn.cuda_bn_grad_sums(dys, xs, mean, rstd)
    assert bn_rel_err(got, bn.bn_stats_sums_plain(x)) <= 1e-5
    assert bn_rel_err(got_g, bn.bn_grad_sums_plain(dy, x, mean, rstd)) <= 1e-5
    assert torch.equal(bn.cuda_bn_stats_sums(xs), got)
    assert torch.equal(bn.cuda_bn_grad_sums(dys, xs, mean, rstd), got_g)


@pytest.mark.parametrize("shape", [(64, 1024, 7, 7), (64, 4960)])
def test_bn_kernels_are_one_cuda_launch_each(cuda, shape):
    """K2 and K3 are one CUDA launch a call, where the row blocks meet at a
    ticket (7x7x1024) and where one block covers all rows (64, 4960)."""
    from chip_smoke import cuda_launches

    x, dy, mean, rstd = _bn_inputs(shape, cuda)
    assert len(cuda_launches(lambda: bn.cuda_bn_stats_sums(x))) == 1
    assert len(cuda_launches(lambda: bn.cuda_bn_grad_sums(dy, x, mean, rstd))) == 1


# the v1 transfer family's shapes at batch 64, 448²: the GAP dense head's
# 2-D BatchNorm (4960 units; 4096 without BN is no BN), odd 2-D widths, and
# MobileNetV2's largest, widest and depthwise inputs
TRANSFER_BN_SHAPES = [(64, 4960), (3, 4960), (5, 7), (64, 96, 224, 224),
                      (64, 16, 224, 224), (64, 144, 112, 112),
                      (64, 960, 14, 14), (64, 1280, 14, 14)]


@pytest.mark.parametrize("shape", TRANSFER_BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_kernels_match_plain_versions_at_transfer_shapes(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(2)
    x = (torch.randn(shape, generator=gen) * 2 + 0.5).to(cuda, dtype)
    dy = torch.randn(shape, generator=gen).to(cuda, dtype)
    if x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    m = x.numel() // shape[1]
    before = (bn.STATS_LAUNCHES, bn.GRAD_STATS_LAUNCHES)
    got = bn.cuda_bn_stats_sums(x)
    mean = got[0] / m
    rstd = torch.rsqrt(torch.clamp_min(got[1] / m - mean * mean, 0.0) + 1e-3)
    got_g = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
    assert (bn.STATS_LAUNCHES, bn.GRAD_STATS_LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
    for a, w in ((got, bn.bn_stats_sums_plain(x)),
                 (got_g, bn.bn_grad_sums_plain(dy, x, mean, rstd))):
        scale = w.abs().amax(dim=1, keepdim=True) + 1
        torch.testing.assert_close(a / scale, w / scale, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 24, 9, 7), (6, 96)])
def test_fused_bn_copies_a_dy_outside_the_kernel_layout(cuda, shape):
    """A dy in another layout than the kernels' (an NCHW-contiguous one, as
    a depthwise conv's backward may hand it over; a transposed 2-D view) is
    copied to their layout, counted, and gives the same gradients."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=gen).to(cuda)
    if x.dim() == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(shape, generator=gen).to(cuda)
    if w.dim() == 4:
        w = w.contiguous(memory_format=torch.channels_last)
    other = w.contiguous() if w.dim() == 4 else w.t().contiguous().t()
    grads = []
    for dy_like in (x.new_empty(0), other):
        xx = x.clone().requires_grad_(True)
        scale = torch.ones(shape[1], device=cuda, requires_grad=True)
        y, _, _ = bn.fused_bn_train(xx, scale, torch.zeros(shape[1], device=cuda),
                                    1e-3)
        copies = bn.DY_LAYOUT_COPIES
        dy = w if dy_like.numel() == 0 else dy_like
        assert bn.kernel_layout(dy) == (dy_like.numel() == 0)
        y.backward(dy)
        assert bn.DY_LAYOUT_COPIES == copies + (dy_like.numel() != 0)
        grads.append((xx.grad, scale.grad))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=0, atol=0)


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


@pytest.fixture(scope="module")
def optim_lists():
    """The flagship's and YOLOv3's parameter shapes and sizes
    (chip_smoke.optim_shapes), built once."""
    import math

    from chip_smoke import OPTIM_MODELS, optim_shapes

    shapes = {tag: optim_shapes(tag) for tag in OPTIM_MODELS}
    return {tag: (sh, tuple(math.prod(s) for s in sh))
            for tag, sh in shapes.items()}


@pytest.mark.parametrize("tag", ["flagship", "yolov3"])
@pytest.mark.parametrize("name", ["adam", "nadam", "adamw", "sgd", "sgdw"])
def test_optim_kernel_bit_equal_to_plain_loop(cuda, optim_lists, name, tag):
    """K6 against the plain loop on the card: 5 steps at the model's
    parameter list (channels_last weights, random float32 gradients from
    numpy at scales 1e-4 to 30), the learning rate swapped after step 2;
    parameters and moments torch.equal, and K6's launches a step
    optim_launch_plan's count."""
    from chip_smoke import optim_compare, optim_grads, optim_params

    shapes, sizes = optim_lists[tag]
    params = optim_params(shapes, cuda, 11)
    res = optim_compare(name, params, optim_grads(params, 12, 5))
    assert res["bit_equal"]
    assert res["launches_per_step"] == len(optim_update.optim_launch_plan(sizes))


def test_optim_kernel_scalar_path_bit_equal(cuda):
    """Tensors one float off a 16-byte boundary take the scalar path, with
    lengths that leave tails: still the loop's bits."""
    from chip_smoke import optim_compare, optim_grads, optim_params

    shapes = [(3,), (17, 5), (8, 3, 3, 3), (8193,), (1,)]
    params = optim_params(shapes, cuda, 13, offset=True)
    for name in optim_update.OPT_CODES:
        assert optim_compare(name, params, optim_grads(params, 14, 3))["bit_equal"]


def _optim_args(dev, **bad):
    p = torch.randn(8, 4, 3, 3, device=dev).to(memory_format=torch.channels_last)
    args = {"params": [p], "grads": [torch.randn_like(p)],
            "mu": [torch.zeros_like(p)], "nu": [torch.zeros_like(p)]}
    for key, fn in bad.items():
        args[key] = [fn(args[key][0])]
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(params=lambda p: p.bfloat16(), grads=lambda g: g.bfloat16()),
     "float32"),
    (dict(params=lambda p: torch.randn(8, 4, 3, 6, device=p.device)[..., ::2],
          grads=lambda g: torch.randn(8, 4, 3, 6, device=g.device)[..., ::2],
          mu=lambda m: torch.zeros(8, 4, 3, 6, device=m.device)[..., ::2],
          nu=lambda v: torch.zeros(8, 4, 3, 6, device=v.device)[..., ::2]),
     "not dense"),
    (dict(grads=lambda g: g.contiguous()), "strides"),
    (dict(nu=lambda v: v.cpu()), "float32 on cuda"),
])
def test_optim_kernel_rejects_what_it_does_not_take(cuda, bad, match):
    args = _optim_args(cuda, **bad)
    lr = torch.tensor(1e-3, device=cuda)
    with pytest.raises(ValueError, match=match):
        optim_update.cuda_optim_update("adam", args["params"], args["grads"],
                                       args["mu"], args["nu"], lr, [0.5] * 10)


def test_train_step_on_the_gpu_launches_the_optimizer_kernel(cuda):
    """A train step on the card updates its parameters through K6: the
    plan's launches a step (one for darknet_micro's list)."""
    cfg = _micro_config()
    state = create_train_state(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg)
    sizes = tuple(p.numel() for p in state.model.parameters())
    before = optim_update.LAUNCHES
    for seed in (5, 6):
        state, _ = step(state, *_micro_batch(seed), seed)
    torch.cuda.synchronize()
    assert optim_update.LAUNCHES - before == 2 * len(
        optim_update.optim_launch_plan(sizes)) == 2


def _transfer_config(backbone, head, kernels, **model):
    """A v1 transfer model at 64² (2x2 features, grid 2), float32, SGD."""
    cfg = tiny_cpu_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, grid=2),
        model=dataclasses.replace(cfg.model, backbone=backbone, head=head,
                                  image_size=64,
                                  bn_mode="fused" if kernels else "flax",
                                  **model),
        train=dataclasses.replace(cfg.train, use_pallas_loss=kernels,
                                  optimizer="sgd"))


def _transfer_batch():
    rng = np.random.RandomState(4)
    images = rng.randint(0, 256, (4, 64, 64, 3), np.uint8)
    boxes = np.zeros((4, 8, 5), np.float32)
    boxes[:, :2] = [[0.5, 0.5, 0.3, 0.3, 1], [0.25, 0.3, 0.3, 0.4, 2]]
    valid = np.zeros((4, 8), bool)
    valid[:, :2] = True
    return images, boxes, valid


def test_frozen_vgg16_step_kernel_path_matches_plain_path(cuda, no_tf32):
    """The reference's recipe, VGG16 + conv head with the backbone frozen,
    one step on the card: the kernel path (K2, K3 once for the head's
    BatchNorm, K4, K5 once) against the plain path from the same weights
    and draws: loss and every head gradient to 1e-4, the backbone
    bit-unchanged on both."""
    images, boxes, valid = _transfer_batch()
    out = {}
    for kernels in (True, False):
        cfg = _transfer_config("vgg16", "conv", kernels, freeze_backbone=True)
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        counts = _counts()
        state, metrics = make_train_step(cfg)(state, images, boxes, valid, 3)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), counts)]
        assert launched == ([1, 1, 1, 1] if kernels else [0, 0, 0, 0])
        after = state.model.state_dict()
        for k, v in after.items():
            assert torch.equal(v, before[k]) == k.startswith("backbone."), k
        out[kernels] = (metrics["total"].item(),
                        {k: p.grad for k, p in state.model.named_parameters()
                         if p.grad is not None})
    (k_loss, k_grad), (p_loss, p_grad) = out[True], out[False]
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    assert set(k_grad) == set(p_grad) and all(k.startswith("head.")
                                              for k in k_grad)
    for k, want in p_grad.items():
        if k.endswith("conv.bias"):
            continue
        err = (torch.linalg.vector_norm(k_grad[k] - want)
               / torch.linalg.vector_norm(want)).item()
        assert err <= 1e-4, (k, err)


def test_gap_dense_step_on_the_gpu_matches_the_cpu(cuda, no_tf32):
    """MobileNetV2 + GAP dense head with its 2-D BatchNorm, one kernel-path
    step on the card (K2 and K3 53 times: 52 backbone BatchNorms and the
    head's) against the same step on the CPU: loss and running statistics
    to 1e-4."""
    cfg = _transfer_config("mobilenetv2", "gap_dense", True,
                           head_dense_units=64)
    images, boxes, valid = _transfer_batch()
    step = make_train_step(cfg)
    counts = _counts()
    gpu, m_gpu = step(create_train_state(cfg, torch.Generator().manual_seed(1)),
                      images, boxes, valid, 2)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), counts)] == [53, 53, 1, 1]
    cpu, m_cpu = step(create_train_state(cfg, torch.Generator().manual_seed(1),
                                         "cpu"), images, boxes, valid, 2)
    torch.testing.assert_close(m_gpu["total"].cpu(), m_cpu["total"], rtol=1e-4,
                               atol=0)
    want = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4, atol=1e-4,
                                       msg=k)


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


def _grids(seed, batch=4, classes=3):
    """(y_true, y_pred) grids: 3 objects an image, predictions near them."""
    rng = np.random.RandomState(seed)
    yt = np.zeros((batch, 7, 7, classes + 10), np.float32)
    for b in range(batch):
        for _ in range(3):
            i, j = rng.randint(7), rng.randint(7)
            yt[b, i, j, :classes + 1] = 0
            yt[b, i, j, rng.randint(classes)] = 1
            yt[b, i, j, classes] = 1
            yt[b, i, j, classes + 1:classes + 5] = rng.uniform(
                [0, 0, 0.05, 0.05], [1, 1, 0.5, 0.5])
    yp = (0.8 * yt + 0.3 * rng.uniform(-0.2, 1, yt.shape)).astype(np.float32)
    return torch.from_numpy(yt), torch.from_numpy(yp)


@pytest.mark.parametrize("nms_on_targets", [True, False])
def test_map_on_the_gpu_matches_the_cpu(cuda, nms_on_targets):
    """The accumulator on the card (NMS kernel, two launches an update with
    NMS on the targets, one without) gives the CPU's mAP, per-class AP and
    PR curves within 1e-6; the kernel's keep sets are bit-equal, only the
    float sums may differ."""
    from keras_object_detection_torch.ops.map import MeanAveragePrecision

    metrics = {dev: MeanAveragePrecision(3, 2, nms_on_targets=nms_on_targets)
               for dev in ("cpu", "cuda")}
    before = cuda_nms.LAUNCHES
    for seed in range(3):
        yt, yp = _grids(seed)
        weight = torch.tensor([1, 1, 1, seed != 2])
        for dev, m in metrics.items():
            m.update_state(yt.to(dev), yp.to(dev), weight.to(dev))
    assert cuda_nms.LAUNCHES - before == 3 * (2 if nms_on_targets else 1)
    got, want = metrics["cuda"], metrics["cpu"]
    assert abs(got.result() - want.result()) <= 1e-6 and got.result() > 0
    np.testing.assert_allclose(got.result_per_class(), want.result_per_class(),
                               atol=1e-6)
    multi, cpu_multi = got.result_multi(), want.result_multi()
    for k in multi:
        assert abs(multi[k] - cpu_multi[k]) <= 1e-6, k
    yt, _ = _grids(7)
    gt = MeanAveragePrecision(3, 2)
    gt.update_state(yt.to(cuda), yt.to(cuda))
    assert 1.0 - 1e-5 <= gt.result() <= 1.0


def _cached_set(root, n, seed):
    """A small decoded-cache dataset (no decoder needed) at 56²."""
    import os

    from keras_object_detection_torch.data import YoloDataset, disk_cache

    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, f"{i}.jpg") for i in range(n)]
    for p in paths:
        open(p, "wb").close()
    images, boxes, valid = _micro_batch(seed)
    reps = -(-n // 4)
    disk_cache.write(os.path.join(root, "cache"), paths, 56, 8,
                     zip(np.tile(images, (reps, 1, 1, 1))[:n],
                         np.tile(boxes, (reps, 1, 1))[:n],
                         np.tile(valid, (reps, 1))[:n]))
    return lambda shuffle: YoloDataset(root, 56, 4, max_boxes=8,
                                       shuffle=shuffle,
                                       cache_dir=os.path.join(root, "cache"))


@pytest.mark.parametrize("device_cache", [False, True])
def test_fit_on_the_gpu_goes_through_the_kernels(cuda, tmp_path, device_cache):
    """Trainer.fit on the card: 5 launches of each BN kernel and one of each
    loss kernel a train step, two NMS launches a mAP update, finite losses,
    a checkpoint that restores bit for bit and an Evaluator that gives the
    logged val loss of the best epoch."""
    import json

    from keras_object_detection_torch.eval import Evaluator
    from keras_object_detection_torch.train import Trainer

    ds = _cached_set(str(tmp_path / "data"), 10, 4)
    cfg = _micro_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=4,
                                      device_cache=device_cache),
        train=dataclasses.replace(
            cfg.train, map_eval_start_epoch=0, map_eval_every=1,
            schedule=dataclasses.replace(cfg.train.schedule, base_lr=1e-5),
            checkpoint_dir=str(tmp_path / "ckpt"),
            log_dir=str(tmp_path / "logs")),
        eval=dataclasses.replace(cfg.eval, mask_padded_images=True))
    trainer = Trainer(cfg, use_tensorboard=False)
    before, nms_before = _counts(), cuda_nms.LAUNCHES
    state = trainer.fit(ds(True), ds(False), epochs=2, verbose=False)
    torch.cuda.synchronize()
    steps, updates = 2 * 3, 2 * 3
    assert [a - b for a, b in zip(_counts(), before)] == [
        5 * steps, 5 * steps, steps, steps]
    assert cuda_nms.LAUNCHES - nms_before == 2 * updates
    with open(trainer.logger.path) as f:
        logs = [json.loads(line) for line in f]
    assert all(np.isfinite(r["val_loss"]) and 0 <= r["val_mAP"] <= 1
               for r in logs)
    restored = trainer.ckpt.restore(state, step=trainer.ckpt.latest_step)
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    best = trainer.ckpt.best_step
    out = Evaluator(cfg).evaluate(trainer.ckpt.restore(state), ds(False))
    logged = [r for r in logs if r["step"] == best][-1]
    assert out["loss"] == pytest.approx(logged["val_loss"], rel=1e-6)
    assert out["mAP"] == pytest.approx(logged["val_mAP"], abs=1e-6)
    trainer.close()


def test_prefetched_batches_reach_the_gpu_from_pinned_memory(cuda, tmp_path):
    ds = _cached_set(str(tmp_path), 10, 5)
    host, fetched = ds(True), ds(True)
    for _ in range(2):
        for want, got in zip(host.epoch(), fetched.prefetched(cuda)):
            for a, b in zip(got, want):
                assert a.is_cuda
                np.testing.assert_array_equal(a.cpu().numpy(), b)


def test_decoded_jpegs_match_on_the_gpu_machine(cuda, tmp_path):
    """Where cv2 imports, JPEGs written and read back here decode to the
    same batches through the host loader and the device cache."""
    cv2 = pytest.importorskip("cv2")
    from keras_object_detection_torch.data import (DeviceCachedDataset,
                                                   YoloDataset)

    rng = np.random.RandomState(0)
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"{i}.jpg"),
                    rng.randint(0, 256, (64, 80, 3)).astype(np.uint8))
        (tmp_path / f"{i}.txt").write_text("1 0.5 0.5 0.2 0.3\n")
    mk = lambda: YoloDataset(str(tmp_path), 56, 2, max_boxes=4, shuffle=True)
    host, dev = mk(), DeviceCachedDataset(mk(), cuda)
    for (hi, hb, hv), (di, db, dv, _) in zip(host.epoch(), dev.epoch()):
        for a, b in zip((di, db, dv), (hi, hb, hv)):
            np.testing.assert_array_equal(a.cpu().numpy(), b)


def _recipe_micro_config(kernels, **model):
    """_micro_config with the v1 recipe: mosaic 1.0, mixup 0.5, adamw with
    weight decay 5e-4; ``kernels`` picks the path."""
    cfg = _micro_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       bn_mode="fused" if kernels else "flax",
                                       **model),
        data=dataclasses.replace(cfg.data, mosaic_prob=1.0, mixup_prob=0.5),
        train=dataclasses.replace(cfg.train, use_pallas_loss=kernels,
                                  optimizer="adamw", weight_decay=5e-4))


def test_recipe_step_kernel_path_matches_plain_path(cuda, no_tf32):
    """The recipe step (mosaic, mixup, adamw) at a multiscale size (48²,
    S=6, from 56² images) on the card: the kernel path (K2, K3 5 times, K4,
    K5 once) against the plain path from the same weights and draws, loss
    and every gradient to 1e-4 in norm, as the frozen VGG16 step's."""
    from keras_object_detection_torch.train import multiscale_grid

    images, boxes, valid = _micro_batch(6)
    out = {}
    for kernels in (True, False):
        cfg = _recipe_micro_config(kernels)
        assert multiscale_grid(cfg, 48) == 6
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        counts = _counts()
        state, metrics = make_train_step(cfg, image_size=48, grid=6)(
            state, images, boxes, valid, 3)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), counts)]
        assert launched == ([5, 5, 1, 1] if kernels else [0, 0, 0, 0])
        out[kernels] = (metrics["total"].item(),
                        {k: p.grad for k, p in state.model.named_parameters()
                         if not k.endswith("conv.bias")})
    (k_loss, k_grad), (p_loss, p_grad) = out[True], out[False]
    assert abs(k_loss - p_loss) <= 1e-4 * abs(p_loss)
    for k, want in p_grad.items():
        err = (torch.linalg.vector_norm(k_grad[k] - want)
               / torch.linalg.vector_norm(want)).item()
        assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("size", [320, 576])
def test_kernels_match_plain_versions_at_multiscale_shapes(cuda, size):
    """K2 and K3 at the flagship's 25 BatchNorm shapes at batch 64 and
    ``size``² in bf16 (within 1e-5 of each sum's largest channel), K4 and
    K5 at its 64·S² loss rows (S = 5 at 320, 9 at 576; C20/B2): K4 within
    1e-6 relative, K5 bit-equal."""
    from chip_smoke import bn_inputs, bn_rel_err, bn_shapes, loss_case
    from keras_object_detection_torch.config import voc_full_config

    cfg = voc_full_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_size=size))
    shapes = bn_shapes(cuda, cfg)
    assert len(shapes) == 25 and shapes[-1][2] == {320: 5, 576: 9}[size]
    gen = torch.Generator(device=cuda).manual_seed(size)
    for shape in shapes:
        x, dy, mean, rstd = bn_inputs(shape, torch.bfloat16, gen, cuda)
        assert bn_rel_err(bn.cuda_bn_stats_sums(x),
                          bn.bn_stats_sums_plain(x)) <= 1e-5, shape
        assert bn_rel_err(bn.cuda_bn_grad_sums(dy, x, mean, rstd),
                          bn.bn_grad_sums_plain(dy, x, mean, rstd)) <= 1e-5, \
            shape
    rows = 64 * shapes[-1][2] ** 2
    t_np, p_np, c, b = loss_case("C20 B2", rows)
    t, p = torch.from_numpy(t_np).to(cuda), torch.from_numpy(p_np).to(cuda)
    got = yolo_loss.cuda_yolo_v1_loss_forward(t, p, c, b)
    want = yolo_loss.yolo_v1_loss_forward_plain(t, p, c, b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    g = torch.tensor(0.75, device=cuda)
    assert torch.equal(yolo_loss.cuda_yolo_v1_loss_backward(t, p, g, c, b),
                       yolo_loss.yolo_v1_loss_backward_plain(t, p, g, c, b))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_is_bit_equal_on_the_card(cuda, no_tf32, policy):
    """Two recipe steps on the kernel path with remat against two without,
    from the same weights and draws, deterministic cuDNN: loss, every
    parameter and running statistic bit-equal; the recompute launches K2 a
    second time for each BatchNorm (10 a step), K3 once (5)."""
    images, boxes, valid = _micro_batch(7)
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for remat in (False, True):
            cfg = _recipe_micro_config(True, remat=remat, remat_policy=policy)
            state = create_train_state(cfg, torch.Generator().manual_seed(2))
            step = make_train_step(cfg)
            counts = _counts()
            for _ in range(2):
                state, metrics = step(state, images, boxes, valid, 4)
            torch.cuda.synchronize()
            launched = [a - b for a, b in zip(_counts(), counts)]
            assert launched == [20 if remat else 10, 10, 2, 2]
            out[remat] = (metrics["total"], state.model.state_dict())
    finally:
        torch.backends.cudnn.deterministic = flag
    assert torch.equal(out[True][0], out[False][0])
    for k, v in out[True][1].items():
        assert torch.equal(v, out[False][1][k]), k


def test_bn_kernels_match_plain_versions_at_yolov2_shapes(cuda):
    """K2 and K3 at the 21 BatchNorm inputs of chip_smoke's YOLOv2 step
    (Darknet-19 + the passthrough head at 416², batch 64, bf16; the
    largest 64x32x416x416, the tap's 64x64x26x26): within 1e-5 of each
    sum's largest channel, the same bits from call to call."""
    from chip_smoke import bn_inputs, bn_rel_err, bn_shapes, yolov2_config

    shapes = bn_shapes(cuda, yolov2_config())
    assert len(shapes) == 21
    assert (64, 32, 416, 416) in shapes and (64, 64, 26, 26) in shapes
    assert shapes[-1] == (64, 1024, 13, 13)
    gen = torch.Generator(device=cuda).manual_seed(416)
    for shape in shapes:
        x, dy, mean, rstd = bn_inputs(shape, torch.bfloat16, gen, cuda)
        k2 = bn.cuda_bn_stats_sums(x)
        k3 = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
        assert bn_rel_err(k2, bn.bn_stats_sums_plain(x)) <= 1e-5, shape
        assert bn_rel_err(k3, bn.bn_grad_sums_plain(dy, x, mean,
                                                    rstd)) <= 1e-5, shape
        assert torch.equal(bn.cuda_bn_stats_sums(x), k2), shape
        assert torch.equal(bn.cuda_bn_grad_sums(dy, x, mean, rstd), k3), shape


@pytest.mark.parametrize("batch", [1, 32])
def test_nms_kernel_behind_the_top_k_cut(cuda, batch):
    """YOLOv2's 13·13·5 = 845 candidates an image: the router cuts them to
    max_candidates = 512 and launches K1 once, bit-equal to the plain NMS of
    the same cut rows; uncut, 845 rows fit under MAX_N as well."""
    from chip_smoke import nms_rows
    from keras_object_detection_torch.ops.nms import top_k_candidates

    x = torch.from_numpy(nms_rows(batch, batch, 845)).to(cuda)
    before = cuda_nms.LAUNCHES
    rows, valid = cuda_nms.auto_batched_non_max_suppression(x, 0.5, 0.4, 512)
    assert cuda_nms.LAUNCHES == before + 1 and rows.shape == (batch, 512, 6)
    want_rows, want_valid = batched_non_max_suppression(
        top_k_candidates(x, 512), 0.5, 0.4)
    assert torch.equal(rows, want_rows) and torch.equal(valid, want_valid)


@pytest.mark.parametrize("obj_target,ignore", [("iou", 0.6), ("one", None)])
def test_v2_loss_on_the_card_matches_the_cpu(cuda, obj_target, ignore):
    """yolo_v2_loss_terms at YOLOv2's grid (S = 13, 5 priors, C = 20,
    batch 8) on the card against the CPU: every term and the gradient in
    y_pred within 1e-5."""
    from chip_smoke import YOLOV2_ANCHORS
    from keras_object_detection_torch.core.anchors import encode_anchor_grid
    from keras_object_detection_torch.losses import yolo_v2_loss_terms

    rng = np.random.RandomState(0)
    boxes = np.zeros((8, 12, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.05, 0.95, (8, 12, 2))
    boxes[..., 2:4] = rng.uniform(0.03, 0.8, (8, 12, 2))
    boxes[..., 4] = rng.randint(0, 20, (8, 12))
    valid = rng.rand(8, 12) < 0.7
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    y_true = encode_anchor_grid(boxes, valid, 20, YOLOV2_ANCHORS, 13)
    y_pred = torch.from_numpy(rng.normal(0, 1.5, tuple(y_true.shape)).astype(
        np.float32))
    out = []
    for where in (cuda, "cpu"):
        p = y_pred.to(where).requires_grad_(True)
        terms = yolo_v2_loss_terms(
            y_true.to(where), p, 20, YOLOV2_ANCHORS, ignore_threshold=ignore,
            gt_boxes=boxes.to(where), gt_valid=valid.to(where),
            obj_target=obj_target)
        terms["total"].backward()
        out.append(({k: v.item() for k, v in terms.items()}, p.grad.cpu()))
    (card, card_grad), (cpu, cpu_grad) = out
    for k in cpu:
        assert card[k] == pytest.approx(cpu[k], rel=1e-5), k
    scale = cpu_grad.abs().max()
    torch.testing.assert_close(card_grad, cpu_grad, rtol=1e-5,
                               atol=1e-5 * scale.item())


def test_anchor_passthrough_step_on_the_gpu_goes_through_the_kernels(cuda):
    """A darknet_micro + passthrough anchor step (ignore 0.6, IoU target,
    bn_mode fused) on the card: K2 and K3 once for each of its 7
    BatchNorms, no K4/K5 (the v2 loss is plain torch), a finite loss."""
    cfg = _micro_config()
    cfg = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, anchors=(
            (0.1, 0.15), (0.4, 0.3), (0.8, 0.8))),
        model=dataclasses.replace(cfg.model, head="anchor", passthrough=True,
                                  bn_mode="fused"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=False,
                                  ignore_threshold=0.6, obj_target="iou"))
    state = create_train_state(cfg, torch.Generator().manual_seed(0))
    images, boxes, valid = _micro_batch(3)
    counts = _counts()
    state, metrics = make_train_step(cfg)(state, images, boxes, valid, 1)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), counts)] == [7, 7, 0, 0]
    assert torch.isfinite(metrics["total"])


def _fpn_micro_config():
    """darknet_micro @56 + the FPN head over 2 scales (S = 7, 14; JAX's FPN
    tests' 6 priors), bn_mode fused, the v3 loss with YOLOv3's ignore
    threshold 0.5 and IoU objectness, SGD, float32."""
    cfg = _micro_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, anchors=(
            (0.8, 0.7), (0.5, 0.6), (0.35, 0.3), (0.2, 0.25), (0.12, 0.1),
            (0.05, 0.06))),
        model=dataclasses.replace(cfg.model, head="fpn", fpn_scales=2,
                                  activation="leaky_relu"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=False,
                                  ignore_threshold=0.5, obj_target="iou"))


def test_fpn_step_on_the_gpu_matches_the_cpu(cuda, no_tf32):
    """One FPN step on the card: K2 and K3 once for each of its 17
    BatchNorms (4 in the backbone, 7 + 6 in the head), no K4/K5 (the v3
    loss is plain torch); loss and running statistics against the same
    step on the CPU to 1e-4. The parameters are not compared: the
    1024-wide prediction blocks' BatchNorm backward cancels three to four
    digits of their gradients (tests/test_torch_fpn_train.py)."""
    cfg = _fpn_micro_config()
    images, boxes, valid = _micro_batch(5)
    step = make_train_step(cfg)
    counts = _counts()
    gpu, m_gpu = step(create_train_state(cfg, torch.Generator().manual_seed(1)),
                      images, boxes, valid, 2)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), counts)] == [17, 17, 0, 0]
    cpu, m_cpu = step(create_train_state(cfg, torch.Generator().manual_seed(1),
                                         "cpu"), images, boxes, valid, 2)
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-4,
                                   atol=0, msg=k)
    want = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        if "running" in k:
            torch.testing.assert_close(v.cpu(), want[k], rtol=1e-4, atol=1e-4,
                                       msg=k)


@pytest.mark.parametrize("shape", [(32, 768, 26, 26), (32, 384, 52, 52)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_kernels_match_plain_versions_at_fpn_concat_shapes(cuda, shape,
                                                              dtype):
    """K2 and K3 at the FPN head's concatenations [upsampled, tap] at
    batch 32 (768 channels at 26², 384 at 52²), channel counts no other
    model has: within 1e-5 of each sum's largest channel, the same bits
    from call to call."""
    from chip_smoke import bn_inputs, bn_rel_err

    gen = torch.Generator(device=cuda).manual_seed(768)
    x, dy, mean, rstd = bn_inputs(shape, dtype, gen, cuda)
    k2 = bn.cuda_bn_stats_sums(x)
    k3 = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
    assert bn_rel_err(k2, bn.bn_stats_sums_plain(x)) <= 1e-5
    assert bn_rel_err(k3, bn.bn_grad_sums_plain(dy, x, mean, rstd)) <= 1e-5
    assert torch.equal(bn.cuda_bn_stats_sums(x), k2)
    assert torch.equal(bn.cuda_bn_grad_sums(dy, x, mean, rstd), k3)


def test_bn_shapes_of_yolov3(cuda):
    """chip_smoke's YOLOv3 step has 72 BatchNorm inputs (52 in Darknet-53,
    20 in the FPN head), among them the two concatenations."""
    from chip_smoke import YOLOV3_BN, bn_shapes, yolov3_config

    shapes = bn_shapes(cuda, yolov3_config(), batch=32)
    assert len(shapes) == YOLOV3_BN == 72
    assert shapes[0] == (32, 32, 416, 416)
    assert shapes.count((32, 256, 26, 26)) >= 1
    assert (32, 768, 26, 26) not in shapes  # a BN sees the conv's output
    assert shapes[-1] == (32, 256, 52, 52)


@pytest.mark.parametrize("batch", [1, 32])
def test_nms_kernel_behind_the_fpn_top_k_cut(cuda, batch):
    """YOLOv3's 3·(13² + 26² + 52²) = 10,647 candidates an image: the router
    cuts them to max_candidates = 512 and launches K1 once, bit-equal to
    the plain NMS of the same cut rows; uncut, 10,647 rows are above
    MAX_N and the kernel raises (no fallback)."""
    from chip_smoke import nms_rows
    from keras_object_detection_torch.ops.nms import top_k_candidates

    x = torch.from_numpy(nms_rows(batch, batch, 10647)).to(cuda)
    before = cuda_nms.LAUNCHES
    rows, valid = cuda_nms.auto_batched_non_max_suppression(x, 0.5, 0.4, 512)
    assert cuda_nms.LAUNCHES == before + 1 and rows.shape == (batch, 512, 6)
    want_rows, want_valid = batched_non_max_suppression(
        top_k_candidates(x, 512), 0.5, 0.4)
    assert torch.equal(rows, want_rows) and torch.equal(valid, want_valid)
    with pytest.raises(ValueError):
        cuda_nms.auto_batched_non_max_suppression(x, 0.5, 0.4, 0)


def test_v3_loss_on_the_card_matches_the_cpu(cuda):
    """yolo_v3_loss_terms at YOLOv3's grids (S = 13 / 26 / 52, its 9
    priors, C = 20, batch 4, ignore 0.5, IoU objectness) on the card
    against the CPU: every term and the gradient in each scale's y_pred
    within 1e-5."""
    from keras_object_detection_torch.config import YOLOV3_ANCHORS_416
    from keras_object_detection_torch.core.fpn import encode_fpn_grids
    from keras_object_detection_torch.losses import yolo_v3_loss_terms

    rng = np.random.RandomState(0)
    boxes = np.zeros((4, 12, 5), np.float32)
    boxes[..., :2] = rng.uniform(0.05, 0.95, (4, 12, 2))
    boxes[..., 2:4] = rng.uniform(0.02, 0.8, (4, 12, 2))
    boxes[..., 4] = rng.randint(0, 20, (4, 12))
    valid = rng.rand(4, 12) < 0.7
    boxes, valid = torch.from_numpy(boxes), torch.from_numpy(valid)
    y_true = encode_fpn_grids(boxes, valid, 20, YOLOV3_ANCHORS_416, 13)
    y_pred = [torch.from_numpy(rng.normal(0, 1.5, tuple(t.shape)).astype(
        np.float32)) for t in y_true]
    out = []
    for where in (cuda, "cpu"):
        preds = [p.to(where).requires_grad_(True) for p in y_pred]
        terms = yolo_v3_loss_terms(
            [t.to(where) for t in y_true], preds, 20, YOLOV3_ANCHORS_416,
            ignore_threshold=0.5, gt_boxes=boxes.to(where),
            gt_valid=valid.to(where), obj_target="iou")
        terms["total"].backward()
        out.append(({k: v.item() for k, v in terms.items()},
                    [p.grad.cpu() for p in preds]))
    (card, card_grads), (cpu, cpu_grads) = out
    for k in cpu:
        assert card[k] == pytest.approx(cpu[k], rel=1e-5), k
    for a, b in zip(card_grads, cpu_grads):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())


# --- the serving extras and int8 serving on the card ----------------------


@pytest.mark.parametrize("kernel,stride,pad,size,batch,cin,cout", [
    (3, 1, 1, 9, 2, 3, 16), (7, 2, 3, 32, 4, 3, 64), (3, 2, 1, 10, 2, 16, 8),
    (1, 1, 0, 6, 3, 64, 24), (3, 1, "SAME", 7, 2, 16, 12),
    (3, 2, "SAME", 8, 2, 8, 16), (3, 1, 1, 3, 1, 16, 8)])  # M = 9 <= 16
def test_int8_route_equals_the_plain_gemm(cuda, kernel, stride, pad, size,
                                          batch, cin, cout):
    """The route (im2col + torch._int_mm, K, N and M padded where
    _int_mm needs it) against the plain float64 GEMM on the card and the
    CPU's, equal; one GEMM counted."""
    from keras_object_detection_torch.ops import int8_conv

    g = torch.Generator().manual_seed(size * 10 + cin)
    xq = torch.randint(-127, 128, (batch, size, size, cin), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, kernel, kernel, cin), generator=g,
                       dtype=torch.int8)
    before = int8_conv.LAUNCHES
    got = int8_conv.int8_conv2d(xq.to(cuda), wq.to(cuda), stride, pad)
    assert int8_conv.LAUNCHES == before + 1
    a, _ = int8_conv.im2col(xq.to(cuda), kernel, stride, pad)
    w = int8_conv._kernel_matrix(wq.to(cuda), a.shape[1])
    plain = int8_conv.plain_int8_matmul(a, w)[:, :cout].reshape(got.shape)
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), int8_conv.int8_conv2d(xq, wq, stride, pad))


def test_int8_route_raises_rather_than_falling_back(cuda):
    from keras_object_detection_torch.ops import int8_conv

    a = torch.ones(32, 27, dtype=torch.int8, device=cuda)  # K not 8k
    with pytest.raises(RuntimeError):
        int8_conv.int8_matmul(a, torch.ones(8, 27, dtype=torch.int8,
                                            device=cuda))


@pytest.mark.parametrize("case", ["3x98", "tied 4x49", "identical boxes 4x49",
                                  "iou tie 0.5", "signed zeros"])
@pytest.mark.parametrize("mode", ["gaussian", "linear", "fast"])
def test_soft_and_fast_nms_on_the_card_equal_the_cpu(cuda, case, mode):
    from chip_smoke import SOFT_NMS_RTOL, nms_mode_fn, nms_rows, same_nms_result

    rows, iou, conf = ((nms_rows(9, 3, 98), 0.5, 0.4) if case == "3x98"
                       else NMS_CASES[case]())
    rows = torch.from_numpy(rows)
    fn = nms_mode_fn(mode)
    ok, rel = same_nms_result(fn(rows.to(cuda), iou, conf),
                              fn(rows, iou, conf), SOFT_NMS_RTOL)
    assert ok, rel


def test_int8_serving_on_the_gpu_goes_through_the_route_and_k1(cuda):
    from keras_object_detection_torch.export import Int8InferenceModel
    from keras_object_detection_torch.ops import int8_conv

    cfg = tiny_cpu_config()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = Int8InferenceModel(cfg, sd)
    assert model.device.type == "cuda"
    n_int8 = sum("w_q" in layer for layer in model.layers)
    images = np.random.RandomState(9).randint(0, 256, (4, 224, 224, 3),
                                              np.uint8)
    nms_before, int8_before = cuda_nms.LAUNCHES, int8_conv.LAUNCHES
    rows, valid = model.predict(images)
    assert cuda_nms.LAUNCHES == nms_before + 1
    assert int8_conv.LAUNCHES == int8_before + n_int8
    want = Int8InferenceModel(cfg, sd, device="cpu").predict_raw(images)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the float32 final conv
    try:
        got = model.predict_raw(images).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture
def synth_set(tmp_path):
    """tools/make_synthetic_dataset.py's 20-class set at 56²: 16 train and
    8 val images (cv2, as on the card's machine)."""
    import os
    import subprocess
    import sys

    pytest.importorskip("cv2")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "synth")
    subprocess.run([sys.executable, os.path.join(root, "tools",
                                                 "make_synthetic_dataset.py"),
                    "--out", out, "--train", "16", "--val", "8",
                    "--image-size", "56", "--seed", "0"], check=True)
    return out


def test_learning_run_on_the_gpu_goes_through_the_loss_kernels(cuda, synth_set,
                                                               tmp_path):
    """cli.run_synth_benchmark for 2 epochs on the card with --pallas-loss
    and the set on the card: K4 and K5 once a step, K1 twice a mAP update
    (the second epoch's, the final and the best checkpoint's evaluation),
    finite results with the JAX tool's keys."""
    import json

    from keras_object_detection_torch.cli import run_synth_benchmark as synth

    work = str(tmp_path / "run")
    before, nms_before = _counts(), cuda_nms.LAUNCHES
    got = synth.main(["--data", synth_set, "--workdir", work, "--backbone",
                      "darknet_micro", "--image-size", "56", "--batch-size",
                      "4", "--epochs", "2", "--map-start", "1",
                      "--map-every", "1", "--ema", "0.99", "--device-cache",
                      "--pallas-loss"])
    torch.cuda.synchronize()
    steps, val_batches = 2 * 4, 2
    assert [a - b for a, b in zip(_counts(), before)] == [0, 0, steps, steps]
    assert cuda_nms.LAUNCHES - nms_before == 2 * 3 * val_batches
    assert np.isfinite(got["val_loss"]) and 0.0 <= got["val_mAP"] <= 1.0
    assert got["val_mAP_peak_epoch"] == 1 and got["train_images"] == 16
    with open(f"{work}/results.json") as f:
        assert json.load(f) == got


def test_round_trip_on_the_gpu_goes_through_k1(cuda, synth_set, tmp_path):
    """cli.visualize_dataset on the card: K1 once an image, its rows the
    plain NMS's of the same decoded rows, each image's labels back; the
    CPU's round trip within one rounding (the card divides by S as a
    multiply by 1/S)."""
    from keras_object_detection_torch.cli import visualize_dataset
    from keras_object_detection_torch.core.grid import decode_grid, encode_grid

    argv = ["--data-dir", f"{synth_set}/val", "--names",
            f"{synth_set}/synth.names", "--image-size", "56",
            "--num-classes", "20", "--out-dir", str(tmp_path / "v")]
    before = cuda_nms.LAUNCHES
    card = visualize_dataset.main(argv)
    assert cuda_nms.LAUNCHES - before == len(card) == 8
    cpu = visualize_dataset.main([*argv, "--device", "cpu"])
    for a, b in zip(card, cpu):
        decoded = decode_grid(encode_grid(
            torch.from_numpy(a.boxes[None]).to(cuda),
            torch.from_numpy(a.valid[None]).to(cuda), 20), 20)
        rows, keep = batched_non_max_suppression(decoded)
        np.testing.assert_array_equal(a.kept, rows[0][keep[0]].cpu().numpy())
        np.testing.assert_array_equal(a.kept[:, :2], b.kept[:, :2])
        np.testing.assert_allclose(a.kept, b.kept, rtol=0, atol=2 ** -22)
        assert sorted(a.kept[:, 0]) == sorted(a.boxes[a.valid][:, 4])
