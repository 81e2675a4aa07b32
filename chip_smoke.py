#!/usr/bin/env python3
"""Drive the PyTorch port (keras_object_detection_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also torch.profiler traces in DIR

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. build   - compile ops/csrc/{nms,yolo_loss,bn_stats}.cu with nvcc for
             sm_90a, one nvcc each, all started together;
2. nms     - the NMS kernel against its plain PyTorch version on the card,
             bit-equal (torch.equal) on rows and masks at every shape the
             serving path can give it, plus tied and all-filtered inputs;
             kernel and plain times;
3. check   - the small CPU-runnable model on the GPU against the same model
             on the CPU (float32, TF32 off), to 1e-4;
4. serve   - the flagship voc_full_config (Darknet-24, 448², C=20, bf16)
             at full width with seeded random weights, answering batch-1
             and batch-32 requests through InferenceModel; the NMS launch
             count of those requests, predict() == the plain NMS of
             predict_decoded() on the card, p50 latency, images/s, peak
             memory and a per-stage breakdown;
5. loss    - the fused-loss kernels (forward K4, backward K5) against their
             plain versions at the train step's (64*49, 30) rows, at
             (2*49, 20) rows with B=3, and at hand-built tie and clip-bound
             rows, both noobj modes; times and bounds;
6. bn      - the BN-statistics kernels (K2, K3) against their plain versions
             at the shape of each of the flagship's 25 BatchNorms at batch
             64, in bf16 and f32, and at odd shapes; times, bounds, and
             beside them the one PyTorch call that computes each
             function (torch.var_mean for K2,
             torch.batch_norm_backward_reduce for K3);
7. train-check - a small model's train step (darknet_micro @56, both
             kernel switches on, SGD, float32, TF32 off) on the GPU against
             the same step on the CPU from the same weights and draws, stage
             by stage: the augmented images and boxes (1e-4), the grid
             (exact), then from identical images and grid the loss, y_pred,
             every parameter's gradient (in norm) and the running
             statistics (1e-4), then the whole step: loss and running
             statistics to 1e-4, each parameter tensor's update to 1e-2 in
             norm (a max-pool tie may flip, see phase_train_check);
8. train   - the flagship train step at full width and batch 64 (nadam,
             use_pallas_loss=True, bn_mode="fused"): launches of each kernel
             per step (K2 25, K3 25, K4 1, K5 1), step p50, images/s, peak
             memory, a finite loss; the same numbers for the plain path
             (both switches off); one step of each path from the same state
             and draws, compared in loss, BN running statistics and every
             parameter's gradient; the gradients against the float32 step,
             from which the kernel path must lie about as far as the plain
             path does (bf16 gradients of the early layers are mostly
             rounding at a random init).

Then one JSON line describing each kernel, one line with the card's name and
power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Float32 results are compared with TF32 off
(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gzip
import json
import os
import shutil
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores

NMS_SHAPES = [(1, 49), (32, 49), (32, 98), (4, 196), (8, 512), (2, 1024)]
KERNEL_SOURCES = ("nms", "yolo_loss", "bn_stats")
TRAIN_WARMUP, TRAIN_STEPS = 3, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def nms_rows(seed: int, b: int, n: int, num_classes: int = 20) -> np.ndarray:
    """Clustered random rows [cls, conf, cx, cy, w, h]: same-class overlaps
    are common, so suppression has work to do."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0.1, 0.9, size=(16, 2))
    cls = rng.randint(0, num_classes, size=(b, n))
    conf = rng.uniform(0, 1, size=(b, n))
    xy = centres[rng.randint(0, 16, size=(b, n))] + rng.normal(0, 0.03, (b, n, 2))
    wh = rng.uniform(0.05, 0.4, size=(b, n, 2))
    return np.concatenate([cls[..., None], conf[..., None], xy, wh],
                          axis=-1).astype(np.float32)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, replays: int = 10) -> float:
    """Device milliseconds per call, without host launch cost: ``reps``
    calls captured in one CUDA graph, replayed ``replays`` times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def nms_bound_ms(rows: torch.Tensor) -> tuple:
    """Least time for NMS on these rows: bytes (rows in, rows and mask out)
    over the memory rate against float32 operations over the float32 rate.
    Operations: 3 per rank comparison (N^2 per image), 17 per IoU of the
    same-class pairs this data has, 9 per row for its corners."""
    b, n, _ = rows.shape
    nbytes = b * n * 6 * 4 * 2 + b * n
    cls = rows[..., 0]
    same = (cls[:, :, None] == cls[:, None, :]).triu(1).sum().item()
    ops = b * (3 * n * n + 9 * n) + 17 * same
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from keras_object_detection_torch.ops import _build

    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(_build.build, KERNEL_SOURCES))
    for lib, seconds, output in built:
        log(f"[build] {lib.name}: {seconds:.2f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")


def phase_nms(dev) -> dict:
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    cases = [(f"{b}x{n}", nms_rows(100 + i, b, n))
             for i, (b, n) in enumerate(NMS_SHAPES)]
    tied = nms_rows(200, 4, 49)
    tied[..., 1] = 0.9
    below = nms_rows(201, 4, 98)
    below[..., 1] *= 0.4
    cases += [("tied 4x49", tied), ("below 4x98", below)]
    max_err = 0.0
    for name, rows in cases:
        x = torch.from_numpy(rows).to(dev)
        got_rows, got_valid = cuda_nms.cuda_batched_non_max_suppression(x)
        want_rows, want_valid = batched_non_max_suppression(x)
        torch.cuda.synchronize()
        equal = (torch.equal(got_rows, want_rows)
                 and torch.equal(got_valid, want_valid))
        err = (got_rows - want_rows).abs().max().item()
        max_err = max(max_err, err)
        log(f"[nms] {name}: bit-equal={equal} kept={int(got_valid.sum())} "
            f"max_abs_err={err}")
        if not equal:
            raise SystemExit(f"NMS kernel disagrees with the plain version at {name}")

    timing = {}
    for b, n in [(32, 49), (8, 512)]:
        x = torch.from_numpy(nms_rows(300, b, n)).to(dev)
        k_ms = graph_ms(lambda: cuda_nms.cuda_batched_non_max_suppression(x))
        call_ms = cuda_ms(lambda: cuda_nms.cuda_batched_non_max_suppression(x), 200)
        p_ms = cuda_ms(lambda: batched_non_max_suppression(x), 5, warmup=1)
        bound, bound_by = nms_bound_ms(x)
        timing[(b, n)] = (k_ms, call_ms, p_ms, bound, bound_by)
        log(f"[nms] {b}x{n}: kernel {k_ms:.5f} ms on the device "
            f"({call_ms:.5f} ms per call with launch), plain {p_ms:.3f} ms, "
            f"bound {bound:.3e} ms ({bound_by})")
    return {"max_abs_err": max_err, "timing": timing}


def phase_check(dev) -> None:
    from keras_object_detection_torch.config import tiny_cpu_config
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.models import build_model

    cfg = tiny_cpu_config()
    sd = build_model(cfg, torch.Generator().manual_seed(1)).state_dict()
    images = np.random.RandomState(1).randint(0, 256, (4, 224, 224, 3), np.uint8)
    cpu = InferenceModel(cfg, sd, device="cpu").predict_decoded(images)
    gpu = InferenceModel(cfg, sd, device=dev).predict_decoded(images).cpu()
    err = (cpu - gpu).abs().max().item()
    log(f"[check] tiny float32 decode, GPU vs CPU: max_abs_err={err:.3e}")
    if not torch.allclose(gpu, cpu, rtol=1e-4, atol=1e-4):
        raise SystemExit("GPU forward disagrees with the CPU forward")


def stage_ms(model, images: torch.Tensor) -> dict:
    """Device milliseconds of each serving stage at this batch."""
    from keras_object_detection_torch.core.grid import decode_grid
    from keras_object_detection_torch.ops.cuda_nms import \
        cuda_batched_non_max_suppression

    e, g = model.config.eval, model.config.grid
    with torch.inference_mode():
        raw = model.predict_raw(images)
        decoded = model.predict_decoded(images)
        return {
            "forward": cuda_ms(lambda: model.predict_raw(images), 10),
            "decode": cuda_ms(lambda: decode_grid(
                raw, g.num_classes, g.num_boxes, g.grid), 50),
            "nms": cuda_ms(lambda: cuda_batched_non_max_suppression(
                decoded, e.iou_threshold, e.conf_threshold), 50),
        }


def conv_flops_per_image(model, images: torch.Tensor) -> int:
    """Multiply-add operations x 2 of every conv in one forward, from the
    shapes the forward hooks see, per image."""
    from keras_object_detection_torch.models.layers import Conv2d

    total = 0

    def hook(module, inputs, output):
        nonlocal total
        o, i, kh, kw = module.weight.shape
        total += 2 * o * i * kh * kw * output[0].numel() // o

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d)]
    with torch.inference_mode():
        model(images[:1].float())
    for h in handles:
        h.remove()
    return total


def phase_serve(dev, profile_dir) -> dict:
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    cfg = voc_full_config()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    n_values = sum(v.numel() for v in sd.values())
    log(f"[serve] voc_full_config: {cfg.model.backbone} {cfg.model.image_size}² "
        f"C={cfg.grid.num_classes} {cfg.model.compute_dtype}, "
        f"{n_values} values in {len(sd)} tensors")
    if n_values != 69_681_758:
        raise SystemExit("the flagship model is not at full width")
    torch.cuda.reset_peak_memory_stats(dev)
    model = InferenceModel(cfg, sd)  # the default device: the GPU
    rng = np.random.RandomState(0)
    batch1 = rng.randint(0, 256, (1, 448, 448, 3), np.uint8)
    batch32 = rng.randint(0, 256, (32, 448, 448, 3), np.uint8)

    # the main path: counts at 0 just before, read just after
    cuda_nms.LAUNCHES = 0
    rows1, valid1 = model.predict(batch1)
    rows32, valid32 = model.predict(batch32)
    single = model.predict_single(batch1[0])
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    log(f"[serve] NMS kernel launches over 3 predict calls: {launches}")
    if launches != 3:
        raise SystemExit("the serving path did not run the NMS kernel once "
                         "per predict call")

    for name, t, shape in [("rows1", rows1, (1, 49, 6)), ("valid1", valid1, (1, 49)),
                           ("rows32", rows32, (32, 49, 6)),
                           ("valid32", valid32, (32, 49))]:
        if tuple(t.shape) != shape or not t.is_cuda:
            raise SystemExit(f"{name} has shape {tuple(t.shape)} on {t.device}")
    if not (torch.isfinite(rows1).all() and torch.isfinite(rows32).all()):
        raise SystemExit("non-finite serving output")
    if not torch.equal(single, rows1[0][valid1[0]]):
        raise SystemExit("predict_single disagrees with predict")
    plain_rows, plain_valid = batched_non_max_suppression(
        model.predict_decoded(batch32), cfg.eval.iou_threshold,
        cfg.eval.conf_threshold)
    if not (torch.equal(plain_rows, rows32) and torch.equal(plain_valid, valid32)):
        raise SystemExit("predict() differs from the plain NMS of predict_decoded()")
    log(f"[serve] outputs finite, predict == plain NMS of predict_decoded; "
        f"kept {int(valid1.sum())} of 49 (batch 1), {int(valid32.sum())} of "
        f"{32 * 49} (batch 32)")

    lat1 = model.benchmark_latency(batch1, runs=30, pipeline_k=30)
    lat32 = model.benchmark_latency(batch32, runs=15, pipeline_k=15)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    imgs_per_s = 32 / lat32["p50_ms"] * 1e3
    log(f"[serve] batch 1: p50 {lat1['p50_ms']:.3f} ms, min {lat1['min_ms']:.3f}, "
        f"pipelined {lat1['pipelined_per_call_ms']:.3f} ms/call")
    log(f"[serve] batch 32: p50 {lat32['p50_ms']:.3f} ms, min "
        f"{lat32['min_ms']:.3f}, pipelined "
        f"{lat32['pipelined_per_call_ms']:.3f} ms/call, {imgs_per_s:.1f} images/s")
    log(f"[serve] peak device memory {peak_gib:.3f} GiB")
    x32 = torch.from_numpy(batch32).to(dev)
    flops = conv_flops_per_image(model.model, x32)
    log(f"[serve] conv work {flops / 1e9:.3f} GFLOP per image; at batch 32 "
        f"the bf16 tensor-core bound is {32 * flops / BF16_OPS_PER_S * 1e3:.4f} ms")
    for batch, x in [(1, x32[:1]), (32, x32)]:
        stages = stage_ms(model, x)
        log(f"[serve] stages at batch {batch} (device ms): "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.predict(x32)
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(profile_dir, "serve_b32.json"))
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
        with open(os.path.join(profile_dir, "serve_b32.txt"), "w") as f:
            f.write(table)
        log(table)
    return {"launches": launches}


def loss_rows(seed: int, n: int, c: int, b: int):
    """(n, C + 5B) y_true / y_pred rows: about 30 % object cells."""
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


def tie_rows():
    """C=3, B=2 rows with slot 0 responsible and its IoU chain on a tie:
    row 0 at the clip bound (boxes touching along x, intersection width
    exactly 0), row 1 on a corner tie (equal left corners)."""
    t, p = loss_rows(7, 49, 3, 2)
    t[:2] = 0.0
    t[:2, [0, 3]] = 1.0
    t[0, 4:8] = [0.25, 0.5, 0.25, 0.5]
    p[0, 3:8] = [0.7, 0.75, 0.6, 0.25, 0.5]
    t[1, 4:8] = [0.5, 0.5, 0.5, 0.5]
    p[1, 3:8] = [0.3, 0.75, 0.55, 0.75, 0.4]
    p[:2, 8:13] = [0.2, 0.9, 0.9, 0.1, 0.1]
    return t, p


def loss_bound_ms(n: int, c: int, b: int, backward: bool) -> tuple:
    """Least time of one loss kernel: bytes (both row sets read once, the 5
    sums or the gradient rows written once) against float32 operations
    (per row about 30 per slot for its IoU and select, 4 per class, 30 for
    the terms; the backward about 60 more per slot)."""
    d = c + 5 * b
    nbytes = 2 * n * d * 4 + (n * d * 4 if backward else 5 * 4)
    ops = n * (b * (90 if backward else 30) + 4 * c + 30)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_loss(dev) -> dict:
    from keras_object_detection_torch.ops import yolo_loss as yl

    cases = [("64x49 C20 B2", *loss_rows(1, 64 * 49, 20, 2), 20, 2),
             ("2x49 C5 B3", *loss_rows(2, 2 * 49, 5, 3), 5, 3),
             ("ties C3 B2", *tie_rows(), 3, 2)]
    g = torch.tensor(1.0, device=dev)
    fwd_err = bwd_err = 0.0
    bit_equal = True
    for name, t_np, p_np, c, b in cases:
        t = torch.from_numpy(t_np).to(dev)
        p = torch.from_numpy(p_np).to(dev)
        for mode in ("selected", "all"):
            got = yl.cuda_yolo_v1_loss_forward(t, p, c, b, noobj_mode=mode)
            want = yl.yolo_v1_loss_forward_plain(t, p, c, b, noobj_mode=mode)
            dp = yl.cuda_yolo_v1_loss_backward(t, p, g, c, b, noobj_mode=mode)
            want_dp = yl.yolo_v1_loss_backward_plain(t, p, g, c, b,
                                                     noobj_mode=mode)
            torch.cuda.synchronize()
            rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
            derr = (dp - want_dp).abs().max().item()
            same = torch.equal(dp, want_dp)
            fwd_err = max(fwd_err, (got - want).abs().max().item())
            bwd_err = max(bwd_err, derr)
            bit_equal = bit_equal and same
            log(f"[loss] {name} {mode}: forward max rel err {rel:.3e}, "
                f"backward bit-equal={same} max abs err {derr:.3e}")
            if rel > 1e-6:
                raise SystemExit(f"loss forward kernel disagrees at {name} {mode}")
            if not same and not torch.allclose(dp, want_dp, rtol=1e-6, atol=1e-6):
                raise SystemExit(f"loss backward kernel disagrees at {name} {mode}")
    log("[loss] backward: " + ("bit-equal everywhere (the same operations in "
                               "the same order, -fmad=false)" if bit_equal else
                               "within 1e-6 (the last bit differs where torch "
                               "and nvcc round a library call differently)"))

    t, p = (torch.from_numpy(x).to(dev) for x in loss_rows(3, 64 * 49, 20, 2))
    timing = {}
    for name, kernel, plain, backward in [
            ("forward", lambda: yl.cuda_yolo_v1_loss_forward(t, p, 20, 2),
             lambda: yl.yolo_v1_loss_forward_plain(t, p, 20, 2), False),
            ("backward", lambda: yl.cuda_yolo_v1_loss_backward(t, p, g, 20, 2),
             lambda: yl.yolo_v1_loss_backward_plain(t, p, g, 20, 2), True)]:
        k_ms = graph_ms(kernel)
        call_ms = cuda_ms(kernel, 200)
        p_ms = cuda_ms(plain, 20)
        bound, bound_by = loss_bound_ms(64 * 49, 20, 2, backward)
        timing[name] = (k_ms, call_ms, p_ms, bound, bound_by)
        log(f"[loss] {name} at 3136x30: kernel {k_ms:.5f} ms on the device "
            f"({call_ms:.5f} ms per call with launch), plain {p_ms:.4f} ms, "
            f"bound {bound:.3e} ms ({bound_by}); no single PyTorch call "
            f"computes this loss, so no library time")
    return {"forward_err": fwd_err, "backward_err": bwd_err, "timing": timing}


def flagship_bn_shapes(dev, batch: int = 64) -> list:
    """(N, C, H, W) of each of voc_full_config's 25 BatchNorm inputs."""
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.models.layers import BatchNorm

    model = build_model(voc_full_config(), torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((batch,) + tuple(inp[0].shape[1:])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.inference_mode():
        model(torch.zeros(1, 448, 448, 3, device=dev))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return shapes


def bn_bound_ms(shape, itemsize: int, grad: bool) -> tuple:
    """Least time of one BN-statistics launch: its inputs read once (x; dy
    and x for the gradient statistics) and the (2, C) sums written, against
    3 (5) float32 operations per element."""
    n, c, h, w = shape
    elems = n * c * h * w
    nbytes = elems * itemsize * (2 if grad else 1) + 2 * c * 4
    ops = elems * (5 if grad else 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


BN_GRAD_LIBRARY_CALL = ("torch.batch_norm_backward_reduce(dy, x, mean, rstd, "
                        "ones, False, True, True)")


def bn_grad_library(dy, x, mean, rstd, ones):
    """K3's function as one PyTorch call (the reduction of SyncBatchNorm's
    backward): ``(sum(dy), sum(dy * xhat))``, from its grad_bias and
    grad_weight outputs. ``ones`` is a float32 (C,) weight of ones: without
    a weight the call returns empty grad_weight and grad_bias."""
    _, _, grad_weight, grad_bias = torch.batch_norm_backward_reduce(
        dy, x, mean, rstd, ones, False, True, True)
    return grad_bias, grad_weight


def phase_bn(dev) -> dict:
    from keras_object_detection_torch.ops import bn

    shapes = flagship_bn_shapes(dev)
    log(f"[bn] the flagship's {len(shapes)} BatchNorm inputs at batch 64: "
        + ", ".join(f"{c}x{h}x{w}" for _, c, h, w in shapes))
    if len(shapes) != 25:
        raise SystemExit("the flagship does not have 25 BatchNorms")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_rel = {"stats": 0.0, "grad": 0.0}
    max_abs = {"stats": 0.0, "grad": 0.0}
    tot = {k: 0.0 for k in ("k2", "k3", "p2", "p3", "b2", "b3", "lib2",
                            "lib3")}
    largest = None
    lib_rel = 0.0
    odd = [(5, 32, 13, 11), (3, 24, 7, 7), (7, 24, 9, 5)]
    for shape in [*shapes, *odd]:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
            dy = torch.randn(shape, generator=gen, device=dev)
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            dy = dy.to(dtype).contiguous(memory_format=torch.channels_last)
            m = x.numel() // shape[1]
            got = bn.cuda_bn_stats_sums(x)
            want = bn.bn_stats_sums_plain(x)
            mean = want[0] / m
            rstd = torch.rsqrt(torch.clamp_min(want[1] / m - mean * mean, 0.0)
                               + 1e-3)
            got_g = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
            want_g = bn.bn_grad_sums_plain(dy, x, mean, rstd)
            torch.cuda.synchronize()
            for key, a, w in (("stats", got, want), ("grad", got_g, want_g)):
                scale = w.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
                rel = ((a - w).abs() / scale).max().item()
                max_rel[key] = max(max_rel[key], rel)
                max_abs[key] = max(max_abs[key], (a - w).abs().max().item())
                if rel > 1e-5:
                    raise SystemExit(f"BN {key} kernel disagrees at {shape} "
                                     f"{dtype}: {rel:.3e}")
            if dtype != torch.bfloat16 or shape not in shapes:
                continue
            # timing: the step's launches are bf16 at these shapes
            k2 = graph_ms(lambda: bn.cuda_bn_stats_sums(x), reps=20, replays=5)
            k3 = graph_ms(lambda: bn.cuda_bn_grad_sums(dy, x, mean, rstd),
                          reps=20, replays=5)
            p2 = cuda_ms(lambda: bn.bn_stats_sums_plain(x), 5, warmup=1)
            p3 = cuda_ms(lambda: bn.bn_grad_sums_plain(dy, x, mean, rstd), 5,
                         warmup=1)
            lib2 = cuda_ms(lambda: torch.var_mean(x, dim=(0, 2, 3),
                                                  correction=0), 5, warmup=1)
            ones = torch.ones(shape[1], device=dev)
            lib3 = cuda_ms(lambda: bn_grad_library(dy, x, mean, rstd, ones), 5,
                           warmup=1)
            # the library call computes K3's function: its sums against plain
            got_l = torch.stack(bn_grad_library(dy, x, mean, rstd, ones))
            scale = want_g.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
            lib_rel = max(lib_rel, ((got_l - want_g).abs() / scale).max().item())
            b2, _ = bn_bound_ms(shape, 2, False)
            b3, _ = bn_bound_ms(shape, 2, True)
            for key, v in (("k2", k2), ("k3", k3), ("p2", p2), ("p3", p3),
                           ("b2", b2), ("b3", b3), ("lib2", lib2),
                           ("lib3", lib3)):
                tot[key] += v
            if largest is None or x.numel() > largest["elems"]:
                largest = {"shape": list(shape), "elems": x.numel(), "k2": k2,
                           "k3": k3, "p2": p2, "p3": p3, "b2": b2, "b3": b3,
                           "lib2": lib2, "lib3": lib3}
            del x, dy
    log(f"[bn] kernels vs plain over {len(shapes)} + {len(odd)} shapes, bf16 "
        f"and f32: stats max rel err {max_rel['stats']:.3e} (max abs "
        f"{max_abs['stats']:.3e}), grad stats max rel err {max_rel['grad']:.3e} "
        f"(max abs {max_abs['grad']:.3e}); relative to each sum's largest "
        f"channel, float32 sums in another order")
    log(f"[bn] {BN_GRAD_LIBRARY_CALL} against K3's plain version: max rel "
        f"err {lib_rel:.3e} (the same two sums; timed, not used by the port)")
    L = largest
    log(f"[bn] largest {L['shape']} bf16: K2 {L['k2']:.5f} ms (plain "
        f"{L['p2']:.4f}, torch.var_mean {L['lib2']:.4f}, bound {L['b2']:.5f} "
        f"bytes), K3 {L['k3']:.5f} ms (plain {L['p3']:.4f}, "
        f"batch_norm_backward_reduce {L['lib3']:.4f}, bound {L['b3']:.5f} "
        f"bytes)")
    log(f"[bn] a step's 25 launches, bf16, summed device ms: K2 {tot['k2']:.5f} "
        f"(plain {tot['p2']:.4f}, torch.var_mean {tot['lib2']:.4f}, bound "
        f"{tot['b2']:.5f}), K3 {tot['k3']:.5f} (plain {tot['p3']:.4f}, "
        f"batch_norm_backward_reduce {tot['lib3']:.4f}, bound "
        f"{tot['b3']:.5f})")
    return {"max_rel": max_rel, "max_abs": max_abs, "total": tot,
            "largest": largest}


def train_config(kernels: bool):
    from keras_object_detection_torch.config import voc_full_config

    cfg = voc_full_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       bn_mode="fused" if kernels else "flax"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=kernels))


def synthetic_batch(batch: int, size: int, max_boxes: int, dev):
    """bench.py's synthetic batch: random pixels, two boxes per image."""
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, size=(batch, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((batch, max_boxes, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    boxes[:, 1] = [0.2, 0.25, 0.2, 0.3, 7.0]
    valid = np.zeros((batch, max_boxes), bool)
    valid[:, :2] = True
    return (torch.from_numpy(images).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(valid).to(dev))


def kernel_counts() -> dict:
    from keras_object_detection_torch.ops import bn, yolo_loss

    return {"bn_stats": bn.STATS_LAUNCHES,
            "bn_grad_stats": bn.GRAD_STATS_LAUNCHES,
            "yolo_loss_forward": yolo_loss.FORWARD_LAUNCHES,
            "yolo_loss_backward": yolo_loss.BACKWARD_LAUNCHES}


def reset_kernel_counts() -> None:
    from keras_object_detection_torch.ops import bn, yolo_loss

    bn.STATS_LAUNCHES = bn.GRAD_STATS_LAUNCHES = bn.DY_LAYOUT_COPIES = 0
    yolo_loss.FORWARD_LAUNCHES = yolo_loss.BACKWARD_LAUNCHES = 0


def tiny_train_config():
    """tiny_cpu_config cut to darknet_micro @56 (C=3), both kernel switches
    on, SGD. SGD makes the update linear in the gradient (adam's first
    update is lr * sign(g)); darknet_micro because darknet_tiny @224 at a
    random init is ill-conditioned: a 1e-6 relative change of its weights
    moves some of its SGD updates by more than 1e-2 on the CPU alone, where
    darknet_micro's move by less than 1e-3
    (tests/test_torch_train.py::test_step_conditioning)."""
    from keras_object_detection_torch.config import tiny_cpu_config

    cfg = tiny_cpu_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, backbone="darknet_micro",
                                       image_size=56, bn_mode="fused"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=True,
                                  optimizer="sgd"))


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.float(), b.float()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-30)).item()


def zero_gradient(name: str) -> bool:
    """A conv bias feeds a training-mode BatchNorm, which removes it: its
    gradient is zero up to rounding, so it is left out of comparisons."""
    return name.endswith("conv.bias")


@contextlib.contextmanager
def routing(record: list, replay: bool = False):
    """Inside the block, ReLU, LeakyReLU and max pooling append their
    routing to ``record`` (which elements pass; which element of each
    window wins) or, with ``replay``, follow the routing recorded there,
    in the same order. A forward on another device then sends its gradient
    through the same elements, so that a near-tie its rounding breaks the
    other way cannot move a gradient to a neighbouring element."""
    import torch.nn.functional as F

    pool = F.max_pool2d
    recorded = iter(record)

    def mask(x):
        if replay:
            return next(recorded).to(x.device)
        record.append(x > 0)
        return record[-1]

    def relu(x, inplace=False):
        return torch.where(mask(x), x, torch.zeros_like(x))

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(mask(x), x, x * negative_slope)

    def max_pool2d(x, kernel_size, stride=None, *args, **kwargs):
        if replay:
            idx = next(recorded).to(x.device)
        else:
            idx = pool(x, kernel_size, stride, *args, return_indices=True)[1]
            record.append(idx)
        n, c = idx.shape[:2]
        out = x.reshape(n, c, -1).gather(2, idx.reshape(n, c, -1))
        return out.reshape(idx.shape).contiguous(memory_format=torch.channels_last)

    with unittest.mock.patch.multiple(F, relu=relu, leaky_relu=leaky_relu,
                                      max_pool2d=max_pool2d):
        yield record


def routing_differences(a: list, b: list) -> tuple:
    """(decisions that differ, decisions) between two recorded routings."""
    differ = sum(int((x.cpu() != y.cpu()).sum()) for x, y in zip(a, b))
    return differ, sum(x.numel() for x in a)


def phase_train_check(dev) -> None:
    """The small model's step on the GPU (kernels) against the CPU (plain
    versions), stage by stage, to find where the two first part."""
    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data.augment import (augment_batch,
                                                           sample_augment_draws)
    from keras_object_detection_torch.ops.yolo_loss import fused_yolo_v1_loss
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.train.loop import step_generator

    cfg = tiny_train_config()
    g, d, t = cfg.grid, cfg.data, cfg.train
    images, boxes, valid = synthetic_batch(4, 56, 8, "cpu")
    failed = []

    def check(what: str, err: float, tol: float) -> None:
        log(f"[train-check] {what}: {err:.3e} (tolerance {tol:g})")
        if not err <= tol:
            failed.append(what)

    # 1. augmentation of the same images from the same draws
    draws = sample_augment_draws(4, step_generator(11, 0), tuple(d.color_jitter),
                                 tuple(d.crop_scale), tuple(d.crop_ratio))
    kw = dict(hflip_prob=d.hflip_prob, color_strengths=tuple(d.color_jitter),
              crop_ratio=tuple(d.crop_ratio), min_visibility=d.min_visibility,
              out_size=56)
    c_img, c_box, c_valid = augment_batch(images, boxes, valid, draws, **kw)
    g_img, g_box, g_valid = (x.cpu() for x in augment_batch(
        images.to(dev), boxes.to(dev), valid.to(dev), draws.to(dev), **kw))
    check("augment, images max abs err", (g_img - c_img).abs().max().item(), 1e-4)
    check("augment, boxes max abs err", (g_box - c_box).abs().max().item(), 1e-4)
    check("augment, valid masks differ", float(not torch.equal(g_valid, c_valid)),
          0)
    # 2. the grid of the same boxes
    y_true = encode_grid(c_box, c_valid, g.num_classes, g.num_boxes, g.grid)
    g_true = encode_grid(c_box.to(dev), c_valid.to(dev), g.num_classes,
                         g.num_boxes, g.grid).cpu()
    check("encode_grid, max abs err", (g_true - y_true).abs().max().item(), 0)

    # 3. forward, loss and backward from identical images and y_true, the
    # GPU following the CPU's ReLU and max-pool routing
    res, cpu_route, gpu_route = {}, [], []
    for name, where, route, replay in (
            ("gpu own routing", dev, gpu_route, False),
            ("cpu", "cpu", cpu_route, False), ("gpu", dev, cpu_route, True)):
        state = create_train_state(cfg, torch.Generator().manual_seed(2), where)
        reset_kernel_counts()
        with routing(route, replay):
            y_pred = state.model(c_img.to(where))
        loss = fused_yolo_v1_loss(y_true.to(where), y_pred, g.num_classes,
                                  g.num_boxes, t.lambda_coord, t.lambda_noobj,
                                  t.noobj_mode)
        loss.backward()
        sd = state.model.state_dict()
        res[name] = (loss.item(), y_pred.detach().cpu(),
                     {k: p.grad.cpu() for k, p in state.model.named_parameters()},
                     {k: v.cpu() for k, v in sd.items() if "running" in k},
                     kernel_counts())
    (c_loss, c_pred, c_grad, c_stats, _), (g_loss, g_pred, g_grad, g_stats,
                                            counts) = res["cpu"], res["gpu"]
    differ, decisions = routing_differences(gpu_route, cpu_route)
    own = max(rel_norm(res["gpu own routing"][2][k], c_grad[k]) for k in c_grad
              if not zero_gradient(k))
    log(f"[train-check] forward/backward on identical inputs: kernel launches "
        f"{counts} (5 BatchNorms, one loss); the GPU's own ReLU and max-pool "
        f"routing differs from the CPU's at {differ} of {decisions} decisions "
        f"(near-ties), so the GPU follows the CPU's; on its own routing its "
        f"worst gradient would part by {own:.3e} in norm")
    if list(counts.values()) != [5, 5, 1, 1]:
        failed.append("launch counts")
    check("identical inputs, loss rel err", abs(g_loss - c_loss) / abs(c_loss),
          1e-4)
    check("identical inputs, y_pred max abs err / max |y_pred|",
          ((g_pred - c_pred).abs().max() / c_pred.abs().max()).item(), 1e-4)
    worst = max((rel_norm(g_grad[k], c_grad[k]), k) for k in c_grad
                if not zero_gradient(k))
    check(f"identical inputs, gradients, worst tensor's rel err in norm "
          f"({worst[1]})", worst[0], 1e-4)
    check("identical inputs, running stats max rel err",
          max(((g_stats[k] - c_stats[k]).abs() / (c_stats[k].abs() + 1.0))
              .max().item() for k in c_stats), 1e-4)

    # 4. the whole step, augmentation included
    step = make_train_step(cfg)
    gpu = create_train_state(cfg, torch.Generator().manual_seed(2))
    cpu = create_train_state(cfg, torch.Generator().manual_seed(2), "cpu")
    before = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    gpu, m_gpu = step(gpu, images, boxes, valid, 11)
    cpu, m_cpu = step(cpu, images, boxes, valid, 11)
    torch.cuda.synchronize()
    loss_gpu, loss_cpu = m_gpu["total"].item(), m_cpu["total"].item()
    check(f"whole step, loss {loss_gpu:.6f} vs {loss_cpu:.6f}, rel err",
          abs(loss_gpu - loss_cpu) / abs(loss_cpu), 1e-4)
    g_sd = gpu.model.state_dict()
    check("whole step, running stats max rel err",
          max(((g_sd[k].cpu() - v).abs() / (v.abs() + 1.0)).max().item()
              for k, v in cpu.model.state_dict().items() if "running" in k), 1e-4)
    worst = max((rel_norm(g_sd[k].cpu() - before[k], v - before[k]), k)
                for k, v in cpu.model.state_dict().items()
                if "running" not in k and not zero_gradient(k))
    # the crop windows' exp and sqrt round to another last bit on the two
    # devices, which moves the augmented pixels by up to ~1e-5 (stage 1); at
    # a max-pool window whose two largest inputs lie that close, the two
    # devices then pick different ones and the window's whole gradient lands
    # on a neighbouring pixel: a jump of the update that stage 3, from
    # identical inputs, does not see
    check(f"whole step, parameter updates, worst tensor's rel err in norm "
          f"({worst[1]}; a max-pool tie can flip, see the source)", worst[0],
          1e-2)
    if failed:
        raise SystemExit("the GPU train step disagrees with the CPU step: "
                         + "; ".join(failed))


def time_steps(state, step, batch, seed: int) -> tuple:
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed ones, each ended by a
    synchronize. Returns (host ms per timed step, metrics of the last,
    kernel launch counts of the timed steps)."""
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, *batch, seed)
    torch.cuda.synchronize()
    reset_kernel_counts()  # the main path: counts at 0 just before
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, metrics, kernel_counts()  # ... read just after


def phase_train(dev, profile_dir) -> dict:
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    out = {}
    for kernels in (True, False):
        name = "kernels" if kernels else "plain"
        cfg = train_config(kernels)
        torch.cuda.reset_peak_memory_stats(dev)
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        n_values = sum(v.numel() for v in state.model.state_dict().values())
        if n_values != 69_681_758:
            raise SystemExit("the flagship model is not at full width")
        b = cfg.data.batch_size
        batch = synthetic_batch(b, cfg.model.image_size,
                                cfg.data.max_boxes_per_image, dev)
        step = make_train_step(cfg)
        times, metrics, counts = time_steps(state, step, batch, seed=1)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        p50 = float(np.median(times))
        loss = metrics["total"].item()
        log(f"[train] {name}: voc_full_config {cfg.model.backbone} "
            f"{cfg.model.image_size}² batch {b} {cfg.train.optimizer}, "
            f"use_pallas_loss={cfg.train.use_pallas_loss} "
            f"bn_mode={cfg.model.bn_mode}, {n_values} values")
        log(f"[train] {name}: step p50 {p50:.3f} ms (min {min(times):.3f}, "
            f"max {max(times):.3f}), {b / p50 * 1e3:.1f} images/s, peak device "
            f"memory {peak:.3f} GiB, loss {loss:.4f}")
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        log(f"[train] {name}: kernel launches over {TRAIN_STEPS} steps "
            f"{counts}, dy layout copies {bn.DY_LAYOUT_COPIES} "
            f"(of {counts['bn_grad_stats']} K3 launches)")
        want = ({"bn_stats": 25, "bn_grad_stats": 25, "yolo_loss_forward": 1,
                 "yolo_loss_backward": 1} if kernels else
                dict.fromkeys(per_step, 0))
        if per_step != want:
            raise SystemExit(f"{name} path launched {per_step} per step, "
                             f"expected {want}")
        if not np.isfinite(loss):
            raise SystemExit(f"non-finite loss on the {name} path")
        out[name] = {"p50_ms": p50, "images_per_s": b / p50 * 1e3,
                     "peak_gib": peak, "loss": loss, "counts": counts,
                     "dy_copies": bn.DY_LAYOUT_COPIES}
        if kernels and profile_dir:
            profile_train(state, step, batch, profile_dir)
        del state, step, batch
        torch.cuda.empty_cache()

    out["compare"] = compare_paths(dev)
    return out


def first_step(kernels: bool, dev, dtype: str = "bfloat16",
               reverse: bool = False) -> tuple:
    """One flagship step of one path from seeded weights and draws: (loss,
    the BN running statistics flattened, each parameter's gradient but the
    conv biases'). ``reverse`` runs the batch, and each image's draws with
    it, in reverse order, which changes only the order of the step's sums."""
    from keras_object_detection_torch.data.augment import (AugmentDraws,
                                                           sample_augment_draws)
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.train.loop import step_generator

    cfg = train_config(kernels)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=dtype))
    d = cfg.data
    state = create_train_state(cfg, torch.Generator().manual_seed(3))
    images, boxes, valid = synthetic_batch(d.batch_size, cfg.model.image_size,
                                           d.max_boxes_per_image, dev)
    draws = sample_augment_draws(d.batch_size, step_generator(5, 0),
                                 tuple(d.color_jitter), tuple(d.crop_scale),
                                 tuple(d.crop_ratio))
    if reverse:
        images, boxes, valid = images.flip(0), boxes.flip(0), valid.flip(0)
        draws = dataclasses.replace(draws, **{
            f.name: getattr(draws, f.name).flip(0)
            for f in dataclasses.fields(AugmentDraws) if f.name != "order"})
    state, metrics = make_train_step(cfg)(state, images, boxes, valid, 5,
                                          draws=draws)
    out = (metrics["total"].item(),
           torch.cat([v.reshape(-1) for k, v in state.model.state_dict().items()
                      if "running" in k]),
           {k: p.grad for k, p in state.model.named_parameters()
            if not zero_gradient(k)})
    del state
    torch.cuda.empty_cache()
    return out


def compare_paths(dev) -> dict:
    """One flagship step of the kernel path and of the plain path from the
    same weights and draws: loss, running statistics and every parameter's
    gradient. bf16 rounding makes the early layers' gradients of this
    network at a random init nearly independent of their float32 values, on
    either path, so the yardstick of the gradients is the float32 step (the
    plain path with ``compute_dtype="float32"``): the kernel path must be
    about as close to it as the plain path is."""
    runs = {"kernels": first_step(True, dev), "plain": first_step(False, dev),
            "float32": first_step(False, dev, "float32")}
    (k_loss, k_stats, k_grad), (p_loss, p_stats, p_grad), (f_loss, _, f_grad) = (
        runs["kernels"], runs["plain"], runs["float32"])
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    stat_err = ((k_stats - p_stats).abs() / (p_stats.abs() + 1e-2)).max().item()
    log(f"[train] one step from the same state and draws: loss kernels "
        f"{k_loss:.5f} vs plain {p_loss:.5f} (rel {loss_rel:.3e}, tolerance "
        f"2e-2; float32 {f_loss:.5f}), running stats max rel err "
        f"{stat_err:.3e} (tolerance 1e-2: bf16 activations, the two paths' "
        f"sums round differently)")
    # per tensor, each bf16 path's distance from the float32 gradient
    rows = [(k, rel_norm(k_grad[k], f_grad[k]), rel_norm(p_grad[k], f_grad[k]))
            for k in f_grad]
    bad = [k for k, kf, pf in rows if kf > 1.25 * pf + 0.02]
    ratio = max(kf / pf for _, kf, pf in rows)
    flat = [torch.cat([g[k].reshape(-1) for k in f_grad])
            for g in (k_grad, p_grad, f_grad)]
    log(f"[train] gradients, rel err in norm from the float32 step, kernels "
        f"(plain): all {rel_norm(flat[0], flat[2]):.3e} "
        f"({rel_norm(flat[1], flat[2]):.3e}); "
        + ", ".join(f"{k} {kf:.3e} ({pf:.3e})" for k, kf, pf in
                    [rows[0], *rows[-4:]])
        + f"; kernels vs plain {rel_norm(flat[0], flat[1]):.3e}; largest "
        f"ratio over {len(rows)} tensors {ratio:.3f} (limit per tensor: "
        f"1.25x the plain path's distance + 0.02)")
    if not (loss_rel <= 2e-2 and stat_err <= 1e-2 and not bad):
        raise SystemExit(f"the kernel path's step disagrees with the plain "
                         f"path's: loss {loss_rel:.3e}, stats {stat_err:.3e}, "
                         f"gradients {bad}")
    return {"loss_rel": loss_rel, "stats_rel": stat_err, "grad_ratio": ratio}


def profile_train(state, step, batch, profile_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, *batch, 1)
        torch.cuda.synchronize()
    trace = os.path.join(profile_dir, "train_b64.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(profile_dir, "train_b64.txt"), "w") as f:
        f.write(table)
    log(table)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default="",
                        help="write torch.profiler traces of batch-32 serving "
                        "and of 3 flagship train steps here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import keras_object_detection_torch  # noqa: F401  fails outside the repo

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    nms = phase_nms(dev)
    phase_check(dev)
    serve = phase_serve(dev, args.profile)
    loss = phase_loss(dev)
    bn = phase_bn(dev)
    phase_train_check(dev)
    train = phase_train(dev, args.profile)
    k_ms, call_ms, p_ms, bound, bound_by = nms["timing"][(32, 49)]
    k512, _, p512, b512, _ = nms["timing"][(8, 512)]
    counts = train["kernels"]["counts"]
    no_library = ("no single PyTorch call computes this function")
    kernels = [{
        "name": "nms", "route": "cuda",
        "source": "keras_object_detection_torch/ops/csrc/nms.cu",
        "replaces": "keras_object_detection_tpu/ops/pallas_nms.py:81",
        "tpu": "ops/pallas_nms.py:_nms_kernel", "checked": True,
        "launches": serve["launches"], "max_abs_err": nms["max_abs_err"],
        "shape": [32, 49, 6], "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "ms_8x512": k512, "plain_ms_8x512": p512, "bound_ms_8x512": b512,
    }]
    for name, key, line in (("yolo_loss_forward", "forward", 107),
                            ("yolo_loss_backward", "backward", 149)):
        lk, lcall, lp, lb, lby = loss["timing"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "keras_object_detection_torch/ops/csrc/yolo_loss.cu",
            "replaces": f"keras_object_detection_tpu/ops/pallas_loss.py:{line}",
            "checked": True, "launches": counts[name],
            "max_abs_err": loss[f"{key}_err"], "shape": [3136, 30],
            "ms": lk, "call_ms": lcall, "plain_ms": lp, "bound_ms": lb,
            "bound_by": lby, "library_ms": None, "library_note": no_library})
    tot, big = bn["total"], bn["largest"]
    for name, key, line, k, p, b_, lib, call in (
            ("bn_stats", "stats", 66, "k2", "p2", "b2", "lib2",
             "torch.var_mean(x, dim=(0, 2, 3), correction=0)"),
            ("bn_grad_stats", "grad", 81, "k3", "p3", "b3", "lib3",
             BN_GRAD_LIBRARY_CALL)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "keras_object_detection_torch/ops/csrc/bn_stats.cu",
            "replaces": f"keras_object_detection_tpu/ops/pallas_bn.py:{line}",
            "checked": True, "launches": counts[name],
            "max_abs_err": bn["max_abs"][key], "max_rel_err": bn["max_rel"][key],
            "shape": "the step's 25 BatchNorm inputs, bf16, batch 64",
            "ms": tot[k], "plain_ms": tot[p], "bound_ms": tot[b_],
            "bound_by": "bytes", "library_ms": tot[lib], "library_call": call,
            "largest_shape": big["shape"], "ms_largest": big[k],
            "plain_ms_largest": big[p], "bound_ms_largest": big[b_],
            "library_ms_largest": big[lib]})
    log(f"[train] kernels path p50 {train['kernels']['p50_ms']:.3f} ms, "
        f"{train['kernels']['images_per_s']:.1f} images/s; plain path p50 "
        f"{train['plain']['p50_ms']:.3f} ms, "
        f"{train['plain']['images_per_s']:.1f} images/s")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
