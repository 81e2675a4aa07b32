#!/usr/bin/env python3
"""Drive the PyTorch port (keras_object_detection_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also a torch.profiler trace in DIR

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. build   - compile ops/csrc/nms.cu with nvcc for sm_90a;
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
             memory and a per-stage breakdown.

Then one JSON line describing each kernel, one line with the card's name and
power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Float32 results are compared with TF32 off
(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores

NMS_SHAPES = [(1, 49), (32, 49), (32, 98), (4, 196), (8, 512), (2, 1024)]


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

    lib, seconds, output = _build.build("nms")
    log(f"[build] {lib.name}: {seconds:.2f} s")
    for line in output.splitlines():
        if "registers" in line or "spill" in line:
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default="",
                        help="write a torch.profiler trace of batch-32 serving here")
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
    k_ms, call_ms, p_ms, bound, bound_by = nms["timing"][(32, 49)]
    k512, _, p512, b512, _ = nms["timing"][(8, 512)]
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
