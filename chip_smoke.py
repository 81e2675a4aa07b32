#!/usr/bin/env python3
"""Drive the PyTorch port (keras_object_detection_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile DIR   # also torch.profiler traces in DIR
    python3 chip_smoke.py --parent DIR    # also time DIR's NMS, loss and
                                          # BN kernels (a checkout of another
                                          # commit)

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. build   - compile ops/csrc/{nms,yolo_loss,bn_stats,optim_update}.cu (and with
             --parent the other checkout's, where they differ) with nvcc
             for sm_90a, one nvcc each, all started together;
2. nms     - the NMS kernel (K1) against its plain PyTorch version on the
             card, bit-equal (torch.equal) on rows and masks on every case of
             NMS_CASES: the serving shapes, N = 63 ... 1024 around each
             cluster-size step, batch 64, one class, identical boxes,
             confidence ties (0.0 against -0.0 too), pairs whose IoU is
             exactly the threshold or one ulp off at 0.3, 0.5 and 0.7, all
             rows above and about two an image above the filter; CUDA-graph
             replay; the graph-node floor (one add on a 1-element tensor);
             device times and per-call times at 1x49, 32x49 (three
             densities), 8x512 and 2x1024, with --parent in turns with the
             other checkout's kernel (parent, new, new, parent); before
             and after those timings' CUDA graphs, 10 profiler traces of
             8 K1 calls at 32x512, each taken once, counting those that
             held no device event;
3. check   - the small CPU-runnable model on the GPU against the same model
             on the CPU (float32, TF32 off), to 1e-4;
4. serve   - the flagship voc_full_config (Darknet-24, 448², C=20, bf16)
             at full width with seeded random weights, answering batch-1
             and batch-32 requests through InferenceModel; the NMS launch
             count of those requests, predict() == the plain NMS of
             predict_decoded() on the card, p50 latency, images/s, peak
             memory and a per-stage breakdown;
5. loss    - the fused-loss kernels (forward K4, backward K5) against their
             plain versions at N = 1, 97, 3135, 3136, 3137 and 12544 rows of
             C20/B2, C5/B3 and hand-built tie and clip-bound rows (C3/B2),
             both noobj modes: K4 within 1e-6 relative and bit-equal from
             call to call, K5 bit-equal; offset (unaligned) rows; CUDA-graph
             replay; blocks (>= 132); times and bounds at the step's
             3136x30, with --parent in turns with the other checkout's
             kernels (parent, new, new, parent);
6. bn      - the BN-statistics kernels (K2, K3) against their plain versions
             at the shape of each BatchNorm at batch 64 of the flagship (25),
             of MobileNetV2 (52, the variants phase's test_model_config) and
             of the GAP dense head (the 2-D (64, 4960)), in bf16 and f32,
             and at odd shapes (2-D ones too), within 1e-5 relative and
             bit-equal from call to call; offset (unaligned) views; CUDA-graph
             replay; device times at every model shape, with --parent in
             turns with the other checkout's kernels (parent, new, new,
             parent), bounds, and beside them the one PyTorch call that
             computes each function (torch.var_mean for K2,
             torch.batch_norm_backward_reduce for K3), timed the same way
             (CUDA graph) and per call, summed over each model's shapes;
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
             rounding at a random init);
9. fit     - the training run at full width (voc_full_config, batch 64,
             kernels on) from a synthetic set written straight into the
             decoded-cache layout under build/fit_data/ (256 train, 96 val
             images, no decoder): Trainer.fit for 2 epochs with mAP every
             epoch, once from the host loader and once with the set held on
             the card; kernel launches of each run (K2 25, K3 25, K4 1, K5 1
             a train step, K1 2 a mAP update); finite val loss and mAP in
             [0, 1]; the two paths' first-epoch loss within compare_paths's
             2e-2; ground truth as prediction gives mAP 1 (up to the 1e-6
             epsilons) and the card's mAP equals the CPU's on the same
             grids; a restored checkpoint is bit-equal to the state saved
             and a resumed epoch puts the checkpoint axis at 0, 1, 2; the
             Evaluator on the best checkpoint reproduces its epoch's logged
             val loss and mAP; epoch wall, images/s, val images/s, mAP and
             checkpoint times; the final weights' loss on a val batch in
             eval mode beside the same weights' train-mode loss;
9b. learn  - the end-to-end learning run through the user's command,
             cli/run_synth_benchmark.py (build_config, bn_mode "fused" put
             in with dataclasses.replace, run): tools/make_synthetic_
             dataset.py writes 1000 train and 100 val images at 224²
             (seed 3) under build/learn_data/; darknet_tiny with the conv
             head, batch 32, adam at a constant 1e-3, EMA 0.999, the set on
             the card, the fused loss, LEARN_EPOCHS epochs, mAP from the
             second epoch every 10th and where the val loss improved, then
             the final and the best checkpoint's evaluation; deterministic
             cuDNN, so that a run repeats. The untrained state is evaluated
             first, then one step of it on the run's first batch, outside
             the counted run, holds K2-K5 to their plain versions at the
             run's shapes (K2 and K3 at each BatchNorm, K4 and K5 at 32x49
             rows). Checks: (i) the best val mAP >= 0.10
             and >= 0.10 above the untrained state's; (ii) the last epoch's
             train loss <= half the first's; (iii) the launches exact (K2
             and K3 once a BatchNorm a step, K4 and K5 once a step, K1
             twice a mAP update); (iv) the Evaluator on the restored best
             checkpoint gives its epoch's logged mAP (rel 1e-6), and K1's
             rows there equal the plain NMS of the same inputs; (v)
             cli/visualize_dataset.py's round trip of 16 val images
             through K1 gives back each image's labels (classes and
             count exact, boxes within 2^-22 of the labels and of the
             CPU's round trip), K1's rows equal to the plain NMS of the
             same rows on the card; the mAP curve, images/s and seconds;
10. variants - the v1 transfer family at full width (448², C=20, bf16,
             batch 64, nadam, both kernel switches on), each configuration
             voc_full_config with the model fields of VARIANTS replaced:
             VGG16 + conv head with the backbone frozen (the reference's
             recipe) and not frozen, test_model_config (MobileNetV2 + GAP
             dense head without BN), VGG16 + flatten_dense head (dropout
             on): 3 warm-up and 5 timed steps each, launches a step (K2 and
             K3 once per training BatchNorm: 1, 1, 52, 4; K4, K5 1), p50,
             images/s, peak memory, dy layout copies; the frozen VGG16
             tensors and their nadam moments bit-unchanged; then serving at
             batch 1 and 32 (K1 once a call, predict == the plain NMS);
11. recipe  - the v1 training recipe on the flagship's kernel path (batch
             64, mosaic 1.0, mixup 0.5, adamw with weight decay 5e-4): the
             step at each multiscale size of RECIPE_SIZES (S = 5 ... 9),
             p50, images/s, peak memory, launches a step (K2 25, K3 25, K4
             1, K5 1); at 320² and 576² every K2-K5 call of a step held
             against its plain version on the step's own inputs; remat off
             / full / dots at 448² (loss, running statistics and gradients
             bit-equal to off, K2 25 / 50 / 50 and K3 25 a step, p50, peak
             memory); box_loss_mode ciou on the plain
             loss (p50; the loss and its gradient on the step's grids
             against the CPU's to 1e-5), diou and alpha_iou finite; a
             2-epoch Trainer.fit from the device cache at two multiscale
             sizes with steps_per_dispatch 4 and 1, bit-equal with
             deterministic cuDNN, and their fit images/s; mosaic_batch and
             mixup_batch alone at batch 64, 448²; one JSON line "recipe";
12. yolov2  - the YOLOv2 anchor family at full width (yolov2_config:
             Darknet-19 with LeakyReLU + the passthrough anchor head, 416²,
             S=13, darknet's 5 VOC priors, C=20, bf16, batch 64, nadam,
             ignore threshold 0.6, IoU objectness, bn_mode fused): 3 warm-up
             and 5 timed steps, p50, images/s, peak memory, launches a step
             (K2 21, K3 21, K4 0, K5 0), a finite loss; the v2 loss with its
             ignore mask and IoU target on the step's grids, card against
             CPU, to 1e-5 (terms and gradient); K2/K3 at each of the step's
             21 BatchNorm inputs against their plain versions (1e-5),
             bit-equal from call to call, device time, bound and library
             call per shape; one step of the kernel and the plain path
             compared as compare_paths does; serving at batch 1 and 32
             (845 candidates an image cut to 512, K1 once a call, predict ==
             the plain NMS of the cut rows, p50 and per-stage ms, K1's time
             at 1x512 and 32x512); a 2-epoch Trainer.fit from a decoded
             cache at 416² (128 train, 64 val images; K1 2 a mAP update at
             N = 512, mAP in [0, 1], ground truth as prediction AP 1, the
             card's mAP = the CPU's); one step each at 320² and 608² (S = 10
             and 19, the passthrough fold at both ends); one JSON line
             "yolov2";
13. yolov3  - the YOLOv3 FPN family at full width (the port's
             yolov3_config: Darknet-53 + the 3-scale FPN head, 416², S =
             13 / 26 / 52, the paper's 9 priors, C=20, bf16, batch 32,
             adam, ignore threshold 0.5, IoU objectness; bn_mode fused), as
             phase 12 runs YOLOv2 (family_phase): 3 warm-up and 5 timed
             steps (K2 72, K3 72, K4 0, K5 0 a step), the v3 loss on the
             step's grids card against CPU (1e-5), K2/K3 at each of the 72
             BatchNorm inputs (1e-5, bit-equal call to call, device /
             bound / library ms), compare_paths, serving at batch 1 and 32
             (10,647 candidates an image cut to 512, K1 once a call, the
             stages decode / top_k / nms apart, K1 at 1x512 and 32x512), a
             2-epoch fit from a decoded cache at 416² (128 train, 64 val
             images; K1 2 a mAP update at N = 512), one step each at 320²
             and 608² (S = 10 / 20 / 40 and 19 / 38 / 76); one JSON line
             "yolov3";
14. serving_extras - soft (gaussian, linear) and fast NMS and the staged
             latency: YOLOv3 (phase 13's model, seeded weights and BatchNorm
             statistics) served at batch 1 and 32 in each nms_mode with the
             filter at the median confidence of the 10,647 -> 512 cut rows
             (no seeded confidence passes 0.4): K1 2 launches in the hard
             mode's 2 predict calls and 0 in the others', each predict equal
             to its mode's plain NMS of the cut rows on the CPU, p50; each
             mode on the card against the plain version on the CPU on those
             rows and on NMS_CASES' ties, identical boxes, signed zeros and
             IoU pairs at the threshold and one ulp off: keep sets, order,
             classes and boxes equal, decayed confidences within
             SOFT_NMS_RTOL (1e-5) relative (the card's exp and the CPU's part
             by an ulp); device ms and per-call p50 of each mode beside K1's
             at 1x512 and 32x512; the flagship's benchmark_latency staged
             against fused at batch 1 (same keys, same rows); one JSON line
             "serving_extras";
15. int8   - Int8InferenceModel at full width: the flagship and YOLOv3 at
             batch 1 and 32, YOLOv2 (passthrough, leaky) at batch 1, seeded
             weights and BatchNorm statistics, the filter at the median
             confidence as in phase 14: K1 once and the int8 GEMM once an
             int8 conv per predict call; predict == the plain NMS of the cut
             predict_decoded; at every conv shape of the three plans the
             route's s32 accumulators (im2col + torch._int_mm) torch.equal to
             the plain float64 GEMM; predict_raw on the route bit-equal to
             the same model on the plain GEMM (deterministic cuDNN for the
             float32 final convs); p50 and stage device ms beside the float
             InferenceModel on the same weights, the grids' distance to
             float, memory_footprint; the flagship's heaviest int8 conv at
             batch 32 timed as the route, _int_mm alone, the plain GEMM and
             the bf16 cuDNN conv, beside its bound; on the flagship static
             calibration and bias correction on 8 images, QAT 2 steps at
             batch 4, select_serving_model("auto")'s choice (it must follow
             its own probe) and the weight-only QuantizedInferenceModel's
             p50; one JSON line "int8";
16. launches - CUDA launches per call of K1, K4, K5, K2 and K3 (1 each)
             and of the other checkout's, from a torch.profiler trace, after the
             train and fit phases so that no profiler hook slows them;
17. parallel - data parallelism (keras_object_detection_torch.parallel):
             (a) the flagship kernel-path step at batch 64 through the
             data-parallel path over a one-rank NCCL group, bit-equal to
             the one-device step (deterministic cuDNN) with no collective
             in it, its p50 and launches (K2/K3 25, K4/K5 1 a step), and one
             NCCL all-reduce of the step's float32 gradient bucket timed;
             (b) two ranks on the one card over gloo with CUDA tensors
             (started as `python -m chip_smoke --parallel-rank JOB`), a
             global batch of 64 (its brightness ramped down the rows), 32
             a rank: the float32 SGD step against the one process's (loss
             and running statistics to 1e-4; the parameters' updates in
             norm, the worst and the median within twice what the one
             process's step with its batch reversed parts from it, at
             least 2e-2 and 1e-4), rank 1's state equal to rank 0's, and
             the same comparison shown to catch three planted wrong
             reductions (K2's sums or K3's sums not all-reduced, the
             gradients averaged instead of summed); the bf16 kernel path's
             p50, launches a rank (K2/K3 25, K4/K5 1 a step), all-reduces
             and their bytes, the gradient all-reduce's time; over NCCL too
             where there are two cards; (c) float and int8 serving of the
             flagship and YOLOv3 over the device mesh [cuda:0, cuda:0] at
             batch 16 (8 a shard, deterministic cuDNN): rows and masks
             torch.equal to one device serving each shard, K1 once a shard
             a predict call (the int8 GEMM once an int8 conv a shard); the
             int8 models also equal to one device serving all 16 (counts,
             classes, rows); the float models' distance to it (bf16 cuDNN
             may pick other algorithms at batch 16) reported, beside one
             device's own batch-8-against-16 distance with no mesh; p50 beside
             one device's; one JSON line "parallel";
18. tensor_parallel - tensor parallelism (parallel/tensor.py), four gloo
             ranks on the one card started once (`python -m chip_smoke
             --tp-rank JOB`, files under build/tensor_parallel/): (a) on
             ranks 0 and 1, a (1 data, 2 model) mesh, the flagship's kernel
             path at full width (bf16, nadam, bn_mode fused, the fused
             loss, batch 64): JAX's 39 sharded leaves (13 kernels, 67,239,936
             values, and their moments), parameters and moments a rank
             (69,653,342 - 33,619,968) x 12 B, launches a rank a step (K2 25,
             K3 25, K4 1, K5 1), gathers and reductions and their bytes a
             step, p50 of 3 steps, the collectives' time in one instrumented
             step, peak memory, K2/K3 against their plain versions and at
             each of the step's shapes (the sharded blocks' (M, C / 2))
             device time beside the bound; (b) on all four, a (2, 2) mesh,
             the float32 SGD step on phase 17's ramped batch (32 rows a data
             rank) against the one process with phase 17's four limits, the
             four ranks' gathered states bit-equal, and four planted faults
             (TP_FAULTS) each caught; (c) float and int8 serving of the
             flagship and YOLOv3 over a (2, 2) device mesh of [cuda:0] x 4
             at batch 16: rows equal to the (2, 1) mesh's, K1 once a data
             shard a predict call; (d) the flagship's float32 serving
             function through torch.export (.pt2), loaded and run against
             the model's forward; (e) utils/profiling.trace of two flagship
             steps: op_breakdown's K2/K3/K4/K5 counts equal to the launch
             counters (50/50/2/2); (f) parallel/dryrun.py over 4 ranks (the
             flagship on (2, 2)); one JSON line "tensor_parallel".
19. surface - the public names the JAX package has beside the batched
             paths: YoloV1Loss() on the card at the flagship's (64, 7, 7, 30)
             grids, both noobj modes, against K4's total (1e-6 relative, as
             phase 5) and the CPU's (SURFACE_LOSS_RTOL), launching no
             kernel of the port; one image of 32x512 rows through soft
             (gaussian, linear) and fast NMS bit-equal to that row of the
             batched twins, and through K1 (auto_batched_non_max_suppression
             on boxes[None], exactly one launch) bit-equal to the plain
             one-image non_max_suppression; one JSON line "surface".
20. measure - the port's three measurement tools (cli/, files under
             build/measure/); the two that read traces run as child
             processes through their `python -m` entry points, as a user
             runs them (young processes: the profiler drops a trace's
             device events the more often the older its process, PERF.md
             §6 "fault 3.5"), each reporting its run's launches
             (port_kernel_launches): (a) train_step_breakdown of the
             flagship's kernel path at batch 64 with --scan 4 and of
             YOLOv3 (fused BatchNorm) at batch 32: the port's kernels a
             step by kernel name in the trace and in the counters,
             flagship K2/K3 25 and K4/K5 1 (the bare step and the chunk),
             YOLOv3 K2/K3 72 and K4/K5 0, device time at most the wall
             p50; (b) serving_device_time of random flagship weights at
             batch 1 and 32 and K1 alone at the tool's 32x512 boxes: every
             row's trace device time (none null), K1's launches counted;
             K1 alone bit-equal to the plain NMS and timed as a CUDA graph
             in this process; 10 traces of 8 K1 calls on those boxes,
             each taken once, first thing in a young child (`python -m
             chip_smoke --trace-loss OUT`): none may lose its device
             events, and none may keep fewer than K1's 8 (a trace cut
             short fails the phase as a lost one does); (c)
             tp_comm_analysis of the
             flagship (JAX's config) over dp8 and dp4 x tp2, 8 gloo ranks
             on the card: every rank of a data row issues the same
             collectives, one gradient bucket of 278,613,368 B (dp8) and
             144,133,496 B (dp4 x tp2), 39 sharded leaves, printed beside
             JAX's record (benchmarks/tp_comm_analysis.json, read as data);
             one JSON line "measure".
21. optim  - (after bn, before train-check) the multi-tensor optimizer
             update K6 (ops/csrc/optim_update.cu) at the flagship's 102 and
             YOLOv3's 294 parameter tensors (channels_last, random float32
             from numpy): each of the 5 optimizers 5 steps, the learning
             rate swapped after 2, through K6 and through the plain loop on
             the card, parameters and moments bit-equal (torch.equal), and
             the config's optimizer again with every tensor one float off a
             16-byte boundary (the scalar path); launches a step equal to
             optim_launch_plan's; each optimizer's device time (CUDA graph)
             and time a call against its bound (28, 12 or 20 bytes a value
             at 3.35 TB/s), the plain loop's time a call; traces of 2
             flagship train steps with K6 and with the loop patched in, in
             turns: under train.step.optimizer K6's launches and no copy or
             synchronisation; one JSON line "optim".

Then one JSON line describing each kernel (K1's launches add the hard-mode
serving of phase 14, the int8 serving of phase 15 and phase 20's serving
to phase 4's; launches_measure is phase 20's), one line
with the card's name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}. Float32 results are compared with TF32 off
(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import gzip
import json
import math
import os
import shutil
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

START = time.perf_counter()  # the script's clock, for phase measure's log

# H100 SXM published peaks (NVIDIA data sheet) for bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # dense bf16 on the tensor cores

KERNEL_SOURCES = ("nms", "yolo_loss", "bn_stats", "optim_update")
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


def density_rows(seed: int, b: int, n: int, candidates: int = 0) -> np.ndarray:
    """``nms_rows`` with every confidence above the 0.4 filter, or, with
    ``candidates``, that many rows an image above it (what a trained
    detector gives) and the rest in [0, 0.39)."""
    rows = nms_rows(seed, b, n)
    rng = np.random.RandomState(seed + 1)
    if not candidates:
        rows[..., 1] = rng.uniform(0.41, 1.0, (b, n))
        return rows
    conf = rng.uniform(0.0, 0.39, (b, n))
    pick = rng.rand(b, n).argsort(axis=1)[:, :candidates]
    np.put_along_axis(conf, pick, rng.uniform(0.5, 1.0, (b, candidates)), axis=1)
    rows[..., 1] = conf
    return rows


def iou_tie_pairs(thr: float, count: int = 2, seed: int = 0) -> np.ndarray:
    """(3 * count, 2, 4) pairs of [cx, cy, w, h] boxes whose quirk IoU, as
    the plain version computes it in float32, is exactly float32(thr) (the
    first ``count``), one ulp below it (the next ``count``) and one ulp above
    it (the last). Found by stepping the second box's centre through
    consecutive float32 values around the shift that gives thr."""
    from keras_object_detection_torch.core.boxes import iou_cxcywh

    t32 = np.float32(thr)
    targets = (t32, np.nextafter(t32, np.float32(-1)),
               np.nextafter(t32, np.float32(2)))
    found = [[] for _ in targets]
    rng = np.random.RandomState(seed)
    steps = np.arange(-4096, 4096)
    for _ in range(200):
        if all(len(f) >= count for f in found):
            break
        a = rng.uniform([0.3, 0.3, 0.1, 0.1], [0.7, 0.7, 0.4, 0.4]).astype(np.float32)
        # quirk corners (c -+ s) / 2 move by half a centre shift d, so
        # iou = (w - d/2) / (w + d/2) for boxes of one size
        shift = 2 * a[2] * (1 - thr) / (1 + thr)
        start = np.float32(a[0] + shift).view(np.int32)
        b = np.tile(a, (len(steps), 1))
        b[:, 0] = (start + steps).astype(np.int32).view(np.float32)
        iou = iou_cxcywh(torch.from_numpy(np.tile(a, (len(steps), 1))),
                         torch.from_numpy(b))[:, 0].numpy()
        for f, target in zip(found, targets):
            hit = np.flatnonzero(iou == target)
            if len(hit) and len(f) < count:
                f.append(np.stack([a, b[hit[len(hit) // 2]]]))
    if not all(len(f) >= count for f in found):
        raise RuntimeError(f"no IoU tie pairs found at {thr}")
    return np.stack([p for f in found for p in f[:count]])


def threshold_tie_rows(thr: float, count: int = 2, seed: int = 0) -> np.ndarray:
    """(2, 6 * count, 6) rows made of ``iou_tie_pairs``: each pair has a
    class of its own and both rows pass the 0.4 filter, so at threshold thr
    the lower-confidence row of a pair at or one ulp above thr is
    suppressed and one ulp below is kept. The second image swaps which box
    of each pair has the higher confidence."""
    pairs = iou_tie_pairs(thr, count, seed)
    images = []
    for swap in (False, True):
        rows = []
        for k, (a, b) in enumerate(pairs):
            first, second = (b, a) if swap else (a, b)
            rows.append([k, 0.9 - 0.01 * k, *first])
            rows.append([k, 0.6 - 0.01 * k, *second])
        images.append(rows)
    return np.asarray(images, np.float32)


def signed_zero_rows() -> np.ndarray:
    """(2, 16, 6) rows whose confidences tie, 0.0 against -0.0 among them:
    distinct boxes of two classes, so the order of tied rows shows in the
    output rows."""
    rows = nms_rows(210, 2, 16, num_classes=2)
    rows[..., 1] = np.float32([0.0, -0.0, 0.0, 0.7, -0.0, 0.7, 0.0, -0.0,
                               0.5, -0.0, 0.5, 0.0, 0.7, -0.0, 0.0, 0.5])
    return rows


def with_conf(rows: np.ndarray, conf) -> np.ndarray:
    rows[..., 1] = conf
    return rows


def below_rows(seed: int, b: int, n: int) -> np.ndarray:
    """Every confidence at or below the 0.4 filter: nothing survives."""
    rows = nms_rows(seed, b, n)
    return with_conf(rows, rows[..., 1] * 0.4)


def identical_rows(seed: int, b: int, n: int, tied: bool = False) -> np.ndarray:
    """One box of one class in every row: the first survives, every other
    candidate is suppressed."""
    rows = nms_rows(seed, b, n)
    rows[..., 0] = 3.0
    rows[..., 2:] = np.float32([0.5, 0.5, 0.3, 0.2])
    if tied:
        rows[..., 1] = 0.8
    return rows


NMS_SHAPES = [(1, 49), (32, 49), (32, 98), (4, 196), (8, 512), (2, 1024)]
NMS_SIZES = (63, 64, 65, 127, 511, 513, 1023, 1024)
NMS_TIE_THRESHOLDS = (0.3, 0.5, 0.7)
# name -> () -> (rows, iou_threshold, conf_threshold): every case the NMS
# kernel is held bit-equal to its plain version on
NMS_CASES = {
    **{f"{b}x{n}": (lambda b=b, n=n, s=100 + k: (nms_rows(s, b, n), 0.5, 0.4))
       for k, (b, n) in enumerate(NMS_SHAPES)},
    **{f"3x{n}": (lambda n=n: (nms_rows(500 + n, 3, n), 0.5, 0.4))
       for n in NMS_SIZES},
    "64x49": lambda: (nms_rows(401, 64, 49), 0.5, 0.4),
    "tied 4x49": lambda: (with_conf(nms_rows(200, 4, 49), 0.9), 0.5, 0.4),
    "below 4x98": lambda: (below_rows(201, 4, 98), 0.5, 0.4),
    "one class 4x196": lambda: (nms_rows(202, 4, 196, num_classes=1), 0.5, 0.4),
    "one class 2x1024": lambda: (nms_rows(203, 2, 1024, num_classes=1), 0.5, 0.4),
    "identical boxes 4x49": lambda: (identical_rows(204, 4, 49), 0.5, 0.4),
    "identical boxes, tied 2x1024": lambda: (identical_rows(205, 2, 1024, True),
                                             0.5, 0.4),
    "signed zeros": lambda: (signed_zero_rows(), 0.5, 0.4),
    "signed zeros as candidates": lambda: (signed_zero_rows(), 0.5, -0.5),
    **{f"iou tie {t}": (lambda t=t: (threshold_tie_rows(t), t, 0.4))
       for t in NMS_TIE_THRESHOLDS},
    "dense 32x49": lambda: (density_rows(301, 32, 49), 0.5, 0.4),
    "sparse 32x49": lambda: (density_rows(302, 32, 49, candidates=2), 0.5, 0.4),
}
# name -> rows of the timed shapes (the serving path's 1x49 and 32x49, the
# FPN family's 512-candidate sets, the cap), at two densities at 32x49
NMS_TIMED = {
    "1x49": lambda: nms_rows(300, 1, 49),
    "32x49": lambda: nms_rows(300, 32, 49),
    "8x512": lambda: nms_rows(300, 8, 512),
    "2x1024": lambda: nms_rows(300, 2, 1024),
    "dense 32x49": lambda: density_rows(301, 32, 49),
    "sparse 32x49": lambda: density_rows(302, 32, 49, candidates=2),
}


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


def nms_bound_ms(rows: torch.Tensor, n2_rank: bool = False) -> tuple:
    """Least time for NMS on these rows: bytes (rows in, rows and mask out)
    over the memory rate against float32 operations over the float32 rate.
    Operations: 3 per comparison of a sort (N log2 N per image; N^2 with
    ``n2_rank``, the count of a rank by counting), 17 per IoU of the
    same-class pairs this data has, 9 per row for its corners."""
    b, n, _ = rows.shape
    nbytes = b * n * 6 * 4 * 2 + b * n
    cls = rows[..., 0]
    same = (cls[:, :, None] == cls[:, None, :]).triu(1).sum().item()
    compares = n * n if n2_rank else n * max(1, math.ceil(math.log2(n)))
    ops = b * (3 * compares + 9 * n) + 17 * same
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(parent: str = "") -> None:
    """Every kernel source of this tree, and with ``parent`` the NMS, loss
    and BN-statistics sources of that checkout, one nvcc each, all started
    together."""
    import pathlib

    from keras_object_detection_torch.ops import _build

    jobs = [(name, _build.CSRC) for name in KERNEL_SOURCES]
    if parent:
        csrc = pathlib.Path(parent) / "keras_object_detection_torch" / "ops" / "csrc"
        # a source the parent shares with this tree builds once
        jobs += [(name, csrc) for name in KERNEL_SOURCES
                 if (csrc / f"{name}.cu").exists()
                 and (csrc / f"{name}.cu").read_bytes()
                 != (_build.CSRC / f"{name}.cu").read_bytes()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: _build.build(*job), jobs))
    for lib, seconds, output in built:
        log(f"[build] {lib.name}: {seconds:.2f} s")
        for line in output.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")


def nms_graph_replays(cuda_nms, x: torch.Tensor) -> bool:
    """Three kernel calls captured in one CUDA graph give the eager result
    bit for bit on each of two replays."""
    want = cuda_nms.cuda_batched_non_max_suppression(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cuda_nms.cuda_batched_non_max_suppression(x) for _ in range(3)]
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(r, want[0]) and torch.equal(v, want[1])
                            for r, v in outs)
    return same


def node_floor_ms() -> float:
    """Device milliseconds of the smallest graph node: one in-place add on
    a 1-element tensor, replayed as ``graph_ms`` replays a kernel."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(1.0))


def trace_loss(boxes: torch.Tensor, traces: int) -> dict:
    """``traces`` back-to-back ``profiling.trace``s of 8 K1 calls on
    ``boxes``, each taken once: how many held no device event at all
    (lost), and how many held some but not K1's 8 (partial)."""
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.utils import profiling

    def run():
        cuda_nms.cuda_batched_non_max_suppression(boxes, 0.5, 0.25)

    lost = partial = 0
    for _ in range(traces):
        events, seen, counted, _ = profiling.checked_trace(run, 8, tries=1)
        if profiling.trace_contents(events)["device_events"] == 0:
            lost += 1
        elif seen != counted:
            partial += 1
    return {"traces": traces, "lost": lost, "partial": partial}


def phase_nms(dev, parent: str = "") -> dict:
    """The NMS kernel against its plain version on every case of NMS_CASES;
    graph replay; the graph-node floor; then times at every shape of
    NMS_TIMED, beside the parent tree's kernel where ``parent`` names
    one."""
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    max_err = 0.0
    for name, make in NMS_CASES.items():
        rows, iou, conf = make()
        x = torch.from_numpy(rows).to(dev)
        got_rows, got_valid = cuda_nms.cuda_batched_non_max_suppression(x, iou, conf)
        want_rows, want_valid = batched_non_max_suppression(x, iou, conf)
        torch.cuda.synchronize()
        equal = (torch.equal(got_rows, want_rows)
                 and torch.equal(got_valid, want_valid))
        err = (got_rows - want_rows).abs().max().item()
        max_err = max(max_err, err)
        log(f"[nms] {name} (iou {iou}, conf {conf}): bit-equal={equal} "
            f"kept={int(got_valid.sum())} max_abs_err={err}")
        if not equal:
            raise SystemExit(f"NMS kernel disagrees with the plain version at {name}")
    for name in ("32x49", "8x512", "2x1024"):
        x = torch.from_numpy(NMS_TIMED[name]()).to(dev)
        replayed = nms_graph_replays(cuda_nms, x)
        log(f"[nms] {name}: a CUDA graph of 3 calls replays to the eager "
            f"result bit for bit: {replayed}")
        if not replayed:
            raise SystemExit(f"the NMS kernel differs under graph replay at {name}")
    floor = node_floor_ms()
    log(f"[nms] graph-node floor (one add on a 1-element tensor, replayed): "
        f"{floor:.5f} ms")

    # the profiler's record of K1 alone on serving_device_time's 32 x 512
    # boxes, before and after the timing below captures cluster launches
    # (8x512, 2x1024) in CUDA graphs; phase measure repeats it late in the
    # process
    from keras_object_detection_torch.cli.serving_device_time import \
        draw_inputs
    boxes = torch.from_numpy(draw_inputs(MEASURE_SERVING["batches"], 448,
                                         20)[1]).to(dev)
    losses = {"before_graphs": trace_loss(boxes, TRACE_LOSS_TRACES)}
    modules = {"new": cuda_nms}
    if parent:
        modules["parent"] = parent_module(parent, "cuda_nms", "nms")
    timing, calls = {}, {}
    for name, make in NMS_TIMED.items():
        x = torch.from_numpy(make()).to(dev)
        b, n, _ = x.shape
        fns = {tag: (lambda m=m: m.cuda_batched_non_max_suppression(x))
               for tag, m in modules.items()}
        if name == "32x49":
            calls = fns
        # in turns: parent, new, new, parent (new alone without a parent)
        runs = {tag: [] for tag in modules}
        for tag in ["parent", "new", "new", "parent"] if parent else ["new"]:
            runs[tag].append((graph_ms(fns[tag]), float(np.median(
                [cuda_ms(fns[tag], 200) for _ in range(5)]))))
        p_ms = cuda_ms(lambda: batched_non_max_suppression(x), 3, warmup=1)
        bound, bound_by = nms_bound_ms(x)
        bound_n2, _ = nms_bound_ms(x, n2_rank=True)
        shape = cuda_nms.kernel_shape(n)
        t = {tag: {"ms": float(np.mean([r[0] for r in rs])),
                   "call_ms": float(np.mean([r[1] for r in rs])), "runs": rs}
             for tag, rs in runs.items()}
        t.update(plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                 bound_ms_n2_rank=bound_n2,
                 grid=b * shape["cluster"], **shape)
        timing[name] = t
        for tag, rs in runs.items():
            log(f"[nms] {name}, {tag} kernel: " + "; ".join(
                f"{k:.5f} ms on the device ({c:.5f} per call with launch)"
                for k, c in rs))
        log(f"[nms] {name}: {t['grid']} CTAs in clusters of {shape['cluster']}, "
            f"{shape['threads']} threads, {shape['smem_bytes']} B shared; plain "
            f"{p_ms:.3f} ms, bound {bound:.3e} ms ({bound_by}; {bound_n2:.3e} "
            f"counting N^2 rank compares)")
    losses["after_graphs"] = trace_loss(boxes, TRACE_LOSS_TRACES)
    log(f"[nms] traces of 8 K1 calls at 32x512, each taken once, that held "
        f"no device event (lost) or not K1's 8 (partial): "
        f"{json.dumps(losses)}")
    return {"max_abs_err": max_err, "timing": timing, "floor_ms": floor,
            "calls": calls, "trace_loss": losses}


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
    """Device milliseconds of each serving stage at this batch: forward,
    the model's decode (decode_grid, or decode_anchor_grid for the anchor
    head), the top-k cut where the candidates exceed max_candidates, NMS."""
    from keras_object_detection_torch.ops.cuda_nms import \
        cuda_batched_non_max_suppression
    from keras_object_detection_torch.ops.nms import top_k_candidates

    e = model.config.eval
    with torch.inference_mode():
        raw = model.predict_raw(images)
        decoded = model.predict_decoded(images)
        out = {"forward": cuda_ms(lambda: model.predict_raw(images), 10),
               "decode": cuda_ms(lambda: model._decode(raw), 50)}
        if e.max_candidates and decoded.shape[1] > e.max_candidates:
            out["top_k"] = cuda_ms(lambda: top_k_candidates(
                decoded, e.max_candidates), 50)
            decoded = top_k_candidates(decoded, e.max_candidates)
        out["nms"] = cuda_ms(lambda: cuda_batched_non_max_suppression(
            decoded, e.iou_threshold, e.conf_threshold), 50)
        return out


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


LOSS_SIZES = (1, 97, 3135, 3136, 3137, 12544)
LOSS_KINDS = ("C20 B2", "C5 B3", "ties C3 B2")


def loss_case(kind: str, n: int):
    """(t, p, C, B): ``n`` rows of one of LOSS_KINDS. The tie rows of
    ``tie_rows`` (C + 5B = 13, an odd width) repeat to fill ``n``."""
    if kind == "ties C3 B2":
        t, p = tie_rows()
        reps = -(-n // len(t))
        return np.tile(t, (reps, 1))[:n], np.tile(p, (reps, 1))[:n], 3, 2
    c, b = {"C20 B2": (20, 2), "C5 B3": (5, 3)}[kind]
    return (*loss_rows(n + 10 * b, n, c, b), c, b)


def cuda_launches(fn, tries: int = 3) -> list:
    """Names of the kernels that one call of ``fn`` runs on the device,
    from a torch.profiler trace (the kernels of a ctypes library too).
    Every ``fn`` here launches at least one kernel, so a trace without any
    device event has lost its events; it is taken again. A process whose
    traces keep losing them (seen in long pytest runs) counts the kernel
    nodes of a captured CUDA graph instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
        log("[profile] a trace recorded no device event; taking it again")
    count = graph_kernel_launches(fn)
    log(f"[profile] no device event in {tries} traces; a captured CUDA graph "
        f"of one call holds {count} kernel nodes")
    return [f"kernel node {k} of a captured graph" for k in range(count)]


def graph_kernel_launches(fn) -> int:
    """Kernel launches of one call of ``fn``, without the profiler: the
    kernel nodes of a CUDA graph that captures the call, read by libcuda."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)):
        raise SystemExit("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)):
        raise SystemExit("cuGraphGetNodes failed")
    kind = ctypes.c_int(-1)
    kernels = 0
    for node in nodes:
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise SystemExit("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def parent_module(parent: str, module: str, library: str):
    """``ops/<module>.py`` of another checkout at ``parent`` (the parent
    commit's tree), with its kernels built from that checkout's
    ``csrc/<library>.cu``, to time beside this tree's."""
    import ctypes
    import importlib.util
    import pathlib

    from keras_object_detection_torch.ops import _build

    ops = pathlib.Path(parent) / "keras_object_detection_torch" / "ops"
    lib_path, _, _ = _build.build(library, ops / "csrc")
    spec = importlib.util.spec_from_file_location(f"parent_{module}",
                                                  ops / f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with unittest.mock.patch.object(_build, "load_library",
                                    lambda name: ctypes.CDLL(str(lib_path))):
        mod._library()  # cached with its own argtypes
    return mod


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


def offset_view(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` one element into a fresh (aligned) buffer,
    so that its data pointer is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view_as(x)
    view.copy_(x)
    return view


def loss_graph_replays(yl, t, p, g, c: int, b: int) -> bool:
    """Three forward and backward calls captured in one CUDA graph give the
    eager results bit for bit on each of two replays (the forward's ticket
    counter is back at 0 after every launch)."""
    want = (yl.cuda_yolo_v1_loss_forward(t, p, c, b),
            yl.cuda_yolo_v1_loss_backward(t, p, g, c, b))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [(yl.cuda_yolo_v1_loss_forward(t, p, c, b),
                 yl.cuda_yolo_v1_loss_backward(t, p, g, c, b)) for _ in range(3)]
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(f, want[0]) and torch.equal(d, want[1])
                            for f, d in outs)
    return same


def phase_loss(dev, parent: str = "") -> dict:
    """The loss kernels against their plain versions at every size of
    LOSS_SIZES and kind of LOSS_KINDS, both noobj modes; then their blocks,
    CUDA launches per call, graph replay and times at the step's 3136x30,
    beside the parent tree's kernels where ``parent`` names one."""
    from keras_object_detection_torch.ops import yolo_loss as yl

    g = torch.tensor(0.75, device=dev)
    fwd_err = bwd_err = fwd_rel = 0.0
    for kind in LOSS_KINDS:
        for n in LOSS_SIZES:
            t_np, p_np, c, b = loss_case(kind, n)
            t, p = torch.from_numpy(t_np).to(dev), torch.from_numpy(p_np).to(dev)
            for mode in ("selected", "all"):
                got = yl.cuda_yolo_v1_loss_forward(t, p, c, b, noobj_mode=mode)
                again = yl.cuda_yolo_v1_loss_forward(t, p, c, b, noobj_mode=mode)
                want = yl.yolo_v1_loss_forward_plain(t, p, c, b, noobj_mode=mode)
                dp = yl.cuda_yolo_v1_loss_backward(t, p, g, c, b, noobj_mode=mode)
                want_dp = yl.yolo_v1_loss_backward_plain(t, p, g, c, b,
                                                         noobj_mode=mode)
                torch.cuda.synchronize()
                rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
                fwd_rel = max(fwd_rel, rel)
                fwd_err = max(fwd_err, (got - want).abs().max().item())
                bwd_err = max(bwd_err, (dp - want_dp).abs().max().item())
                if rel > 1e-6:
                    raise SystemExit(f"loss forward kernel disagrees at {kind} "
                                     f"N={n} {mode}: rel err {rel:.3e}")
                if not torch.equal(got, again):
                    raise SystemExit(f"loss forward kernel differs from run to "
                                     f"run at {kind} N={n} {mode}")
                if not torch.equal(dp, want_dp):
                    raise SystemExit(f"loss backward kernel is not bit-equal to "
                                     f"its plain version at {kind} N={n} {mode}")
    log(f"[loss] {len(LOSS_KINDS)} kinds x N in {LOSS_SIZES} x 2 noobj modes: "
        f"forward within {fwd_rel:.3e} relative of the plain sums and bit-equal "
        f"from call to call, backward bit-equal (torch.equal) to its plain "
        f"version")

    # offset views (the kernels' unaligned copy path) give the same bits
    t_np, p_np, c, b = loss_case("C20 B2", 3137)
    t, p = torch.from_numpy(t_np).to(dev), torch.from_numpy(p_np).to(dev)
    ts, ps = offset_view(t), offset_view(p)
    same = (torch.equal(yl.cuda_yolo_v1_loss_forward(ts, ps, c, b),
                        yl.cuda_yolo_v1_loss_forward(t, p, c, b))
            and torch.equal(yl.cuda_yolo_v1_loss_backward(ts, ps, g, c, b),
                            yl.cuda_yolo_v1_loss_backward(t, p, g, c, b)))
    log(f"[loss] rows at data_ptr % 16 == {ts.data_ptr() % 16}: the same bits "
        f"as aligned rows: {same}")
    if not same or ts.data_ptr() % 16 == 0:
        raise SystemExit("the loss kernels' unaligned path gives other bits")

    for n in (97, 3136, 12544):
        t_np, p_np, c, b = loss_case("C20 B2", n)
        t, p = torch.from_numpy(t_np).to(dev), torch.from_numpy(p_np).to(dev)
        replayed = loss_graph_replays(yl, t, p, g, c, b)
        log(f"[loss] N={n}: a CUDA graph of 3 forward + backward calls replays "
            f"to the eager results bit for bit: {replayed}")
        if not replayed:
            raise SystemExit(f"the loss kernels differ under graph replay at N={n}")

    n = 64 * 49
    t, p = (torch.from_numpy(x).to(dev) for x in loss_rows(3, n, 20, 2))
    modules = {"new": yl}
    if parent:
        modules["parent"] = parent_module(parent, "yolo_loss", "yolo_loss")
    calls = {tag: {"forward": lambda m=m: m.cuda_yolo_v1_loss_forward(t, p, 20, 2),
                   "backward": lambda m=m: m.cuda_yolo_v1_loss_backward(
                       t, p, g, 20, 2)}
             for tag, m in modules.items()}
    timing = {}
    for name, backward in (("forward", False), ("backward", True)):
        blocks = yl.kernel_blocks(n, backward)
        log(f"[loss] {name} at {n}x30: {blocks} blocks ({n / blocks:g} rows "
            f"each)")
        if blocks < 132:
            raise SystemExit(f"the loss {name} kernel runs {blocks} blocks, "
                             f"fewer than the H100's 132 SMs")
        # in turns: parent, new, new, parent (new alone without a parent)
        order = ["parent", "new", "new", "parent"] if parent else ["new"]
        runs = {tag: [] for tag in modules}
        for tag in order:
            fn = calls[tag][name]
            # per call: the median of 5 runs of 200, the host being shared
            runs[tag].append((graph_ms(fn), float(np.median(
                [cuda_ms(fn, 200) for _ in range(5)]))))
        p_ms = cuda_ms((lambda: yl.yolo_v1_loss_backward_plain(t, p, g, 20, 2))
                       if backward else
                       (lambda: yl.yolo_v1_loss_forward_plain(t, p, 20, 2)), 20)
        bound, bound_by = loss_bound_ms(n, 20, 2, backward)
        timing[name] = {
            tag: {"ms": float(np.mean([r[0] for r in rs])),
                  "call_ms": float(np.mean([r[1] for r in rs])),
                  "runs": rs}
            for tag, rs in runs.items()}
        timing[name].update(plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                            blocks=blocks)
        for tag, rs in runs.items():
            log(f"[loss] {name} at {n}x30, {tag} kernels: "
                + "; ".join(f"{k:.5f} ms on the device ({c_:.5f} per call with "
                            f"launch)" for k, c_ in rs))
        log(f"[loss] {name}: plain {p_ms:.4f} ms, bound {bound:.3e} ms "
            f"({bound_by}); no single PyTorch call computes this loss, so no "
            f"library time")
    return {"forward_err": fwd_err, "backward_err": bwd_err, "timing": timing,
            "calls": calls}


def phase_launches(loss: dict, nms: dict, bn: dict) -> None:
    """CUDA launches per call of K1 (at 32x49), K4, K5, and K2 and K3 at
    BN_LAUNCH_SHAPES (and of the parent's), from a profiler trace, into
    ``nms``, ``loss["timing"]`` and ``bn["cuda_launches"]``.
    It runs after the train phase: a profiler run leaves tracing hooks that
    may slow later launches, and the step is timed without them."""
    launched = {tag: cuda_launches(fn) for tag, fn in nms["calls"].items()}
    log("[nms] CUDA launches per call at 32x49: " + ", ".join(
        f"{tag} {len(v)} {v}" for tag, v in launched.items()))
    if len(launched["new"]) != 1:
        raise SystemExit(f"the NMS kernel takes {len(launched['new'])} CUDA "
                         f"launches a call, not 1")
    nms["cuda_launches"] = {tag: len(v) for tag, v in launched.items()}
    for name in ("forward", "backward"):
        launched = {tag: cuda_launches(fns[name])
                    for tag, fns in loss["calls"].items()}
        log(f"[loss] {name}: CUDA launches per call: " + ", ".join(
            f"{tag} {len(v)} {v}" for tag, v in launched.items()))
        if len(launched["new"]) != 1:
            raise SystemExit(f"the loss {name} kernel takes "
                             f"{len(launched['new'])} CUDA launches a call, not 1")
        for tag, v in launched.items():
            loss["timing"][name][tag]["cuda_launches"] = len(v)
    bn["cuda_launches"] = {}
    for shape, fns in bn["calls"].items():
        for k in ("k2", "k3"):
            launched = {tag: cuda_launches(f[k]) for tag, f in fns.items()}
            log(f"[bn] {k.upper()} at {shape}: CUDA launches per call: "
                + ", ".join(f"{tag} {len(v)} {v}" for tag, v in launched.items()))
            if len(launched["new"]) != 1:
                raise SystemExit(f"the BN kernel {k.upper()} takes "
                                 f"{len(launched['new'])} CUDA launches a call "
                                 f"at {shape}, not 1")
            for tag, v in launched.items():
                bn["cuda_launches"].setdefault(k, {}).setdefault(tag, len(v))


def bn_shapes(dev, cfg=None, batch: int = 64) -> list:
    """The input shape, at ``batch``, of each BatchNorm of ``cfg``'s model
    (default: voc_full_config, the flagship's 25), in forward order: (N, C,
    H, W), or (N, C) for a Dense output's."""
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.models.layers import BatchNorm

    cfg = cfg or voc_full_config()
    model = build_model(cfg, torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((batch,) + tuple(inp[0].shape[1:])))
        for m in model.modules() if isinstance(m, BatchNorm)]
    size = cfg.model.image_size
    with torch.inference_mode():
        model(torch.zeros(1, size, size, 3, device=dev))
    for h in hooks:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return shapes


def bn_bound_ms(shape, itemsize: int, grad: bool) -> tuple:
    """Least time of one BN-statistics launch: its inputs read once (x; dy
    and x for the gradient statistics) and the (2, C) sums written, against
    3 (5) float32 operations per element."""
    c = shape[1]
    elems = math.prod(shape)
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


BN_ODD_SHAPES = [(5, 32, 13, 11), (3, 24, 7, 7), (7, 24, 9, 5), (5, 7), (3, 4960),
                 (9, 20)]


def bn_groups(dev) -> dict:
    """name -> the BatchNorm input shapes, at batch 64, of a model whose
    BatchNorms the kernels serve: the flagship's 25, MobileNetV2's 52 (the
    variants phase's test_model_config) and the GAP dense head's 2-D one."""
    groups = {"flagship": bn_shapes(dev),
              "mobilenetv2": bn_shapes(dev, variant_config(**VARIANTS["test_model"])),
              "gap_dense_2d": bn_shapes(dev, variant_config(
                  backbone="vgg16", head="gap_dense"))}
    want = {"flagship": 25, "mobilenetv2": 52, "gap_dense_2d": 1}
    if {k: len(v) for k, v in groups.items()} != want:
        raise SystemExit(f"BatchNorm counts {groups} differ from {want}")
    if groups["gap_dense_2d"] != [(64, 4960)]:
        raise SystemExit(f"the GAP head's BatchNorm input is "
                         f"{groups['gap_dense_2d']}, not (64, 4960)")
    return groups


def kernel_layout_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the BN kernels' layout: channels_last for NCHW, contiguous
    for (M, C)."""
    if t.dim() == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def bn_inputs(shape, dtype, gen, dev):
    """x (scaled and shifted normal) and dy (normal) of ``shape`` in the BN
    kernels' layout, and the mean and rstd (eps 1e-3) of x from its plain
    sums."""
    from keras_object_detection_torch.ops import bn

    x = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
    dy = torch.randn(shape, generator=gen, device=dev)
    x = kernel_layout_tensor(x.to(dtype))
    dy = kernel_layout_tensor(dy.to(dtype))
    m = x.numel() // shape[1]
    sums = bn.bn_stats_sums_plain(x)
    mean = sums[0] / m
    rstd = torch.rsqrt(torch.clamp_min(sums[1] / m - mean * mean, 0.0) + 1e-3)
    return x, dy, mean, rstd


def bn_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest difference relative to each sum's largest channel (at least
    1): float32 sums in another order."""
    scale = want.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    return ((got - want).abs() / scale).max().item()


def bn_offset_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the BN kernels' layout, one element into a fresh buffer, so
    that its data pointer is not 16-byte aligned."""
    if x.dim() == 2:
        return offset_view(x)
    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    view.copy_(x)
    return view


def bn_graph_replays(bn, x, dy, mean, rstd) -> bool:
    """Three K2 and K3 calls captured in one CUDA graph give the eager sums
    bit for bit on each of two replays (the ticket counters are back at 0
    after every launch)."""
    want = (bn.cuda_bn_stats_sums(x), bn.cuda_bn_grad_sums(dy, x, mean, rstd))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [(bn.cuda_bn_stats_sums(x), bn.cuda_bn_grad_sums(dy, x, mean, rstd))
                for _ in range(3)]
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(s, want[0]) and torch.equal(g, want[1])
                            for s, g in outs)
    return same


BN_REPLAY_SHAPES = [(64, 1024, 7, 7), (64, 1280, 14, 14), (64, 4960),
                    (64, 64, 28, 28), (5, 32, 13, 11)]
BN_LAUNCH_SHAPES = [(64, 1024, 7, 7), (64, 4960)]


def phase_bn(dev, parent: str = "") -> dict:
    """K2 and K3 against their plain versions at every model shape of
    ``bn_groups`` and BN_ODD_SHAPES, bf16 and f32, bit-equal from call to
    call; offset (unaligned) views; CUDA-graph replay; then at every model
    shape in bf16 the device time of each kernel (with ``parent`` in turns
    with the other checkout's: parent, new, new, parent), its bound, its
    plain version's and the library call's (device time and per call)."""
    from keras_object_detection_torch.ops import bn

    groups = bn_groups(dev)
    for name, shapes in groups.items():
        log(f"[bn] {name}: {len(shapes)} BatchNorm inputs at batch 64: "
            + ", ".join("x".join(map(str, sh[1:])) for sh in shapes))
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    max_rel = {"stats": 0.0, "grad": 0.0}
    max_abs = {"stats": 0.0, "grad": 0.0}
    cases = [(name, sh) for name, shapes in groups.items() for sh in shapes]
    cases += [("odd", sh) for sh in BN_ODD_SHAPES]
    for group, shape in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x, dy, mean, rstd = bn_inputs(shape, dtype, gen, dev)
            got = bn.cuda_bn_stats_sums(x)
            got_g = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
            again = bn.cuda_bn_stats_sums(x)
            again_g = bn.cuda_bn_grad_sums(dy, x, mean, rstd)
            want = bn.bn_stats_sums_plain(x)
            want_g = bn.bn_grad_sums_plain(dy, x, mean, rstd)
            torch.cuda.synchronize()
            for key, a, w in (("stats", got, want), ("grad", got_g, want_g)):
                rel = bn_rel_err(a, w)
                max_rel[key] = max(max_rel[key], rel)
                max_abs[key] = max(max_abs[key], (a - w).abs().max().item())
                if rel > 1e-5:
                    raise SystemExit(f"BN {key} kernel disagrees at {shape} "
                                     f"{dtype}: {rel:.3e}")
            if not (torch.equal(got, again) and torch.equal(got_g, again_g)):
                raise SystemExit(f"BN kernels differ from call to call at "
                                 f"{shape} {dtype}")
    log(f"[bn] kernels vs plain over {len(cases)} shapes ({', '.join(f'{k} {len(v)}' for k, v in groups.items())}, "
        f"odd {len(BN_ODD_SHAPES)}), bf16 and f32: stats max rel err "
        f"{max_rel['stats']:.3e} (max abs {max_abs['stats']:.3e}), grad stats "
        f"max rel err {max_rel['grad']:.3e} (max abs {max_abs['grad']:.3e}); "
        f"relative to each sum's largest channel, float32 sums in another "
        f"order; bit-equal from call to call")

    # offset views take the V = 1 path; graph replay wraps the counters
    for shape in BN_REPLAY_SHAPES:
        x, dy, mean, rstd = bn_inputs(shape, torch.bfloat16, gen, dev)
        xs, dys = bn_offset_view(x), bn_offset_view(dy)
        rel = max(bn_rel_err(bn.cuda_bn_stats_sums(xs), bn.bn_stats_sums_plain(x)),
                  bn_rel_err(bn.cuda_bn_grad_sums(dys, xs, mean, rstd),
                             bn.bn_grad_sums_plain(dy, x, mean, rstd)))
        replayed = bn_graph_replays(bn, x, dy, mean, rstd)
        log(f"[bn] {shape} bf16: offset views (data_ptr % 16 == "
            f"{xs.data_ptr() % 16}) within {rel:.3e} of the plain sums; a CUDA "
            f"graph of 3 K2 + K3 calls replays bit for bit twice: {replayed}")
        if rel > 1e-5 or xs.data_ptr() % 16 == 0:
            raise SystemExit(f"the BN kernels' unaligned path disagrees at {shape}")
        if not replayed:
            raise SystemExit(f"the BN kernels differ under graph replay at {shape}")

    modules = {"new": bn}
    if parent:
        modules["parent"] = parent_module(parent, "bn", "bn_stats")
    order = ["parent", "new", "new", "parent"] if parent else ["new"]
    keys = ("k2", "k3", "p2", "p3", "b2", "b3", "lib2", "lib3", "lib2_call",
            "lib3_call") + (("k2_parent", "k3_parent") if parent else ())
    tot = {name: dict.fromkeys(keys, 0.0) for name in groups}
    worst = {name: {"k2": (0.0, None), "k3": (0.0, None)} for name in groups}
    largest, per_shape = {}, []
    lib_rel = 0.0
    calls, call_ms = {}, {}
    for group, shapes in groups.items():
        for shape in shapes:
            x, dy, mean, rstd = bn_inputs(shape, torch.bfloat16, gen, dev)
            fns = {tag: {"k2": lambda m=m, x=x: m.cuda_bn_stats_sums(x),
                         "k3": lambda m=m, a=(dy, x, mean, rstd):
                             m.cuda_bn_grad_sums(*a)}
                   for tag, m in modules.items()}
            per_call = shape in BN_LAUNCH_SHAPES and shape not in calls
            if per_call:
                calls[shape] = fns
            runs = {(tag, k): [] for tag in modules for k in ("k2", "k3")}
            for tag in order:
                for k in ("k2", "k3"):
                    runs[tag, k].append(graph_ms(fns[tag][k], reps=20, replays=5))
                    if per_call:  # with the host's launch: the median of 5 runs of 200
                        call_ms.setdefault(shape, {}).setdefault(tag, {}).setdefault(
                            k, []).append(float(np.median(
                                [cuda_ms(fns[tag][k], 200) for _ in range(5)])))
            row = {k: float(np.mean(runs["new", k])) for k in ("k2", "k3")}
            if parent:
                for k in ("k2", "k3"):
                    row[f"{k}_parent"] = float(np.mean(runs["parent", k]))
                    ratio = row[k] / row[f"{k}_parent"]
                    if ratio > worst[group][k][0]:
                        worst[group][k] = (ratio, list(shape))
            dims = (0, 2, 3) if x.dim() == 4 else 0
            ones = torch.ones(shape[1], device=dev)
            # the library call takes (N, C, ...) inputs; a 2-D one as (N, C, 1, 1)
            x4, dy4 = ((x, dy) if x.dim() == 4 else
                       (x[..., None, None], dy[..., None, None]))
            lib2 = lambda: torch.var_mean(x, dim=dims, correction=0)
            lib3 = lambda: bn_grad_library(dy4, x4, mean, rstd, ones)
            row.update(
                p2=cuda_ms(lambda: bn.bn_stats_sums_plain(x), 5, warmup=1),
                p3=cuda_ms(lambda: bn.bn_grad_sums_plain(dy, x, mean, rstd), 5,
                           warmup=1),
                lib2=graph_ms(lib2, reps=20, replays=5),
                lib3=graph_ms(lib3, reps=20, replays=5),
                lib2_call=cuda_ms(lib2, 5, warmup=1),
                lib3_call=cuda_ms(lib3, 5, warmup=1),
                b2=bn_bound_ms(shape, 2, False)[0],
                b3=bn_bound_ms(shape, 2, True)[0])
            # the library call computes K3's function: its sums against plain
            lib_rel = max(lib_rel, bn_rel_err(torch.stack(lib3()),
                                              bn.bn_grad_sums_plain(dy, x, mean, rstd)))
            for key, v in row.items():
                tot[group][key] += v
            per_shape.append(dict(row, group=group, shape=list(shape)))
            if group not in largest or x.numel() > largest[group]["elems"]:
                largest[group] = dict(row, shape=list(shape), elems=x.numel())
            del x, dy, x4, dy4
    log(f"[bn] {BN_GRAD_LIBRARY_CALL} against K3's plain version: max rel "
        f"err {lib_rel:.3e} (the same two sums; timed, not used by the port)")
    for r in per_shape:
        plan = bn.bn_launch_plan(math.prod(r["shape"]) // r["shape"][1],
                                 r["shape"][1], 2, sms)
        log(f"[bn] {r['group']} {'x'.join(map(str, r['shape']))} bf16, grid "
            f"{plan.grid[0]}x{plan.grid[1]} of {plan.block[0]}x{plan.block[1]}: "
            f"K2 {r['k2']:.5f} ms"
            + (f" (parent {r['k2_parent']:.5f})" if parent else "")
            + f", K3 {r['k3']:.5f}"
            + (f" (parent {r['k3_parent']:.5f})" if parent else "")
            + f"; bound {r['b2']:.5f} / {r['b3']:.5f}; var_mean {r['lib2']:.5f} "
            f"device ({r['lib2_call']:.4f} per call), backward_reduce "
            f"{r['lib3']:.5f} ({r['lib3_call']:.4f})")
    for shape, tags in call_ms.items():
        log(f"[bn] {shape} bf16, per call with the host's launch (ms): " + "; ".join(
            f"{tag} K2 {', '.join(f'{v:.5f}' for v in ks['k2'])}, K3 "
            f"{', '.join(f'{v:.5f}' for v in ks['k3'])}" for tag, ks in tags.items()))
    for group, t in tot.items():
        log(f"[bn] {group}: a step's {len(groups[group])} launches, bf16, "
            f"summed device ms: K2 {t['k2']:.5f}"
            + (f" (parent {t['k2_parent']:.5f})" if parent else "")
            + f", {t['b2'] / t['k2']:.1%} of its bound {t['b2']:.5f} (plain "
            f"{t['p2']:.4f}, torch.var_mean {t['lib2']:.5f} device, "
            f"{t['lib2_call']:.4f} per call); K3 {t['k3']:.5f}"
            + (f" (parent {t['k3_parent']:.5f})" if parent else "")
            + f", {t['b3'] / t['k3']:.1%} of its bound {t['b3']:.5f} (plain "
            f"{t['p3']:.4f}, batch_norm_backward_reduce {t['lib3']:.5f} device, "
            f"{t['lib3_call']:.4f} per call)")
        if parent:
            log(f"[bn] {group}: worst shape new / parent: K2 "
                f"{worst[group]['k2'][0]:.3f} at {worst[group]['k2'][1]}, K3 "
                f"{worst[group]['k3'][0]:.3f} at {worst[group]['k3'][1]}")
    return {"max_rel": max_rel, "max_abs": max_abs, "total": tot,
            "largest": largest, "groups": groups, "worst": worst,
            "calls": calls, "call_ms": call_ms}


# K6's phase: the flagship's and YOLOv3's parameter lists as the train state
# holds them
OPTIM_MODELS = ("flagship", "yolov3")
OPTIM_STEPS, OPTIM_LR_SWAP = 5, 2  # steps; set_learning_rate after this many
OPTIM_WEIGHT_DECAY = 5e-4  # adamw's and sgdw's
OPTIM_CELL = {"flagship": "nadam", "yolov3": "adam"}  # the configs' optimizers
# bytes a value K6 must move: p and g read, the moments read and written, p
# written
OPTIM_BYTES = {"adam": 28, "nadam": 28, "adamw": 28, "sgd": 12, "sgdw": 20}


def optim_shapes(tag: str) -> list:
    """The parameter shapes of the flagship's or YOLOv3's model, in order."""
    from keras_object_detection_torch.models import build_model

    cfg = train_config(True) if tag == "flagship" else yolov3_config(True)
    with torch.device("meta"):
        return [tuple(p.shape) for p in build_model(cfg, None).parameters()]


def optim_params(shapes, dev, seed: int, offset: bool = False) -> list:
    """Random float32 parameters of ``shapes`` (numpy, ``seed``) on ``dev``,
    4-D ones in ``channels_last`` memory as ``create_train_state`` puts
    them; ``offset``: each a view one float into a buffer of its own, so
    that no tensor starts 16-byte aligned (K6's scalar path)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        host = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        if offset:
            buf = torch.empty(host.numel() + 1, device=dev)
            out.append(buf[1:].view(shape).copy_(host))
        elif len(shape) == 4:
            out.append(host.to(dev, memory_format=torch.channels_last))
        else:
            out.append(host.to(dev))
    return out


def optim_grads(params, seed: int, steps: int) -> list:
    """``steps`` lists of random float32 gradients (numpy, ``seed``), each
    tensor at a scale of 1e-4, 1 or 30, laid out as its parameter (a
    one-float offset view where the parameter is one)."""
    rng = np.random.default_rng(seed)
    total = sum(p.numel() for p in params)
    out = []
    for _ in range(steps):
        flat = torch.from_numpy(rng.standard_normal(total, dtype=np.float32)
                                ).to(params[0].device)
        scales = rng.choice([1e-4, 1.0, 30.0], len(params))
        grads, at = [], 0
        for p, scale in zip(params, scales):
            if p.data_ptr() % 16:
                g = torch.empty(p.numel() + 1, device=p.device)[1:].view(p.shape)
            else:
                g = torch.empty_like(p)
            g.copy_(flat[at:at + p.numel()].view(p.shape) * float(scale))
            grads.append(g)
            at += p.numel()
        out.append(grads)
    return out


def optim_compare(name: str, params, grads) -> dict:
    """``len(grads)`` steps of ``name`` through K6 (``apply_updates``) and
    through the plain loop (``apply_updates_plain``) on the card from
    copies of ``params`` (kept as they are laid out), the learning rate
    swapped after OPTIM_LR_SWAP: whether parameters and moments end
    bit-equal, and K6's launches a step."""
    from keras_object_detection_torch.ops import optim_update
    from keras_object_detection_torch.train import optim

    runs = {}
    for how, fn in (("kernel", optim.apply_updates),
                    ("plain", optim.apply_updates_plain)):
        ps = [torch.empty_like(p).copy_(p) if p.data_ptr() % 16 == 0 else
              torch.empty(p.numel() + 1, device=p.device)[1:].view(p.shape)
              .copy_(p) for p in params]
        state = optim.init_opt_state(name, ps, 1e-3, OPTIM_WEIGHT_DECAY)
        before = optim_update.LAUNCHES
        for i, g in enumerate(grads):
            if i == OPTIM_LR_SWAP:
                optim.set_learning_rate(state, 3e-4)
            fn(state, ps, g)
        torch.cuda.synchronize()
        runs[how] = (ps + state.mu + state.nu + state.trace, state.count,
                     optim_update.LAUNCHES - before)
    (k, k_count, launched), (p, p_count, _) = runs["kernel"], runs["plain"]
    return {"bit_equal": k_count == p_count and len(k) == len(p) and all(
                torch.equal(a, b) for a, b in zip(k, p)),
            "launches_per_step": launched / len(grads)}


def optim_trace_counts(events, span_name: str) -> dict:
    """What the host spans named ``span_name`` (their ``user_annotation``
    events) issued in a trace: synchronisations among their CUDA runtime
    calls, and the device work of those calls by their correlation ids:
    kernels, host-to-device copies, other copies."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == span_name]
    out = {"spans": len(spans), "span_ms": sum(b - a for a, b in spans) / 1e3,
           "sync": 0, "kernels": 0, "htod": 0, "other_copies": 0}
    issued = set()
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                and any(a <= e["ts"] <= b for a, b in spans)):
            out["sync"] += "Synchronize" in str(e.get("name", ""))
            issued.add(e.get("args", {}).get("correlation"))
    for e in events:
        if (e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy")
                or e.get("args", {}).get("correlation") not in issued):
            continue
        name = str(e.get("name", ""))
        key = ("kernels" if e["cat"] == "kernel" else "htod"
               if "HtoD" in name else "other_copies")
        out[key] += 1
    return out


def optim_step_trace(dev) -> dict:
    """Traces of 2 flagship train steps (batch 64, kernel path) with K6 and
    with the plain loop put in its place (``optim.apply_updates`` patched
    to ``apply_updates_plain``), in turns plain, K6, K6, plain: the
    runtime calls under ``train.step.optimizer`` (``optim_trace_counts``)."""
    import tempfile

    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step, optim)
    from keras_object_detection_torch.utils import profiling

    cfg = train_config(True)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    step = make_train_step(cfg)
    batch = synthetic_batch(cfg.data.batch_size, cfg.model.image_size,
                            cfg.data.max_boxes_per_image, dev)
    out = {}
    for how in ("plain", "kernel", "kernel_again", "plain_again"):
        patch = (unittest.mock.patch.object(optim, "apply_updates",
                                            optim.apply_updates_plain)
                 if how.startswith("plain") else contextlib.nullcontext())
        with patch:
            for _ in range(2):
                state, _m = step(state, *batch, 1)
            with tempfile.TemporaryDirectory() as td:
                with profiling.trace(td):
                    for _ in range(2):
                        state, _m = step(state, *batch, 1)
                out[how] = optim_trace_counts(profiling.traced_events(td),
                                              "train.step.optimizer")
    del state
    torch.cuda.empty_cache()
    return out


def optim_kernel_entries(optim: dict) -> list:
    """The kernels line's K6 entries, one a parameter list of phase
    optim's result."""
    entries = []
    for tag, row in optim["models"].items():
        name = OPTIM_CELL[tag]
        entries.append({
            "name": f"optim_update_{tag}", "route": "cuda",
            "source": "keras_object_detection_torch/ops/csrc/optim_update.cu",
            "replaces": None,
            "why": "the plain loop's 17-21 launches a parameter tensor",
            "checked": True, "bit_equal": row["bit_equal"],
            "bit_equal_unaligned": row["bit_equal_unaligned"],
            "shape": f"{row['tensors']} tensors, {row['values']} values",
            "optimizer": name, "launches_per_step": row["plan_launches"],
            "blocks": row["blocks"], "ms": row["ms"][name],
            "call_ms": row["call_ms"][name], "bound_ms": row["bound_ms"][name],
            "bound_by": "bytes", "plain_ms": row["plain_call_ms"],
            "library_ms": None,
            "library_note": "torch.optim's foreach and fused updates are "
                            "not optax's arithmetic",
            "ms_by_optimizer": row["ms"], "bound_ms_by_optimizer": row["bound_ms"],
            "step_trace": optim["step_trace"]})
    return entries


def phase_optim(dev) -> dict:
    """K6 (module docstring, phase 21)."""
    from keras_object_detection_torch.ops import optim_update
    from keras_object_detection_torch.train import optim

    t0 = time.perf_counter()
    out = {"card": card(), "models": {}}
    for tag in OPTIM_MODELS:
        shapes = optim_shapes(tag)
        sizes = tuple(math.prod(s) for s in shapes)
        plan = optim_update.optim_launch_plan(sizes)
        row = {"tensors": len(sizes), "values": sum(sizes),
               "plan_launches": len(plan),
               "blocks": sum(launch.chunk_start[-1] for launch in plan),
               "bit_equal": {}, "ms": {}, "call_ms": {}, "bound_ms": {}}
        params = optim_params(shapes, dev, 1)
        grads = optim_grads(params, 2, OPTIM_STEPS)
        for name in optim_update.OPT_CODES:
            res = optim_compare(name, params, grads)
            row["bit_equal"][name] = res["bit_equal"]
            if res["launches_per_step"] != len(plan):
                raise SystemExit(f"[optim] {tag} {name}: "
                                 f"{res['launches_per_step']} launches a step,"
                                 f" the plan's {len(plan)}")
        # the scalar path: every tensor one float off its buffer's start
        off = optim_params(shapes, dev, 3, offset=True)
        row["bit_equal_unaligned"] = optim_compare(
            OPTIM_CELL[tag], off, optim_grads(off, 4, 2))["bit_equal"]
        del off
        if not all(row["bit_equal"].values()) or not row["bit_equal_unaligned"]:
            raise SystemExit(f"[optim] {tag}: K6 differs from the plain loop: "
                             f"{row['bit_equal']}, unaligned "
                             f"{row['bit_equal_unaligned']}")
        g = grads[0]
        for name in optim_update.OPT_CODES:
            state = optim.init_opt_state(name, params, 1e-3, OPTIM_WEIGHT_DECAY)

            def one(state=state):
                optim.apply_updates(state, params, g)

            row["ms"][name] = graph_ms(one, reps=20, replays=5)
            row["call_ms"][name] = cuda_ms(one, reps=20)
            row["bound_ms"][name] = (OPTIM_BYTES[name] * row["values"]
                                     / HBM_BYTES_PER_S * 1e3)
        name = OPTIM_CELL[tag]
        state = optim.init_opt_state(name, params, 1e-3, OPTIM_WEIGHT_DECAY)
        row["plain_call_ms"] = cuda_ms(
            lambda: optim.apply_updates_plain(state, params, g), reps=5,
            warmup=2)
        del state, params, grads, g
        torch.cuda.empty_cache()
        log(f"[optim] {tag}: {row['tensors']} tensors, {row['values']} values,"
            f" {row['plan_launches']} launch(es) of {row['blocks']} blocks; "
            f"K6 = the plain loop bit for bit ({len(row['bit_equal'])} "
            f"optimizers x {OPTIM_STEPS} steps, lr swapped after "
            f"{OPTIM_LR_SWAP}; {name} unaligned); "
            + "; ".join(f"{n} {row['ms'][n]:.4f} ms device ("
                        f"{row['bound_ms'][n] / row['ms'][n]:.1%} of its bound "
                        f"{row['bound_ms'][n]:.4f}), {row['call_ms'][n]:.4f} "
                        f"a call" for n in optim_update.OPT_CODES)
            + f"; the plain loop's {name} {row['plain_call_ms']:.3f} ms a call")
        out["models"][tag] = row
    out["step_trace"] = optim_step_trace(dev)
    for how, c in out["step_trace"].items():
        log(f"[optim] 2 flagship steps, {how}: under train.step.optimizer "
            f"({c['spans']} spans, {c['span_ms']:.3f} ms traced) "
            f"{c['kernels']} kernels, {c['htod']} host-to-device and "
            f"{c['other_copies']} other copies, {c['sync']} synchronisations")
    want = 2 * out["models"]["flagship"]["plan_launches"]
    for how in ("kernel", "kernel_again"):
        c = out["step_trace"][how]
        if (c["spans"] != 2 or c["htod"] or c["other_copies"] or c["sync"]
                or c["kernels"] != want):
            raise SystemExit(f"[optim] K6's step, {how}: {c} under "
                             f"train.step.optimizer, expected {want} kernels"
                             f" and no copy or synchronisation")
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"optim": out}))
    return out


def train_config(kernels: bool):
    from keras_object_detection_torch.config import voc_full_config

    cfg = voc_full_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       bn_mode="fused" if kernels else "flax"),
        train=dataclasses.replace(cfg.train, use_pallas_loss=kernels))


# the variants phase's configurations: voc_full_config with these model
# fields replaced, as the JAX CLI builds them (448², S=7, B=2, C=20, bf16,
# nadam, both kernel switches on)
VARIANTS = {
    "vgg16_conv_frozen": dict(backbone="vgg16", head="conv",
                              freeze_backbone=True),
    "vgg16_conv": dict(backbone="vgg16", head="conv"),
    "test_model": dict(backbone="mobilenetv2", head="gap_dense",
                       head_dense_units=4096, head_batchnorm=False),
    "vgg16_flatten_dense": dict(backbone="vgg16", head="flatten_dense"),
}
# K2 / K3 launches a step: the BatchNorms that train (a frozen backbone's
# run in eval mode; VGG16 has none)
VARIANT_BN_LAUNCHES = {"vgg16_conv_frozen": 1, "vgg16_conv": 1,
                       "test_model": 52, "vgg16_flatten_dense": 4}
VARIANT_WARMUP, VARIANT_STEPS, VARIANT_BATCH = 3, 5, 64


def variant_config(**model):
    """train_config(kernels=True) with ``model``'s fields replaced."""
    cfg = train_config(True)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


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


def time_steps(state, step, batch, seed: int, warmup: int = TRAIN_WARMUP,
               steps: int = TRAIN_STEPS) -> tuple:
    """``warmup`` steps, then ``steps`` timed ones, each ended by a
    synchronize. Returns (host ms per timed step, metrics of the last,
    kernel launch counts of the timed steps)."""
    for _ in range(warmup):
        state, metrics = step(state, *batch, seed)
    torch.cuda.synchronize()
    reset_kernel_counts()  # the main path: counts at 0 just before
    times = []
    for _ in range(steps):
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
               reverse: bool = False, config=None) -> tuple:
    """One step of one path from seeded weights and draws: (loss, the BN
    running statistics flattened, each parameter's gradient but the conv
    biases'). ``config(kernels)`` gives the configuration (default
    ``train_config``, the flagship). ``reverse`` runs the batch, and each
    image's draws with it, in reverse order, which changes only the order
    of the step's sums."""
    from keras_object_detection_torch.data.augment import (AugmentDraws,
                                                           sample_augment_draws)
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.train.loop import step_generator

    cfg = (config or train_config)(kernels)
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


def compare_paths(dev, config=None, tag: str = "train") -> dict:
    """One step of the kernel path and of the plain path from the same
    weights and draws (``config``: as ``first_step``'s, default the
    flagship): loss, running statistics and every parameter's gradient.
    bf16 rounding makes the early layers' gradients of this network at a
    random init nearly independent of their float32 values, on either path,
    so the yardstick of the gradients is the float32 step (the plain path
    with ``compute_dtype="float32"``): the kernel path must be about as
    close to it as the plain path is."""
    runs = {"kernels": first_step(True, dev, config=config),
            "plain": first_step(False, dev, config=config),
            "float32": first_step(False, dev, "float32", config=config)}
    (k_loss, k_stats, k_grad), (p_loss, p_stats, p_grad), (f_loss, _, f_grad) = (
        runs["kernels"], runs["plain"], runs["float32"])
    loss_rel = abs(k_loss - p_loss) / abs(p_loss)
    stat_err = ((k_stats - p_stats).abs() / (p_stats.abs() + 1e-2)).max().item()
    log(f"[{tag}] one step from the same state and draws: loss kernels "
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
    log(f"[{tag}] gradients, rel err in norm from the float32 step, kernels "
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


FIT_TRAIN, FIT_VAL, FIT_EPOCHS = 256, 96, 2
FIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "fit_data")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def fit_split(split: str, n: int, seed: int, size: int = 448,
              max_boxes: int = 64, num_classes: int = 20) -> tuple:
    """A synthetic split written straight into the decoded-cache layout
    (data/disk_cache.py): ``n`` empty ``.jpg`` files, made first so that
    their modification times enter the cache's key, then random pixels and
    1-4 boxes an image. Returns (directory, cache directory)."""
    from keras_object_detection_torch.data import disk_cache

    data = os.path.join(FIT_DIR, split)
    cache = os.path.join(FIT_DIR, f"{split}_cache")
    shutil.rmtree(data, ignore_errors=True)
    shutil.rmtree(cache, ignore_errors=True)
    os.makedirs(data)
    paths = [os.path.join(data, f"{i:04d}.jpg") for i in range(n)]
    for p in paths:
        open(p, "wb").close()
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, size, size, 3), dtype=np.uint8)
    boxes = np.zeros((n, max_boxes, 5), np.float32)
    valid = np.zeros((n, max_boxes), bool)
    for i in range(n):
        k = rng.randint(1, 5)
        boxes[i, :k, :2] = rng.uniform(0.1, 0.9, (k, 2))
        boxes[i, :k, 2:4] = rng.uniform(0.05, 0.5, (k, 2))
        boxes[i, :k, 4] = rng.randint(0, num_classes, k)
        valid[i, :k] = True
    disk_cache.write(cache, paths, size, max_boxes, zip(images, boxes, valid))
    return data, cache


def fit_config(run: str, device_cache: bool = False, base=None):
    """``base`` (default train_config(kernels=True)) for a training run: mAP
    every epoch, the padded val batch masked, checkpoints and logs under
    build/fit_run/."""
    cfg = base or train_config(True)
    out = os.path.join(os.path.dirname(FIT_DIR), "fit_run", run)
    shutil.rmtree(out, ignore_errors=True)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, device_cache=device_cache),
        train=dataclasses.replace(
            cfg.train, epochs=FIT_EPOCHS, map_eval_start_epoch=0,
            map_eval_every=1, checkpoint_dir=os.path.join(out, "ckpt"),
            log_dir=os.path.join(out, "logs")),
        eval=dataclasses.replace(cfg.eval, mask_padded_images=True))


def fit_logs(trainer) -> list:
    with open(trainer.logger.path) as f:
        return [json.loads(line) for line in f]


def map_on(cfg, device, grids, predict=None):
    """``cfg``'s MeanAveragePrecision filled with stashed ``(y_true, y_pred,
    weight)`` on ``device``; ``predict(y_true, y_pred)`` replaces the
    prediction."""
    from keras_object_detection_torch.train.loop import _map_metric

    metric = _map_metric(cfg)
    for y_true, y_pred, weight in grids:
        if predict is not None:
            y_pred = predict(y_true, y_pred)
        metric.update_state(to_device(y_true, device),
                            to_device(y_pred, device),
                            None if weight is None else weight.to(device))
    return metric


def fit_run(cfg, train_ds, val_ds) -> tuple:
    """One Trainer.fit from seeded weights: (trainer, state, logs, kernel
    launches of the run, seconds). The main path: counts at 0 just before,
    read just after."""
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import Trainer

    trainer = Trainer(cfg, use_tensorboard=False)  # the default device: the GPU
    state = trainer.init_state()
    torch.cuda.synchronize()
    reset_kernel_counts()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    state = trainer.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernel_counts(), nms=cuda_nms.LAUNCHES)
    return trainer, state, fit_logs(trainer), counts, seconds


def check_fit_launches(name: str, counts: dict, steps: int,
                       map_updates: int, bn: int = 25, loss: int = 1) -> None:
    """A fit's launches: ``bn`` K2 and K3 and ``loss`` K4 and K5 a train
    step, K1 twice a mAP update."""
    want = {"bn_stats": bn * steps, "bn_grad_stats": bn * steps,
            "yolo_loss_forward": loss * steps,
            "yolo_loss_backward": loss * steps, "nms": 2 * map_updates}
    log(f"[fit] {name}: kernel launches {counts} over {steps} train steps and "
        f"{map_updates} mAP updates (expected {want})")
    if counts != want:
        raise SystemExit(f"the {name} fit launched {counts}, expected {want}")


def eval_and_train_mode_loss(cfg, eval_step, state, val_ds) -> dict:
    """The loss of ``state``'s weights on the first val batch with
    BatchNorm in eval mode (the eval step: running statistics) and in train
    mode (the batch's statistics; a copy of the model, so the state's
    running statistics do not move), and how far the first BatchNorm's
    running statistics lie from that batch's."""
    import copy

    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data.augment import preprocess_eval_batch
    from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
    from keras_object_detection_torch.models.layers import BatchNorm

    g, t = cfg.grid, cfg.train
    dev = next(state.model.parameters()).device
    images, boxes, valid = next(iter(val_ds.prefetched(dev)))
    eval_loss = float(eval_step(state, images, boxes, valid)[0])
    model = copy.deepcopy(state.model).train()
    first = next(m for m in model.modules() if isinstance(m, BatchNorm))
    seen = {}
    hook = first.register_forward_hook(lambda m, i, o: seen.update(x=i[0]))
    with torch.no_grad():
        y_true = encode_grid(boxes, valid, g.num_classes, g.num_boxes, g.grid)
        running = (first.running_mean.clone(), first.running_var.clone())
        y_pred = model(preprocess_eval_batch(images)).reshape(y_true.shape)
        train_loss = float(yolo_v1_loss_terms(
            y_true, y_pred, g.num_classes, g.num_boxes, t.lambda_coord,
            t.lambda_noobj, t.noobj_mode, t.box_loss_mode)["total"])
        x = seen["x"].float()
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
    hook.remove()
    del model
    return {"eval": eval_loss, "train": train_loss,
            "mean_gap": (running[0] - mean).abs().mean().item(),
            "var_ratio": (running[1] / var.clamp_min(1e-12)).mean().item()}


def phase_fit(dev, train: dict) -> dict:
    """The training run (see the module docstring, phase 9)."""
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import Evaluator
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import run_dataset_eval

    smi = card()
    t_phase = t0 = time.perf_counter()
    train_dir, train_cache = fit_split("train", FIT_TRAIN, 11)
    val_dir, val_cache = fit_split("val", FIT_VAL, 12)
    log(f"[fit] wrote {FIT_TRAIN} train and {FIT_VAL} val images (448², "
        f"1-4 boxes each) as decoded caches under {FIT_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = fit_config("host")
    d = cfg.data
    # as the train CLI makes them: the val set keeps its padded last batch
    mk = lambda data, cache, train: YoloDataset(
        data, cfg.model.image_size, d.batch_size, max_boxes=d.max_boxes_per_image,
        shuffle=train and d.shuffle, drop_remainder=train and d.drop_remainder,
        seed=cfg.train.seed, cache_dir=cache)
    train_ds = mk(train_dir, train_cache, True)
    val_ds = mk(val_dir, val_cache, False)
    steps = FIT_EPOCHS * len(train_ds)
    map_updates = FIT_EPOCHS * len(val_ds)
    log(f"[fit] voc_full_config batch {d.batch_size}, {len(train_ds)} train "
        f"steps and {len(val_ds)} val batches an epoch (the last padded, "
        f"masked), {FIT_EPOCHS} epochs, mAP every epoch")

    out = {}
    runs = {}
    for name, cached in (("host loader", False), ("device cache", True)):
        c = fit_config("device" if cached else "host", cached)
        trainer, state, logs, counts, seconds = fit_run(
            c, mk(train_dir, train_cache, True), val_ds)
        check_fit_launches(name, counts, steps, map_updates)
        for r in logs:
            if not (np.isfinite(r["val_loss"]) and np.isfinite(r["total"])
                    and 0.0 <= r["val_mAP"] <= 1.0):
                raise SystemExit(f"{name} fit, epoch {r['step']}: {r}")
            log(f"[fit] {name}, epoch {r['step'] + 1} on {smi}: total "
                f"{r['total']:.4f}, val_loss {r['val_loss']:.4f}, val_mAP "
                f"{r['val_mAP']:.6f}; wall {r['wall_s']:.3f} s (train "
                f"{r['epoch_time_s']:.3f}, {r['images_per_s']:.1f} images/s; "
                f"val {r['val_s']:.3f}, {FIT_VAL / r['val_s']:.1f} images/s; "
                f"mAP {r['map_s'] * 1e3 / len(val_ds):.3f} ms an update; "
                + (f"checkpoint save {r['save_s'] * 1e3:.1f} ms)"
                   if "save_s" in r else "no checkpoint saved)"))
        log(f"[fit] {name}: Trainer.fit took {seconds:.3f} s")
        runs[name] = (logs, counts)
        if cached:
            trainer.close()
            del trainer, state
            torch.cuda.empty_cache()
        else:
            host = (trainer, state)
    trainer, state = host
    del host
    (logs, counts), cached_logs = runs["host loader"], runs["device cache"][0]
    rel = abs(cached_logs[0]["total"] - logs[0]["total"]) / abs(logs[0]["total"])
    log(f"[fit] first-epoch total, host loader {logs[0]['total']:.6f} vs device "
        f"cache {cached_logs[0]['total']:.6f}: rel {rel:.3e} (tolerance 2e-2)")
    if rel > 2e-2:
        raise SystemExit("the two data paths' first epochs disagree")
    last = logs[-1]
    log(f"[fit] on {smi}: fit {last['images_per_s']:.1f} images/s (epoch "
        f"{FIT_EPOCHS}) against the train phase's step-only "
        f"{train['kernels']['images_per_s']:.1f} images/s")

    # mAP on the card against the CPU, on the final state's val grids
    stash = []
    run_dataset_eval(cfg, trainer._eval_step, trainer.map_metric, state,
                     val_ds, with_map=False, stash=stash)
    cpu = [(t.cpu(), p.cpu(), None if w is None else w.cpu())
           for t, p, w in stash]
    noisy = lambda t, p: 0.8 * t + 0.3 * torch.rand(
        t.shape, generator=torch.Generator().manual_seed(3)).to(t.device)
    cuda_nms.LAUNCHES = 0
    checks = {}
    for what, predict in (("model", None), ("ground truth", lambda t, p: t),
                          ("noisy ground truth", noisy)):
        on_card, on_cpu = (map_on(cfg, dev, cpu, predict),
                           map_on(cfg, "cpu", cpu, predict))
        got, want = on_card.result(), on_cpu.result()
        aps, cpu_aps = on_card.result_per_class(), on_cpu.result_per_class()
        present = sorted(on_cpu.result_pr_curves())
        checks[what] = (got, want)
        log(f"[fit] mAP of the {what} as prediction on {len(cpu)} val "
            f"batches ({len(present)} of {len(aps)} classes present): card "
            f"{got!r}, CPU {want!r}, |diff| {abs(got - want):.3e}, per class "
            f"{np.abs(aps - cpu_aps).max():.3e}")
        if abs(got - want) > 1e-6 or np.abs(aps - cpu_aps).max() > 1e-6:
            raise SystemExit(f"the card's mAP differs from the CPU's ({what})")
        if what == "ground truth" and not (
                aps[present] >= 1.0 - 1e-5).all():
            # 1 up to the reference's 1e-6 in the recall and precision
            # denominators; an absent class counts 0 in the mean
            raise SystemExit("ground truth as prediction does not give AP 1")
    log(f"[fit] (NMS kernel launches of these checks: {cuda_nms.LAUNCHES})")
    both = eval_and_train_mode_loss(cfg, trainer._eval_step, state, val_ds)
    out["val_loss_modes"] = both
    log(f"[fit] the final weights on the first val batch (64 images): "
        f"eval-mode loss {both['eval']:.6g} (BatchNorm on its running "
        f"statistics), train-mode loss {both['train']:.6g} (on the batch's "
        f"statistics, no update), ratio {both['eval'] / both['train']:.4g}; "
        f"running statistics vs this batch's at the first BatchNorm: mean "
        f"|mean - batch mean| {both['mean_gap']:.4g}, mean running / batch "
        f"variance {both['var_ratio']:.4g}")

    # resume: the latest checkpoint is the final state, bit for bit; one
    # more epoch continues the checkpoint axis
    latest = trainer.ckpt.latest_step
    restored = trainer.ckpt.restore(state, step=latest)
    saved = {**state.model.state_dict(),
             **{f"mu{i}": t for i, t in enumerate(state.opt.mu)},
             **{f"nu{i}": t for i, t in enumerate(state.opt.nu)}}
    got = {**restored.model.state_dict(),
           **{f"mu{i}": t for i, t in enumerate(restored.opt.mu)},
           **{f"nu{i}": t for i, t in enumerate(restored.opt.nu)}}
    equal = (all(torch.equal(got[k], v) for k, v in saved.items())
             and restored.step == state.step
             and restored.opt.count == state.opt.count)
    shared = {v.data_ptr() for v in saved.values()} & {
        v.data_ptr() for v in got.values()}
    log(f"[fit] restore(latest={latest}): {len(saved)} tensors bit-equal to "
        f"the final state: {equal}, none shared: {not shared}")
    if not equal or shared:
        raise SystemExit("the restored checkpoint differs from the saved state")
    del state
    t0 = time.perf_counter()
    restored = trainer.fit(train_ds, val_ds, epochs=1, state=restored,
                           start_epoch=latest + 1, verbose=False)
    log(f"[fit] one resumed epoch in {time.perf_counter() - t0:.3f} s: "
        f"checkpoint axis {trainer.ckpt.all_steps}")
    if trainer.ckpt.all_steps != [0, 1, 2]:
        raise SystemExit("resuming did not continue the checkpoint axis")

    # the Evaluator on the best checkpoint against its epoch's logged values
    best = trainer.ckpt.best_step
    logged = [r for r in fit_logs(trainer) if r["step"] == best][-1]
    best_state = trainer.ckpt.restore(restored)
    del restored
    result = Evaluator(cfg).evaluate(best_state, val_ds)
    rel = abs(result["loss"] - logged["val_loss"]) / abs(logged["val_loss"])
    diff = abs(result["mAP"] - logged["val_mAP"])
    log(f"[fit] Evaluator on the best checkpoint (epoch {best + 1}): loss "
        f"{result['loss']!r} vs logged {logged['val_loss']!r} (rel {rel:.3e}), "
        f"mAP {result['mAP']!r} vs {logged['val_mAP']!r} (diff {diff:.3e}); "
        f"{result['images_per_s']:.1f} images/s")
    if rel > 1e-6 or diff > 1e-6:
        raise SystemExit("the Evaluator does not reproduce the logged epoch")
    trainer.close()
    del best_state, trainer
    torch.cuda.empty_cache()
    log(f"[fit] phase took {time.perf_counter() - t_phase:.1f} s")
    out.update(counts=counts, device_cache_counts=runs["device cache"][1],
               logs=logs, map_checks=checks)
    return out


LEARN_TRAIN, LEARN_VAL, LEARN_SEED = 1000, 100, 3
# the plain path's val mAP first reaches 0.10 at epoch 46-55 and 0.28 at
# 100 on the H100; a loss spike (adam at a constant 1e-3) sets a run back
# some 25 epochs, as one at epoch 35 left the kernel path at 0.12 by 70.
# Under deterministic cuDNN the kernel path repeats: 0.10 at epoch 43,
# best 0.3553 at 97, a spike at 58 (PERF.md, section 6)
LEARN_EPOCHS = 100
LEARN_MAP_BAR = 0.10  # (i): the best val mAP, and its gain over untrained
LEARN_VIZ_IMAGES = 16
LEARN_DIR = os.path.join(os.path.dirname(FIT_DIR), "learn_data")


def learn_data() -> str:
    """tools/make_synthetic_dataset.py (numpy and cv2) in a subprocess:
    LEARN_TRAIN / LEARN_VAL images at 224² under build/learn_data/."""
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(LEARN_DIR, ignore_errors=True)
    subprocess.run([sys.executable, os.path.join(root, "tools",
                                                 "make_synthetic_dataset.py"),
                    "--out", LEARN_DIR, "--train", str(LEARN_TRAIN),
                    "--val", str(LEARN_VAL), "--image-size", "224",
                    "--seed", str(LEARN_SEED)], check=True, timeout=600)
    return LEARN_DIR


def learn_config():
    """(cfg, args) of the learning run as its command builds them, with
    bn_mode "fused" put in beside the fused loss: K1-K5 all run."""
    from keras_object_detection_torch.cli import run_synth_benchmark as synth

    work = os.path.join(os.path.dirname(FIT_DIR), "learn_run")
    shutil.rmtree(work, ignore_errors=True)
    args = synth.parse_args(
        ["--data", LEARN_DIR, "--workdir", work, "--epochs", str(LEARN_EPOCHS),
         "--batch-size", "32", "--lr", "1e-3", "--schedule", "constant",
         "--plateau", "", "--ema", "0.999", "--device-cache",
         "--map-start", "1", "--map-every", "10", "--pallas-loss"])
    cfg = synth.build_config(args)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_mode="fused")), args


@contextlib.contextmanager
def kept_nms_calls():
    """The arguments of every K1 call made inside, in a list (the wrapper
    is looked up at each call, so it can be wrapped)."""
    from keras_object_detection_torch.ops import cuda_nms

    calls, kernel = [], cuda_nms.cuda_batched_non_max_suppression

    def keep(*args):
        calls.append(args)
        return kernel(*args)

    with unittest.mock.patch.object(cuda_nms,
                                    "cuda_batched_non_max_suppression", keep):
        yield calls


def nms_errors(calls: list, tag: str) -> dict:
    """K1 on each kept call's arguments against the plain NMS on the card:
    rows and valid flags must be equal."""
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    err = 0.0
    for args in calls:
        rows, valid = cuda_nms.cuda_batched_non_max_suppression(*args)
        want_rows, want_valid = batched_non_max_suppression(*args)
        err = max(err, (rows - want_rows).abs().max().item())
        if not (torch.equal(rows, want_rows) and torch.equal(valid, want_valid)):
            raise SystemExit(f"[{tag}] K1 differs from the plain NMS at "
                             f"{tuple(args[0].shape)}")
    return {"calls": len(calls), "max_abs_err": err,
            "shapes": sorted({tuple(a[0].shape) for a in calls})}


def learn_step_kernels(cfg, state, batch, n_bn: int, smi: str) -> dict:
    """K2-K5 on one step of the learning run's own inputs (its initial
    state, its first train batch) against their plain versions
    (kernel_errors): K2 and K3 at each BatchNorm, K4 and K5 at its loss
    rows. The step trains ``state``."""
    from keras_object_detection_torch.train import make_train_step

    calls = capture_kernel_calls(make_train_step(cfg), state, batch, 1)
    got = {k: len(v) for k, v in calls.items()}
    want = {"k2": n_bn, "k3": n_bn, "k4": 1, "k5": 1}
    if got != want:
        raise SystemExit(f"the learning run's step called the kernels {got} "
                         f"times, expected {want}")
    errs = kernel_errors(calls)
    del calls
    log(f"[learn] the run's first step on {smi}, kernels against their "
        f"plain versions on its own inputs: " + "; ".join(
            f"{k.upper()} {v['calls']} calls at {v['shapes']}, max abs "
            f"{v['max_abs_err']:.3e}, max rel {v['max_rel_err']:.3e}"
            for k, v in errs.items()))
    return errs


def learn_round_trip(dev, smi: str) -> dict:
    """(v): cli/visualize_dataset.py over LEARN_VIZ_IMAGES val images on
    the card (K1 once an image): each image's labels come back, K1's rows
    equal the plain NMS of the same decoded rows on the card, and the CPU's
    round trip within one rounding (the card's division by S is a multiply
    by 1/S)."""
    from keras_object_detection_torch.cli import visualize_dataset
    from keras_object_detection_torch.core.grid import decode_grid, encode_grid
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    argv = ["--data-dir", os.path.join(LEARN_DIR, "val"), "--names",
            os.path.join(LEARN_DIR, "synth.names"), "--image-size", "224",
            "--num-classes", "20", "--limit", str(LEARN_VIZ_IMAGES),
            "--out-dir", os.path.join(os.path.dirname(FIT_DIR), "learn_viz")]
    before = cuda_nms.LAUNCHES
    card_rts = visualize_dataset.main(argv)
    launches = cuda_nms.LAUNCHES - before
    cpu_rts = visualize_dataset.main(argv[:-2] + [
        "--out-dir", os.path.join(os.path.dirname(FIT_DIR), "learn_viz_cpu"),
        "--device", "cpu"])
    worst = cpu_gap = 0.0
    boxes = 0
    for rt, cpu in zip(card_rts, cpu_rts):
        labels = rt.boxes[rt.valid]
        kept = rt.kept[np.lexsort((rt.kept[:, 3], rt.kept[:, 2]))]
        want = labels[np.lexsort((labels[:, 1], labels[:, 0]))]
        decoded = decode_grid(encode_grid(
            torch.from_numpy(rt.boxes[None]).to(dev),
            torch.from_numpy(rt.valid[None]).to(dev), 20), 20)
        rows, keep = batched_non_max_suppression(decoded)
        ok = (len(kept) == len(want) == len(cpu.kept)
              and np.array_equal(kept[:, 0], want[:, 4])
              and np.array_equal(kept[:, 1], np.ones(len(kept), np.float32))
              and np.array_equal(rt.kept, rows[0][keep[0]].cpu().numpy())
              and np.array_equal(rt.kept[:, :2], cpu.kept[:, :2]))
        if ok and len(kept):
            worst = max(worst, float(np.abs(kept[:, 2:] - want[:, :4]).max()))
            cpu_gap = max(cpu_gap, float(np.abs(rt.kept - cpu.kept).max()))
        if not ok or max(worst, cpu_gap) > 2.0 ** -22:
            raise SystemExit(f"the round trip of {rt.path} on the card does "
                             f"not give back its labels: {rt.kept} against "
                             f"{labels} (the CPU's {cpu.kept})")
        boxes += len(kept)
    log(f"[learn] round trip of {len(card_rts)} val images on {smi}: {boxes} "
        f"labels back, classes and confidences exact, boxes within "
        f"{worst:.3e} of the labels and {cpu_gap:.3e} of the CPU's; K1's "
        f"rows = the plain NMS's on the card; K1 launches {launches}")
    if len(card_rts) != LEARN_VIZ_IMAGES or launches != LEARN_VIZ_IMAGES:
        raise SystemExit(f"the round trip launched K1 {launches} times for "
                         f"{len(card_rts)} images")
    return {"images": len(card_rts), "labels": boxes, "max_abs_err": worst,
            "cpu_max_abs_diff": cpu_gap, "launches": launches}


def phase_learn(dev) -> dict:
    """The learning run (see the module docstring, phase 9b), with
    deterministic cuDNN so that a run repeats."""
    with deterministic_cudnn():
        return learn_run(dev)


def learn_run(dev) -> dict:
    from keras_object_detection_torch.cli import run_synth_benchmark as synth
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import Evaluator
    from keras_object_detection_torch.models.layers import BatchNorm
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import create_train_state
    from keras_object_detection_torch.train.checkpoint import \
        CheckpointManager

    smi = card()
    t_phase = t0 = time.perf_counter()
    learn_data()
    log(f"[learn] tools/make_synthetic_dataset.py wrote {LEARN_TRAIN} train "
        f"and {LEARN_VAL} val images (224², seed {LEARN_SEED}) in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg, args = learn_config()
    d, size = cfg.data, cfg.model.image_size
    val_ds = YoloDataset(d.val_dir, size, d.batch_size,
                         max_boxes=d.max_boxes_per_image, cache_in_memory=True)
    train_ds = YoloDataset(d.train_dir, size, d.batch_size,
                           max_boxes=d.max_boxes_per_image, shuffle=True,
                           seed=cfg.train.seed)
    steps = LEARN_EPOCHS * len(train_ds)

    # the untrained state: the run's own initial weights (its seed); then
    # one step of it on the run's first batch holds K2-K5 to their plain
    # versions at the run's shapes, outside the counted run
    state = create_train_state(
        cfg, torch.Generator().manual_seed(cfg.train.seed), dev)
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    untrained = Evaluator(cfg).evaluate(state, val_ds)
    log(f"[learn] darknet_tiny + conv head at 224², batch 32, adam 1e-3, EMA "
        f"0.999, {LEARN_EPOCHS} epochs ({steps} steps, {n_bn} BatchNorms), "
        f"deterministic cuDNN; untrained val mAP {untrained['mAP']:.6f}, "
        f"loss {untrained['loss']:.6g}")
    batch = tuple(torch.as_tensor(x).to(dev) for x in next(train_ds.epoch()))
    step_errors = learn_step_kernels(cfg, state, batch, n_bn, smi)
    del state, batch
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    reset_kernel_counts()
    cuda_nms.LAUNCHES = 0
    t0 = time.perf_counter()
    results = synth.run(cfg, args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(kernel_counts(), nms=cuda_nms.LAUNCHES)
    with open(os.path.join(cfg.train.log_dir, "train.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    curve = [(r["step"] + 1, r["val_mAP"]) for r in logs if "val_mAP" in r]
    log(f"[learn] kernel path on {smi}: run took {seconds:.1f} s; mAP curve "
        f"(epoch, val mAP): {[(e, round(m, 4)) for e, m in curve]}; final "
        f"{results['val_mAP']:.6f}, best checkpoint (epoch "
        f"{results['best_ckpt_epoch'] + 1}) {results['best_ckpt_val_mAP']:.6f};"
        f" fit {results['images_per_s_train']} images/s over the run, "
        f"steady state {results.get('steady_state_images_per_s')} images/s "
        f"({results.get('epoch_decomposition_p50_s')} s a non-mAP epoch)")
    log(f"[learn] train loss: epoch 1 {logs[0]['total']:.6g}, epoch "
        f"{len(logs)} {logs[-1]['total']:.6g}")

    # (iii) K1 twice a mAP update: the mAP epochs' and the command's two
    # evaluations' (final state, best checkpoint) val batches
    updates = (len(curve) + 2) * len(val_ds)
    check_fit_launches("learn", counts, steps, updates, bn=n_bn, loss=1)
    # (i) and (ii)
    best = max([m for _, m in curve] + [results["val_mAP"],
                                        results["best_ckpt_val_mAP"]])
    gain = best - untrained["mAP"]
    log(f"[learn] (i) best val mAP {best:.6f}, {gain:+.6f} over the untrained "
        f"state (bars {LEARN_MAP_BAR} and +{LEARN_MAP_BAR}); (ii) last / first "
        f"train loss {logs[-1]['total'] / logs[0]['total']:.4f} (bar 0.5)")
    if best < LEARN_MAP_BAR or gain < LEARN_MAP_BAR:
        raise SystemExit(f"the kernel path did not learn: best val mAP "
                         f"{best:.6f}, untrained {untrained['mAP']:.6f}")
    if not logs[-1]["total"] <= 0.5 * logs[0]["total"]:
        raise SystemExit("the kernel path's train loss did not halve")

    # (iv) the best checkpoint, restored by hand, through the Evaluator;
    # its K1 calls, at the run's val shapes, held to the plain NMS
    manager = CheckpointManager(cfg.train.checkpoint_dir)
    best_step = manager.best_step
    best_state = manager.restore(create_train_state(cfg, device=dev))
    manager.close()
    logged = [r for r in logs if r["step"] == best_step][-1]
    with kept_nms_calls() as nms_calls:
        result = Evaluator(cfg).evaluate(best_state, val_ds)
    del best_state
    nms_err = nms_errors(nms_calls, "learn")
    del nms_calls
    log(f"[learn] K1 on the best checkpoint's {nms_err['calls']} val-batch "
        f"calls at {nms_err['shapes']} = the plain NMS on the card (max abs "
        f"{nms_err['max_abs_err']:.3e})")
    # an epoch without a mAP (the first; the policy starts at the second)
    # is held to the command's evaluation of the checkpoint instead
    want = logged.get("val_mAP", results["best_ckpt_val_mAP"])
    rel = abs(result["mAP"] - want) / max(want, 1e-12)
    rel_loss = abs(result["loss"] - logged["val_loss"]) / logged["val_loss"]
    log(f"[learn] (iv) Evaluator on the best checkpoint (epoch "
        f"{best_step + 1}): mAP {result['mAP']!r} vs "
        f"{'logged' if 'val_mAP' in logged else 'the command' + chr(39) + 's'}"
        f" {want!r} (rel {rel:.3e}; the command's "
        f"{results['best_ckpt_val_mAP']!r}); loss {result['loss']!r} vs "
        f"logged {logged['val_loss']!r} (rel {rel_loss:.3e})")
    if rel > 1e-6 or rel_loss > 1e-6:
        raise SystemExit("the Evaluator does not reproduce the best "
                         "checkpoint's logged epoch")
    viz = learn_round_trip(dev, smi)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"[learn] phase took {phase_s:.1f} s on {smi}")
    return {"counts": counts, "untrained_mAP": untrained["mAP"],
            "best_mAP": best, "curve": curve, "results": results,
            "seconds": seconds, "phase_s": phase_s, "round_trip": viz,
            "steps": steps, "map_updates": updates,
            "errors": dict(step_errors, k1=nms_err)}


def serve_variant(cfg, state_dict, dev, runs: tuple = (10, 5),
                  stages: bool = False) -> dict:
    """Serving at batch 1 and 32 through InferenceModel: K1 launches of the
    two predict calls (counts at 0 just before, read just after), predict()
    at both batches against the plain NMS of predict_decoded() after the
    same top-k cut to max_candidates (a no-op at or below it), p50
    latencies over ``runs`` calls; ``stages`` adds stage_ms at both
    batches."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import (
        batched_non_max_suppression, top_k_candidates)

    model = InferenceModel(cfg, state_dict)  # the default device: the GPU
    e = cfg.eval
    rng = np.random.RandomState(1)
    size = cfg.model.image_size
    batch1, batch32 = (torch.from_numpy(rng.randint(
        0, 256, (b, size, size, 3), np.uint8)).to(dev) for b in (1, 32))
    cuda_nms.LAUNCHES = 0
    rows1, valid1 = model.predict(batch1)
    rows32, valid32 = model.predict(batch32)
    torch.cuda.synchronize()
    launches = cuda_nms.LAUNCHES
    ok = launches == 2
    for images, rows, valid in ((batch1, rows1, valid1),
                                (batch32, rows32, valid32)):
        cut = model.predict_decoded(images)
        candidates = cut.shape[1]
        if e.max_candidates:
            cut = top_k_candidates(cut, e.max_candidates)
        plain = batched_non_max_suppression(cut, e.iou_threshold,
                                            e.conf_threshold)
        ok = (ok and tuple(rows.shape) == tuple(cut.shape)
              and bool(torch.isfinite(rows).all())
              and torch.equal(plain[0], rows) and torch.equal(plain[1], valid))
    lat1 = model.benchmark_latency(batch1, runs=runs[0])
    lat32 = model.benchmark_latency(batch32, runs=runs[1])
    out = {"launches": launches, "ok": ok, "p50_ms_1": lat1["p50_ms"],
           "p50_ms_32": lat32["p50_ms"], "kept_32": int(valid32.sum()),
           "candidates": candidates, "nms_n": int(rows32.shape[1])}
    if stages:
        out["stages_1"] = stage_ms(model, batch1)
        out["stages_32"] = stage_ms(model, batch32)
        out["nms_rows"] = {1: top_k_candidates(model.predict_decoded(batch1),
                                               e.max_candidates),
                           32: top_k_candidates(
                               model.predict_decoded(batch32),
                               e.max_candidates)}
    del model
    return out


def phase_variants(dev) -> dict:
    """The v1 transfer family at full width (see the module docstring,
    phase 10): per configuration of VARIANTS, train steps on the kernel path
    with each kernel's launches a step, the frozen backbone bit-unchanged,
    then serving."""
    from keras_object_detection_torch.config import test_model_config
    from keras_object_detection_torch.models.layers import BatchNorm
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.train.loop import dropout_generator

    smi = card()
    want_test_model = dataclasses.replace(test_model_config().model,
                                          bn_mode="fused")
    if variant_config(**VARIANTS["test_model"]).model != want_test_model:
        raise SystemExit("the test_model variant is not test_model_config()")
    out = {}
    for name, fields in VARIANTS.items():
        t0 = time.perf_counter()
        cfg = variant_config(**fields)
        torch.cuda.reset_peak_memory_stats(dev)
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        model = state.model
        n_values = sum(v.numel() for v in model.state_dict().values())
        training_bns = sum(m.training for m in model.modules()
                           if isinstance(m, BatchNorm))
        if training_bns != VARIANT_BN_LAUNCHES[name]:
            raise SystemExit(f"{name}: {training_bns} BatchNorms train, "
                             f"expected {VARIANT_BN_LAUNCHES[name]}")
        b = VARIANT_BATCH
        keep = model.draw_dropout(b, dropout_generator(0, 0))
        if (keep is not None) != (cfg.model.head == "flatten_dense"):
            raise SystemExit(f"{name}: dropout is "
                             f"{'on' if keep is not None else 'off'}")
        names = [n for n, _ in model.named_parameters()]
        backbone = {n: p.detach().clone() for n, p in model.named_parameters()
                    if n.startswith("backbone.")}
        head = {n: p.detach().clone() for n, p in model.named_parameters()
                if n.startswith("head.")}
        batch = synthetic_batch(b, cfg.model.image_size,
                                cfg.data.max_boxes_per_image, dev)
        step = make_train_step(cfg)
        times, metrics, counts = time_steps(state, step, batch, seed=1,
                                            warmup=VARIANT_WARMUP,
                                            steps=VARIANT_STEPS)
        dy_copies = bn.DY_LAYOUT_COPIES
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        p50 = float(np.median(times))
        loss = metrics["total"].item()
        per_step = {k: v / VARIANT_STEPS for k, v in counts.items()}
        want = {"bn_stats": training_bns, "bn_grad_stats": training_bns,
                "yolo_loss_forward": 1, "yolo_loss_backward": 1}
        log(f"[variants] {name} on {smi}: {cfg.model.backbone} + "
            f"{cfg.model.head} head, freeze_backbone="
            f"{cfg.model.freeze_backbone}, {n_values} values, batch {b}: "
            f"step p50 {p50:.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}), {b / p50 * 1e3:.1f} images/s, peak device "
            f"memory {peak:.3f} GiB, loss {loss:.4f}; kernel launches over "
            f"{VARIANT_STEPS} steps {counts} (expected a step {want}), dy "
            f"layout copies {dy_copies}")
        if per_step != want or not np.isfinite(loss):
            raise SystemExit(f"{name}: launches {per_step} a step (expected "
                             f"{want}), loss {loss}")
        params = dict(model.named_parameters())
        if cfg.model.freeze_backbone:
            moments = [(state.opt.mu[i], state.opt.nu[i])
                       for i, n in enumerate(names) if n.startswith("backbone.")]
            same = all(torch.equal(params[n], v) for n, v in backbone.items())
            still = all(not mu.any() and not nu.any() for mu, nu in moments)
            log(f"[variants] {name}: after {VARIANT_WARMUP + VARIANT_STEPS} "
                f"steps the {len(backbone)} VGG16 tensors are bit-unchanged: "
                f"{same}, their nadam moments all zero: {still}")
            if not (same and still):
                raise SystemExit(f"{name}: the frozen backbone moved")
        moved = sum(not torch.equal(params[n], v) for n, v in head.items())
        if moved < len(head) // 2:
            raise SystemExit(f"{name}: only {moved} of {len(head)} head "
                             f"tensors trained")
        sd = model.state_dict()
        del state, model, step, batch, params, backbone, head
        torch.cuda.empty_cache()
        serve = serve_variant(cfg, sd, dev)
        log(f"[variants] {name}: serving batch 1 p50 {serve['p50_ms_1']:.3f} "
            f"ms, batch 32 p50 {serve['p50_ms_32']:.3f} ms "
            f"({32 / serve['p50_ms_32'] * 1e3:.1f} images/s); NMS kernel "
            f"launches over 2 predict calls {serve['launches']}; predict == "
            f"plain NMS of predict_decoded, finite: {serve['ok']}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not serve["ok"]:
            raise SystemExit(f"{name}: serving failed its checks")
        out[name] = {"p50_ms": p50, "images_per_s": b / p50 * 1e3,
                     "peak_gib": peak, "loss": loss, "counts": counts,
                     "dy_copies": dy_copies, "serve": serve}
        del sd
        torch.cuda.empty_cache()
    return out


RECIPE_SIZES = (320, 384, 448, 512, 576)
RECIPE_GRIDS = {320: 5, 384: 6, 448: 7, 512: 8, 576: 9}  # darknet24's S
RECIPE_CHECKED = (320, 576)  # kernel inputs held against the plain versions
RECIPE_WARMUP, RECIPE_STEPS = 2, 5
REMAT_LAUNCHES = {None: 25, "full": 50, "dots": 50}  # K2 a step; K3 25


def recipe_config(**train):
    """train_config(kernels=True) with the v1 recipe: mosaic 1.0, mixup 0.5,
    adamw with weight decay 5e-4, multiscale over RECIPE_SIZES; ``train``
    replaces further train fields."""
    cfg = train_config(True)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, mosaic_prob=1.0,
                                      mixup_prob=0.5),
        train=dataclasses.replace(cfg.train, **{
            "optimizer": "adamw", "weight_decay": 5e-4,
            "multiscale_sizes": RECIPE_SIZES, **train}))


def capture_kernel_calls(step, state, batch, seed: int) -> dict:
    """One step with the arguments of every K2, K3, K4 and K5 call kept
    (the wrappers are looked up at each call, so they can be wrapped)."""
    from keras_object_detection_torch.ops import bn, yolo_loss

    calls = {"k2": [], "k3": [], "k4": [], "k5": []}

    def keep(name, fn):
        def wrapped(*args):
            calls[name].append(args)
            return fn(*args)
        return wrapped

    with contextlib.ExitStack() as stack:
        for module, attr, name in (
                (bn, "cuda_bn_stats_sums", "k2"),
                (bn, "cuda_bn_grad_sums", "k3"),
                (yolo_loss, "cuda_yolo_v1_loss_forward", "k4"),
                (yolo_loss, "cuda_yolo_v1_loss_backward", "k5")):
            stack.enter_context(unittest.mock.patch.object(
                module, attr, keep(name, getattr(module, attr))))
        step(state, *batch, seed)
        torch.cuda.synchronize()
    return calls


def kernel_errors(calls: dict) -> dict:
    """Each kernel on the captured arguments against its plain version:
    max abs error, and max error relative to each sum's largest channel
    (K2, K3; ``bn_rel_err``) or to each sum (K4); K5 must be bit-equal."""
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.ops import yolo_loss as yl

    out = {}
    for name, kernel, plain in (
            ("k2", bn.cuda_bn_stats_sums, bn.bn_stats_sums_plain),
            ("k3", bn.cuda_bn_grad_sums, bn.bn_grad_sums_plain),
            ("k4", yl.cuda_yolo_v1_loss_forward, yl.yolo_v1_loss_forward_plain),
            ("k5", yl.cuda_yolo_v1_loss_backward,
             yl.yolo_v1_loss_backward_plain)):
        abs_err = rel_err = 0.0
        for args in calls[name]:
            got, want = kernel(*args), plain(*args)
            abs_err = max(abs_err, (got - want).abs().max().item())
            if name == "k4":
                rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
                rel_err = max(rel_err, rel.item())
            elif name in ("k2", "k3"):
                rel_err = max(rel_err, bn_rel_err(got, want))
            elif not torch.equal(got, want):
                raise SystemExit("K5 differs from its plain version on the "
                                 "step's rows")
        out[name] = {"calls": len(calls[name]), "max_abs_err": abs_err,
                     "max_rel_err": rel_err,
                     "shapes": sorted({tuple(a[0].shape) for a in calls[name]})}
    limits = {"k2": 1e-5, "k3": 1e-5, "k4": 1e-6, "k5": 0.0}
    bad = {k: v["max_rel_err"] for k, v in out.items()
           if v["max_rel_err"] > limits[k]}
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions on the "
                         f"step's inputs: {bad} (limits {limits})")
    return out


def kernel_times(calls: dict) -> dict:
    """Each kernel's device time summed over one step's captured calls
    (CUDA graph, as phase_bn times them), its plain version's (per call),
    its bound and, for K2 and K3, the library call's (graph), in ms."""
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.ops import yolo_loss as yl

    out = {}
    for name, kernel, plain in (
            ("k2", bn.cuda_bn_stats_sums, bn.bn_stats_sums_plain),
            ("k3", bn.cuda_bn_grad_sums, bn.bn_grad_sums_plain),
            ("k4", yl.cuda_yolo_v1_loss_forward, yl.yolo_v1_loss_forward_plain),
            ("k5", yl.cuda_yolo_v1_loss_backward,
             yl.yolo_v1_loss_backward_plain)):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0 if name in ("k2", "k3") else None}
        for args in calls[name]:
            tot["ms"] += graph_ms(lambda: kernel(*args), reps=20, replays=5)
            tot["plain_ms"] += cuda_ms(lambda: plain(*args), 3, warmup=1)
            x = args[0] if name == "k2" else args[1]
            if name in ("k2", "k3"):
                tot["bound_ms"] += bn_bound_ms(tuple(x.shape), x.element_size(),
                                               name == "k3")[0]
                ones = torch.ones(x.shape[1], device=x.device)
                lib = ((lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0))
                       if name == "k2" else
                       (lambda: bn_grad_library(*args[:3], args[3], ones)))
                tot["library_ms"] += graph_ms(lib, reps=20, replays=5)
            else:
                n = args[0].shape[0]
                tot["bound_ms"] += loss_bound_ms(n, *args[2 if name == "k4"
                                                          else 3:][:2],
                                                 name == "k5")[0]
        out[name] = tot
    return out


def recipe_sizes(dev, smi: str) -> dict:
    """The recipe step at each multiscale size: p50, images/s, peak memory,
    launches a step; at RECIPE_CHECKED the kernels on the step's own inputs
    against their plain versions."""
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step,
                                                    multiscale_grid)

    cfg = recipe_config()
    state = create_train_state(cfg, torch.Generator().manual_seed(0))
    b = cfg.data.batch_size
    # decoded at the largest size, as the train CLI decodes for multiscale
    batch = synthetic_batch(b, max(RECIPE_SIZES), cfg.data.max_boxes_per_image,
                            dev)
    out = {}
    for size in RECIPE_SIZES:
        grid = multiscale_grid(cfg, size)
        if grid != RECIPE_GRIDS[size]:
            raise SystemExit(f"multiscale grid {grid} at {size}, expected "
                             f"{RECIPE_GRIDS[size]}")
        step = make_train_step(cfg, image_size=size, grid=grid)
        torch.cuda.reset_peak_memory_stats(dev)
        times, metrics, counts = time_steps(state, step, batch, seed=1,
                                            warmup=RECIPE_WARMUP,
                                            steps=RECIPE_STEPS)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        p50 = float(np.median(times))
        loss = metrics["total"].item()
        per_step = {k: v / RECIPE_STEPS for k, v in counts.items()}
        want = {"bn_stats": 25, "bn_grad_stats": 25, "yolo_loss_forward": 1,
                "yolo_loss_backward": 1}
        log(f"[recipe] {size}² (S={grid}, {b * grid * grid} loss rows) on "
            f"{smi}: step p50 {p50:.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}), {b / p50 * 1e3:.1f} images/s, peak device "
            f"memory {peak:.3f} GiB, loss {loss:.4f}; launches over "
            f"{RECIPE_STEPS} steps {counts}")
        if per_step != want or not np.isfinite(loss):
            raise SystemExit(f"recipe step at {size}: launches {per_step} a "
                             f"step (expected {want}), loss {loss}")
        out[size] = {"p50_ms": p50, "images_per_s": b / p50 * 1e3,
                     "peak_gib": peak, "loss": loss, "counts": counts}
        if size in RECIPE_CHECKED:
            calls = capture_kernel_calls(step, state, batch, 1)
            errs = kernel_errors(calls)
            times = kernel_times(calls)
            del calls
            log(f"[recipe] {size}²: kernels against their plain versions on "
                f"the step's own inputs: " + "; ".join(
                    f"{k.upper()} {v['calls']} calls, max abs "
                    f"{v['max_abs_err']:.3e}, max rel {v['max_rel_err']:.3e}"
                    for k, v in errs.items()))
            log(f"[recipe] {size}²: a step's calls, device ms (CUDA graph) / "
                f"plain ms / bound ms / library ms: " + "; ".join(
                    f"{k.upper()} {v['ms']:.5f} / {v['plain_ms']:.4f} / "
                    f"{v['bound_ms']:.5f} / "
                    + ("null" if v["library_ms"] is None
                       else f"{v['library_ms']:.5f}")
                    for k, v in times.items()))
            out[size].update(errors=errs, times=times)
        del step
        torch.cuda.empty_cache()
    del state, batch
    torch.cuda.empty_cache()
    return out


def recipe_remat(dev, smi: str) -> dict:
    """remat off / full / dots at 448 (the recipe without multiscale): one
    step from the same state and draws with deterministic cuDNN, whose loss,
    running statistics and gradients must equal those without remat bit for
    bit; then timed steps, peak memory and K2/K3 launches a step."""
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    base = recipe_config(multiscale_sizes=())
    batch = synthetic_batch(base.data.batch_size, base.model.image_size,
                            base.data.max_boxes_per_image, dev)
    out, first = {}, {}
    for policy in (None, "full", "dots"):
        name = policy or "off"
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, remat=policy is not None,
            remat_policy=policy or "full"))
        step = make_train_step(cfg)
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            state, metrics = step(state, *batch, 7)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        first[name] = (
            metrics["total"].clone(),
            torch.cat([v.reshape(-1) for k, v in state.model.state_dict().items()
                       if "running" in k]),
            {k: p.grad.clone() for k, p in state.model.named_parameters()
             if not zero_gradient(k)})
        torch.cuda.reset_peak_memory_stats(dev)
        times, _, counts = time_steps(state, step, batch, seed=1, warmup=1,
                                      steps=RECIPE_STEPS)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        p50 = float(np.median(times))
        per_step = {k: v / RECIPE_STEPS for k, v in counts.items()}
        want = {"bn_stats": REMAT_LAUNCHES[policy], "bn_grad_stats": 25,
                "yolo_loss_forward": 1, "yolo_loss_backward": 1}
        log(f"[recipe] remat {name} at {cfg.model.image_size}² on {smi}: step "
            f"p50 {p50:.3f} ms "
            f"(min {min(times):.3f}, max {max(times):.3f}), peak device "
            f"memory {peak:.3f} GiB; launches a step {per_step}")
        if per_step != want:
            raise SystemExit(f"remat {name}: launches {per_step} a step, "
                             f"expected {want}")
        out[name] = {"p50_ms": p50,
                     "images_per_s": cfg.data.batch_size / p50 * 1e3,
                     "peak_gib": peak, "counts": counts}
        del state, step
        torch.cuda.empty_cache()
    loss0, stats0, grads0 = first["off"]
    for name in ("full", "dots"):
        loss, stats, grads = first[name]
        errs = {k: rel_norm(grads[k], grads0[k]) for k in grads0}
        worst = max(errs, key=errs.get)
        same_loss, same_stats = torch.equal(loss, loss0), torch.equal(stats, stats0)
        n_equal = sum(torch.equal(grads[k], grads0[k]) for k in grads0)
        log(f"[recipe] remat {name} against off, one step from the same state "
            f"and draws: loss {loss.item():.6f} vs {loss0.item():.6f} "
            f"bit-equal {same_loss}; running statistics bit-equal "
            f"{same_stats}; gradients bit-equal in {n_equal} of {len(grads0)} "
            f"tensors (all required), largest rel err in norm "
            f"{errs[worst]:.3e} ({worst})")
        if not (same_loss and same_stats and n_equal == len(grads0)):
            raise SystemExit(f"remat {name} changed the step")
        out[name].update(grad_max_rel=errs[worst], grads_equal=n_equal,
                         tensors=len(grads0))
    return out


def recipe_box_losses(dev, smi: str) -> dict:
    """The plain loss with box_loss_mode ciou (K2/K3 still run): p50, and
    the loss and its gradient in y_pred on the step's own grids against the
    same loss on the CPU; diou and alpha_iou: one finite step each."""
    from keras_object_detection_torch.losses import yolo as yolo_losses
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.train import loop

    out = {}
    for mode in ("ciou", "diou", "alpha_iou"):
        cfg = recipe_config(multiscale_sizes=(), use_pallas_loss=False,
                            box_loss_mode=mode)
        g = cfg.grid
        state = create_train_state(cfg, torch.Generator().manual_seed(0))
        batch = synthetic_batch(cfg.data.batch_size, cfg.model.image_size,
                                cfg.data.max_boxes_per_image, dev)
        step = make_train_step(cfg)
        if mode == "ciou":
            times, metrics, counts = time_steps(state, step, batch, seed=1,
                                                warmup=1, steps=RECIPE_STEPS)
            per_step = {k: v / RECIPE_STEPS for k, v in counts.items()}
            want = {"bn_stats": 25, "bn_grad_stats": 25,
                    "yolo_loss_forward": 0, "yolo_loss_backward": 0}
            if per_step != want:
                raise SystemExit(f"ciou step: launches {per_step} a step, "
                                 f"expected {want}")
            grids = []
            real = loop.yolo_v1_loss_terms

            def keep(y_true, y_pred, *args):
                grids.append((y_true.detach(), y_pred.detach()))
                return real(y_true, y_pred, *args)

            with unittest.mock.patch.object(loop, "yolo_v1_loss_terms", keep):
                step(state, *batch, 1)
            y_true, y_pred = grids[0]
            totals, dps = [], []
            for where in (dev, "cpu"):
                p = y_pred.to(where).clone().requires_grad_(True)
                total = yolo_losses.yolo_v1_loss_terms(
                    y_true.to(where), p, g.num_classes, g.num_boxes,
                    box_loss_mode=mode)["total"]
                total.backward()
                totals.append(total.item())
                dps.append(p.grad.cpu())
            rel = abs(totals[0] - totals[1]) / abs(totals[1])
            grad_err = ((dps[0] - dps[1]).abs().max()
                        / dps[1].abs().max().clamp_min(1e-30)).item()
            p50 = float(np.median(times))
            log(f"[recipe] box_loss_mode ciou (plain loss) at "
                f"{cfg.model.image_size}² on {smi}: step p50 {p50:.3f} ms, "
                f"{cfg.data.batch_size / p50 * 1e3:.1f} images/s, loss "
                f"{metrics['total'].item():.4f}; on the step's grids the card's "
                f"loss {totals[0]:.6f} vs the CPU's {totals[1]:.6f} (rel "
                f"{rel:.3e}, tolerance 1e-5), gradient in y_pred max err "
                f"{grad_err:.3e} of its largest (tolerance 1e-5); launches a "
                f"step {per_step}")
            if not (rel <= 1e-5 and grad_err <= 1e-5):
                raise SystemExit("the ciou loss on the card disagrees with "
                                 "the CPU's")
            out[mode] = {"p50_ms": p50, "loss_rel": rel, "grad_err": grad_err,
                         "counts": counts}
        else:
            state, metrics = step(state, *batch, 1)
            loss = metrics["total"].item()
            finite = np.isfinite(loss) and all(
                bool(torch.isfinite(p.grad).all())
                for p in state.model.parameters() if p.grad is not None)
            log(f"[recipe] box_loss_mode {mode}: one step, loss {loss:.4f}, "
                f"loss and gradients finite: {finite}")
            if not finite:
                raise SystemExit(f"box_loss_mode {mode}: non-finite step")
            out[mode] = {"loss": loss}
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def recipe_fit(dev, smi: str) -> dict:
    """Trainer.fit of the recipe from the device cache with
    steps_per_dispatch 4 and 1 in turns (4, 1, 1, 4: the first run also
    pays the sizes' first launches): 2 epochs of 4 steps at two multiscale
    sizes (seed 1 draws 384 then 576), mAP every epoch from the loss pass's
    stash. With deterministic cuDNN every run must log the same epoch
    metrics, launch the same kernels as often and end with the same
    parameters, bit for bit. The seeded weights diverge in eval mode, so
    val_mAP reads 0 here; the CPU test holds a nonzero mAP equal across K."""
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import Trainer

    size = train_config(True).model.image_size
    train_dir, train_cache = fit_split("recipe_train", FIT_TRAIN, 11, size)
    val_dir, val_cache = fit_split("recipe_val", FIT_VAL, 12, size)
    out, runs = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for turn, spd in enumerate((4, 1, 1, 4)):
            cfg = fit_config(f"recipe_k{spd}_{turn}", device_cache=True)
            cfg = dataclasses.replace(
                cfg, data=dataclasses.replace(cfg.data, mosaic_prob=1.0,
                                              mixup_prob=0.5),
                train=dataclasses.replace(
                    cfg.train, optimizer="adamw", weight_decay=5e-4, seed=1,
                    multiscale_sizes=RECIPE_SIZES, steps_per_dispatch=spd))
            d = cfg.data
            mk = lambda data, cache, train: YoloDataset(
                data, size, d.batch_size, max_boxes=d.max_boxes_per_image,
                shuffle=train, drop_remainder=train, seed=cfg.train.seed,
                cache_dir=cache)
            trainer, state, logs, counts, seconds = fit_run(
                cfg, mk(train_dir, train_cache, True),
                mk(val_dir, val_cache, False))
            trainer.close()
            sizes = [r["train_size"] for r in logs]
            log(f"[recipe] fit, steps_per_dispatch {spd}, on {smi}: sizes "
                f"{sizes}, " + "; ".join(
                    f"epoch {r['step'] + 1}: total {r['total']:.4f}, val_loss "
                    f"{r['val_loss']:.4f}, val_mAP {r['val_mAP']:.6f}, "
                    f"{r['images_per_s']:.1f} images/s" for r in logs)
                + f"; launches {counts}; {seconds:.3f} s")
            if len(set(sizes)) < 2:
                raise SystemExit(f"the recipe fit drew one size: {sizes}")
            runs[turn] = (logs, {k: v.clone() for k, v in
                                 state.model.state_dict().items()})
            run = {"sizes": sizes, "seconds": seconds, "counts": counts,
                   "images_per_s": [r["images_per_s"] for r in logs]}
            out.setdefault(spd, {"turns": []})["turns"].append(run)
            out[spd]["counts"] = counts
            del trainer, state
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    measured = lambda k: k == "time" or k.endswith("_s")  # noqa: E731
    logs1, sd1 = runs[1]
    counts1 = out[1]["turns"][0]["counts"]
    for turn in (0, 2, 3):
        logs, sd = runs[turn]
        counts = out[(4, 1, 1, 4)[turn]]["turns"][turn // 2]["counts"]
        same_logs = [{k: v for k, v in r.items() if not measured(k)}
                     for r in logs] == [{k: v for k, v in r.items()
                                         if not measured(k)} for r in logs1]
        differing = [k for k in sd1 if not torch.equal(sd[k], sd1[k])]
        log(f"[recipe] fit turn {turn + 1} (steps_per_dispatch "
            f"{(4, 1, 1, 4)[turn]}) vs turn 2 (1): epoch metrics equal "
            f"{same_logs}; tensors that differ {len(differing)} of "
            f"{len(sd1)} {differing[:5]}; launches equal {counts == counts1}")
        if not same_logs or differing or counts != counts1:
            raise SystemExit("the recipe fits trained apart")
    return out


def recipe_arms(dev, smi: str) -> dict:
    """Device ms of mosaic_batch and of mixup_batch alone at batch 64, 448²
    (CUDA events over 10 calls, draws already on the card)."""
    from keras_object_detection_torch.data.augment import (
        mixup_batch, mosaic_batch, sample_mixup_draws, sample_mosaic_draws)

    cfg = train_config(True)
    images, boxes, valid = synthetic_batch(
        cfg.data.batch_size, cfg.model.image_size,
        cfg.data.max_boxes_per_image, dev)
    g = torch.Generator().manual_seed(0)
    mosaic = sample_mosaic_draws(cfg.data.batch_size, g).to(dev)
    mixup = sample_mixup_draws(cfg.data.batch_size, g).to(dev)
    ms = {"mosaic": cuda_ms(lambda: mosaic_batch(images, boxes, valid, mosaic,
                                                 1.0), 10),
          "mixup": cuda_ms(lambda: mixup_batch(images, boxes, valid, mixup,
                                               1.0), 10)}
    big = synthetic_batch(cfg.data.batch_size, max(RECIPE_SIZES),
                          cfg.data.max_boxes_per_image, dev)
    ms["mosaic_largest"] = cuda_ms(lambda: mosaic_batch(*big, mosaic, 1.0), 10)
    log(f"[recipe] alone at batch {cfg.data.batch_size}, "
        f"{cfg.model.image_size}² on {smi}: mosaic_batch "
        f"{ms['mosaic']:.3f} ms, mixup_batch {ms['mixup']:.3f} ms a call "
        f"(device, CUDA events over 10 calls); mosaic_batch at "
        f"{max(RECIPE_SIZES)}² (the multiscale decode) {ms['mosaic_largest']:.3f} ms")
    return ms


def recipe_kernel_entry(recipe: dict, name: str, key: str) -> dict:
    """The recipe phase's keys of one kernel's entry in the kernels line:
    its launches over the timed steps at each size and under each remat
    policy, over each recipe fit, and its errors on the step's own inputs at
    RECIPE_CHECKED."""
    return {
        "launches_recipe": {str(size): v["counts"][name]
                            for size, v in recipe["sizes"].items()},
        "launches_recipe_steps": RECIPE_STEPS,
        "launches_remat": {policy: v["counts"][name]
                           for policy, v in recipe["remat"].items()},
        "launches_recipe_fit": {f"steps_per_dispatch_{k}": v["counts"][name]
                                for k, v in recipe["fit"].items()},
        **{f"recipe_err_{size}": {f: recipe["sizes"][size]["errors"][key][f]
                                  for f in ("max_abs_err", "max_rel_err",
                                            "shapes")}
           for size in RECIPE_CHECKED},
        **{f"{f}_recipe_{size}": recipe["sizes"][size]["times"][key][f]
           for size in RECIPE_CHECKED
           for f in ("ms", "plain_ms", "bound_ms", "library_ms")}}


def phase_recipe(dev) -> dict:
    """The v1 recipe on the flagship (see the module docstring, phase 11)."""
    smi = card()
    t0 = time.perf_counter()
    out = {"sizes": recipe_sizes(dev, smi), "remat": recipe_remat(dev, smi),
           "box_losses": recipe_box_losses(dev, smi),
           "fit": recipe_fit(dev, smi), "arms_ms": recipe_arms(dev, smi)}
    out["seconds"] = time.perf_counter() - t0
    log(f"[recipe] {out['seconds']:.1f} s")
    print(json.dumps({"recipe": {
        "card": smi,
        "sizes": {str(k): {f: v[f] for f in ("p50_ms", "images_per_s",
                                             "peak_gib", "counts")}
                  | {f: v[f] for f in ("errors", "times") if f in v}
                  for k, v in out["sizes"].items()},
        "remat": out["remat"], "box_losses": out["box_losses"],
        "fit": {str(k): v for k, v in out["fit"].items()},
        "arms_ms": out["arms_ms"], "seconds": out["seconds"]}},
        default=lambda x: list(x) if isinstance(x, tuple) else str(x)))
    return out


# the yolov2 phase: YOLOv2 at full width, voc_full_config with these fields
# replaced. The priors are darknet's public cfg/yolo-voc.cfg anchors, in
# 13-cell grid units there, here as image ratios.
YOLOV2_ANCHORS = tuple((w / 13, h / 13) for w, h in (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (9.47112, 4.84053), (11.2364, 10.0071)))
YOLOV2_BN = 21  # K2 and K3 a step: 18 in Darknet-19, 3 in the head
# state_dict values at full width (tests/test_torch_anchor_model.py holds
# its names and shapes against the JAX model's)
YOLOV2_VALUES = 41_244_093
YOLOV2_WARMUP, YOLOV2_STEPS = 3, 5
YOLOV2_SIZES = {320: 10, 608: 19}  # YOLOv2's multiscale ends and their S
YOLOV2_FIT_TRAIN, YOLOV2_FIT_VAL = 128, 64


def yolov2_config(kernels: bool = True, **train):
    """voc_full_config as the paper's YOLOv2: Darknet-19 (LeakyReLU) +
    the passthrough anchor head at 416², S = 13, darknet's 5 VOC priors,
    C = 20, bf16, batch 64, nadam, darknet v2's ignore threshold 0.6 and
    IoU objectness; ``kernels`` picks bn_mode fused (K2/K3) or flax."""
    from keras_object_detection_torch.config import voc_full_config

    cfg = voc_full_config()
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, grid=13,
                                      anchors=YOLOV2_ANCHORS),
        model=dataclasses.replace(
            cfg.model, backbone="darknet19", head="anchor", passthrough=True,
            activation="leaky_relu", image_size=416,
            bn_mode="fused" if kernels else "flax"),
        train=dataclasses.replace(cfg.train, optimizer="nadam",
                                  ignore_threshold=0.6, obj_target="iou",
                                  **train))


def anchor_logits(y_true: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """Raw head output that decodes to the targets ``y_true`` (ground
    truth as prediction): objectness and class logits of +-20, offsets
    through the inverse sigmoid, sizes as they are."""
    b, s = y_true.shape[:2]
    t = y_true.reshape(b, s, s, num_anchors, -1)
    xy = t[..., 1:3].clamp(1e-6, 1 - 1e-6)
    out = torch.cat([torch.where(t[..., :1] > 0, 20.0, -20.0),
                     torch.log(xy / (1 - xy)), t[..., 3:5],
                     t[..., 5:] * 40.0 - 20.0], dim=-1)
    return out.reshape(y_true.shape)


def to_device(grids, device):
    """A grid, or the FPN head's tuple of per-scale grids, on ``device``."""
    if isinstance(grids, (tuple, list)):
        return tuple(g.to(device) for g in grids)
    return grids.to(device)


def gt_logits(cfg, y_true):
    """``anchor_logits`` of an anchor grid, or of each scale of an FPN
    tuple (its priors split evenly over the scales)."""
    g = cfg.grid
    if cfg.model.head == "fpn":
        per = len(g.anchors) // cfg.model.fpn_scales
        return tuple(anchor_logits(t, per) for t in y_true)
    return anchor_logits(y_true, len(g.anchors))


def anchor_loss_on_card(cfg, step, state, batch, dev, smi: str,
                        tag: str) -> dict:
    """The anchor family's loss (the v2 loss, or the FPN head's v3 loss)
    with its ignore mask and IoU target, on the step's own grids and
    augmented boxes: the call the step makes, replayed on the card and on
    the CPU; each term and the gradient in y_pred within 1e-5."""
    from keras_object_detection_torch.train import loop

    name = ("yolo_v3_loss_terms" if cfg.model.head == "fpn"
            else "yolo_v2_loss_terms")
    real = getattr(loop, name)
    kept = []

    def keep(y_true, y_pred, *args, **kwargs):
        kept.append((y_true, y_pred, args, kwargs))
        return real(y_true, y_pred, *args, **kwargs)

    with unittest.mock.patch.object(loop, name, keep):
        step(state, *batch, 2)
    y_true, y_pred, args, kwargs = kept[0]
    terms, grads = [], []
    for where in (dev, "cpu"):
        preds = [p.detach().to(where).requires_grad_(True) for p in
                 (y_pred if isinstance(y_pred, tuple) else (y_pred,))]
        out = real(to_device(y_true, where),
                   tuple(preds) if isinstance(y_pred, tuple) else preds[0],
                   *args, **{k: v.to(where) if torch.is_tensor(v) else v
                             for k, v in kwargs.items()})
        out["total"].backward()
        terms.append({k: v.item() for k, v in out.items()})
        grads.append([p.grad.cpu() for p in preds])
    rel = {k: abs(terms[0][k] - terms[1][k]) / max(abs(terms[1][k]), 1e-30)
           for k in terms[1]}
    grad_err = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(*grads))
    shapes = [tuple(p.shape) for p in grads[1]]
    log(f"[{tag}] {name} on the step's grids ({shapes}, "
        f"{int(kwargs['gt_valid'].sum())} boxes) on {smi}: card " + ", ".join(
            f"{k} {terms[0][k]:.6f}" for k in terms[0])
        + "; CPU " + ", ".join(f"{k} {terms[1][k]:.6f}" for k in terms[1])
        + f"; largest rel {max(rel.values()):.3e}, gradient max err "
        f"{grad_err:.3e} of its largest (tolerance 1e-5 each)")
    if max(rel.values()) > 1e-5 or grad_err > 1e-5:
        raise SystemExit(f"{name} on the card disagrees with the CPU's")
    return {"terms": terms[0], "max_rel": max(rel.values()),
            "grad_err": grad_err}


def step_bn_kernels(calls: dict, smi: str, tag: str, n_bn: int,
                    reps: tuple = (20, 5)) -> dict:
    """K2 and K3 at each of a step's ``n_bn`` BatchNorm inputs: within 1e-5
    of the plain versions (kernel_errors), bit-equal from call to call, and
    per call the device time (CUDA graph of ``reps`` calls, replayed), the
    plain version's, the bound and the library call's; summed over the
    step."""
    from keras_object_detection_torch.ops import bn

    if not (len(calls["k2"]) == len(calls["k3"]) == n_bn
            and not calls["k4"] and not calls["k5"]):
        raise SystemExit(f"the {tag} step called K2 {len(calls['k2'])}, K3 "
                         f"{len(calls['k3'])}, K4 {len(calls['k4'])}, K5 "
                         f"{len(calls['k5'])} times, expected {n_bn}, "
                         f"{n_bn}, 0, 0")
    errors = kernel_errors(calls)
    rows = {"k2": [], "k3": []}
    for name, kernel, plain in (
            ("k2", bn.cuda_bn_stats_sums, bn.bn_stats_sums_plain),
            ("k3", bn.cuda_bn_grad_sums, bn.bn_grad_sums_plain)):
        for args in calls[name]:
            first, again = kernel(*args), kernel(*args)
            if not torch.equal(first, again):
                raise SystemExit(f"{name.upper()} differs from call to call at "
                                 f"{tuple(args[0].shape)}")
            x = args[0] if name == "k2" else args[1]
            ones = torch.ones(x.shape[1], device=x.device)
            lib = ((lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0))
                   if name == "k2" else
                   (lambda: bn_grad_library(*args[:3], args[3], ones)))
            rows[name].append({
                "shape": list(x.shape),
                "ms": graph_ms(lambda: kernel(*args), *reps),
                "plain_ms": cuda_ms(lambda: plain(*args), 3, warmup=1),
                "bound_ms": bn_bound_ms(tuple(x.shape), x.element_size(),
                                        name == "k3")[0],
                "library_ms": graph_ms(lib, *reps)})
    totals = {k: {f: sum(r[f] for r in v) for f in
                  ("ms", "plain_ms", "bound_ms", "library_ms")}
              for k, v in rows.items()}
    for k, v in rows.items():
        log(f"[{tag}] {k.upper()} on {smi}, each of the step's {len(v)} "
            f"BatchNorm inputs (bf16), device ms (CUDA graph) / bound ms / "
            f"library ms: " + "; ".join(
                f"{'x'.join(map(str, r['shape']))} {r['ms']:.5f} / "
                f"{r['bound_ms']:.5f} / {r['library_ms']:.5f}" for r in v))
        tot = totals[k]
        log(f"[{tag}] {k.upper()} a step: {tot['ms']:.5f} ms device, "
            f"{tot['bound_ms'] / tot['ms'] * 100:.1f} % of the bound "
            f"{tot['bound_ms']:.5f} (bytes); plain {tot['plain_ms']:.4f}; "
            f"library {tot['library_ms']:.5f}; against the plain version max "
            f"abs {errors[k]['max_abs_err']:.3e}, max rel "
            f"{errors[k]['max_rel_err']:.3e} (tolerance 1e-5), bit-equal "
            f"from call to call")
    return {"errors": errors, "rows": rows, "totals": totals}


def cut_nms_times(rows: dict, smi: str, tag: str) -> dict:
    """K1 on the serving calls' cut rows (1x512 and 32x512): device time
    (CUDA graph), the plain NMS's, the bound; bit-equal to the plain NMS."""
    from keras_object_detection_torch.ops.cuda_nms import \
        cuda_batched_non_max_suppression
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    out = {}
    for b, x in rows.items():
        x = x.contiguous()
        got = cuda_batched_non_max_suppression(x, 0.5, 0.4)
        want = batched_non_max_suppression(x, 0.5, 0.4)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"K1 differs from the plain NMS at {tuple(x.shape)}")
        bound, by = nms_bound_ms(x)
        out[f"{b}x{x.shape[1]}"] = {
            "ms": graph_ms(lambda: cuda_batched_non_max_suppression(
                x, 0.5, 0.4)),
            "plain_ms": cuda_ms(lambda: batched_non_max_suppression(
                x, 0.5, 0.4), 3, warmup=1),
            "bound_ms": bound, "bound_by": by}
    log(f"[{tag}] K1 on the serving calls' cut rows on {smi}, device ms "
        f"(CUDA graph) / plain ms / bound ms: " + "; ".join(
            f"{k} {v['ms']:.5f} / {v['plain_ms']:.4f} / {v['bound_ms']:.3e} "
            f"({v['bound_by']})" for k, v in out.items())
        + "; bit-equal to the plain NMS")
    return out


def family_fit(dev, smi: str, tag: str, base, n_train: int, n_val: int,
               n_bn: int) -> dict:
    """A 2-epoch Trainer.fit of ``base`` from a decoded cache at its size
    (``n_train`` / ``n_val`` images): K2/K3 ``n_bn`` and K4/K5 0 a step, K1
    2 a mAP update at N = max_candidates; mAP in [0, 1]; the card's mAP =
    the CPU's on the same grids (model, ground truth and noisy ground truth
    as prediction, the latter two as logits); ground truth gives AP 1."""
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import run_dataset_eval

    cfg = fit_config(tag, base=base)
    size = cfg.model.image_size
    train_dir, train_cache = fit_split(f"{tag}_train", n_train, 21, size)
    val_dir, val_cache = fit_split(f"{tag}_val", n_val, 22, size)
    d = cfg.data
    mk = lambda data, cache, train: YoloDataset(  # noqa: E731
        data, size, d.batch_size, max_boxes=d.max_boxes_per_image,
        shuffle=train, drop_remainder=train, seed=cfg.train.seed,
        cache_dir=cache)
    train_ds, val_ds = (mk(train_dir, train_cache, True),
                        mk(val_dir, val_cache, False))
    steps, map_updates = FIT_EPOCHS * len(train_ds), FIT_EPOCHS * len(val_ds)
    trainer, state, logs, counts, seconds = fit_run(cfg, train_ds, val_ds)
    check_fit_launches(tag, counts, steps, map_updates, bn=n_bn, loss=0)
    nms_n = {tuple(p.shape) for p in trainer.map_metric._pred}
    if nms_n != {(d.batch_size, cfg.eval.max_candidates, 6)}:
        raise SystemExit(f"the {tag} mAP's NMS ran at {nms_n}, not N = "
                         f"{cfg.eval.max_candidates}")
    for r in logs:
        if not (np.isfinite(r["val_loss"]) and np.isfinite(r["total"])
                and 0.0 <= r["val_mAP"] <= 1.0):
            raise SystemExit(f"{tag} fit, epoch {r['step']}: {r}")
    log(f"[{tag}] fit on {smi}: " + "; ".join(
        f"epoch {r['step'] + 1}: total {r['total']:.4f}, val_loss "
        f"{r['val_loss']:.4f}, val_mAP {r['val_mAP']:.6f}, "
        f"{r['images_per_s']:.1f} images/s, val {r['val_s']:.3f} s, mAP "
        f"{r['map_s'] * 1e3 / len(val_ds):.3f} ms an update" for r in logs)
        + f"; {seconds:.3f} s")
    stash = []
    run_dataset_eval(cfg, trainer._eval_step, trainer.map_metric, state,
                     val_ds, with_map=False, stash=stash)
    cpu = [(to_device(t, "cpu"), to_device(p, "cpu"),
            None if w is None else w.cpu()) for t, p, w in stash]

    def noisy(t):
        noise = lambda x: 0.3 * torch.rand(  # noqa: E731
            x.shape, generator=torch.Generator().manual_seed(3)).to(x.device)
        logits = gt_logits(cfg, t)
        if isinstance(logits, tuple):
            return tuple(x + noise(x) for x in logits)
        return logits + noise(logits)

    cuda_nms.LAUNCHES = 0
    checks = {}
    for what, predict in (
            ("model", None),
            ("ground truth", lambda t, p: gt_logits(cfg, t)),
            ("noisy ground truth", lambda t, p: noisy(t))):
        on_card, on_cpu = (map_on(cfg, dev, cpu, predict),
                           map_on(cfg, "cpu", cpu, predict))
        got, want = on_card.result(), on_cpu.result()
        aps, cpu_aps = on_card.result_per_class(), on_cpu.result_per_class()
        present = sorted(on_cpu.result_pr_curves())
        checks[what] = (got, want)
        log(f"[{tag}] mAP of the {what} as prediction on {len(cpu)} val "
            f"batches ({len(present)} of {len(aps)} classes present): card "
            f"{got!r}, CPU {want!r}, |diff| {abs(got - want):.3e}")
        if abs(got - want) > 1e-6 or np.abs(aps - cpu_aps).max() > 1e-6:
            raise SystemExit(f"the card's mAP differs from the CPU's ({what})")
        if what == "ground truth" and not (aps[present] >= 1.0 - 1e-5).all():
            raise SystemExit("ground truth as prediction does not give AP 1")
    trainer.close()
    del trainer, state, stash
    torch.cuda.empty_cache()
    return {"logs": logs, "counts": counts, "seconds": seconds,
            "map_checks": checks, "steps": steps, "map_updates": map_updates}


def family_phase(dev, tag: str, config, n_values: int, n_bn: int,
                 warmup_steps: tuple, ms_sizes: dict, fit_images: tuple,
                 profile_dir: str = "", bn_reps: tuple = (20, 5)) -> dict:
    """One detector family at full width (phases 12 and 13 of the module
    docstring): ``config(kernels)`` gives its configuration, ``n_values``
    its state_dict's size, ``n_bn`` its K2/K3 launches a step; timed steps,
    the loss on the card, K2/K3 on every call of one step, the kernel path
    against the plain one, serving at batch 1 and 32 behind the top-k cut,
    a 2-epoch fit of ``fit_images`` (train, val), and a step at each
    multiscale size of ``ms_sizes`` (size: S). Prints one JSON line
    ``{tag: ...}``; ``profile_dir`` adds a trace of 3 train steps."""
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step,
                                                    multiscale_grid)

    smi = card()
    t_phase = time.perf_counter()
    cfg = config()
    b = cfg.data.batch_size
    warmup, timed = warmup_steps
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(cfg, torch.Generator().manual_seed(0))
    values = sum(v.numel() for v in state.model.state_dict().values())
    if values != n_values:
        raise SystemExit(f"{tag} has {values} values, not {n_values}")
    batch = synthetic_batch(b, cfg.model.image_size,
                            cfg.data.max_boxes_per_image, dev)
    step = make_train_step(cfg)
    times, metrics, counts = time_steps(state, step, batch, seed=1,
                                        warmup=warmup, steps=timed)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    p50 = float(np.median(times))
    loss = metrics["total"].item()
    per_step = {k: v / timed for k, v in counts.items()}
    want = {"bn_stats": n_bn, "bn_grad_stats": n_bn,
            "yolo_loss_forward": 0, "yolo_loss_backward": 0}
    m, g, t = cfg.model, cfg.grid, cfg.train
    log(f"[{tag}] train on {smi}: {m.backbone} ({m.activation}) + {m.head} "
        f"head (passthrough={m.passthrough}, fpn_scales={m.fpn_scales}), "
        f"{m.image_size}², S={g.grid}, {len(g.anchors)} priors, "
        f"C={g.num_classes}, {m.compute_dtype}, {t.optimizer}, ignore "
        f"{t.ignore_threshold}, obj_target {t.obj_target}, bn_mode "
        f"{m.bn_mode}, {values} values, batch {b}: step p50 "
        f"{p50:.3f} ms (min {min(times):.3f}, max {max(times):.3f}), "
        f"{b / p50 * 1e3:.1f} images/s, peak device memory {peak:.3f} GiB, "
        f"loss {loss:.4f}; launches over {timed} steps {counts} "
        f"(expected a step {want})")
    if per_step != want or not np.isfinite(loss):
        raise SystemExit(f"{tag}: launches {per_step} a step (expected "
                         f"{want}), loss {loss}")
    out = {"card": smi, "values": values, "p50_ms": p50,
           "images_per_s": b / p50 * 1e3, "peak_gib": peak, "loss": loss,
           "counts": counts, "steps": timed}
    if profile_dir:
        profile_train(state, step, batch, profile_dir, f"{tag}_train_b{b}")
    out["loss_on_card"] = anchor_loss_on_card(cfg, step, state, batch, dev,
                                              smi, tag)
    calls = capture_kernel_calls(step, state, batch, 1)
    out["bn_kernels"] = step_bn_kernels(calls, smi, tag, n_bn, bn_reps)
    del calls
    sd = state.model.state_dict()
    del state, step
    torch.cuda.empty_cache()
    out["compare"] = compare_paths(dev, config, tag)

    serve = serve_variant(cfg, sd, dev, runs=(15, 10), stages=True)
    rows = serve.pop("nms_rows")
    log(f"[{tag}] serving on {smi}: {serve['candidates']} candidates an "
        f"image cut to {serve['nms_n']}; batch 1 p50 {serve['p50_ms_1']:.3f} "
        f"ms, batch 32 p50 {serve['p50_ms_32']:.3f} ms "
        f"({32 / serve['p50_ms_32'] * 1e3:.1f} images/s); stages (device "
        f"ms) at 1: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  serve["stages_1"].items())
        + "; at 32: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  serve["stages_32"].items())
        + f"; NMS kernel launches over 2 predict calls {serve['launches']}; "
        f"predict == plain NMS of the cut predict_decoded: {serve['ok']}")
    if not serve["ok"] or serve["nms_n"] != cfg.eval.max_candidates:
        raise SystemExit(f"{tag} serving failed its checks")
    out["serve"] = serve
    out["nms_times"] = cut_nms_times(rows, smi, tag)
    del rows, sd
    torch.cuda.empty_cache()

    out["fit"] = family_fit(dev, smi, tag, config(), *fit_images, n_bn)

    state = create_train_state(cfg, torch.Generator().manual_seed(0))
    big = synthetic_batch(b, max(ms_sizes), cfg.data.max_boxes_per_image, dev)
    out["multiscale"] = {}
    for size, s in ms_sizes.items():
        grid = multiscale_grid(cfg, size)
        if grid != s:
            raise SystemExit(f"{tag} multiscale grid {grid} at {size}, "
                             f"expected {s}")
        step = make_train_step(cfg, image_size=size, grid=grid)
        times, metrics, counts = time_steps(state, step, big, seed=1,
                                            warmup=1, steps=1)
        loss = metrics["total"].item()
        log(f"[{tag}] multiscale {size}² (S={grid}) on {smi}: one step "
            f"{times[0]:.3f} ms after one warm-up, loss {loss:.4f}, launches "
            f"{counts}")
        if not np.isfinite(loss) or counts["bn_stats"] != n_bn:
            raise SystemExit(f"{tag} multiscale step at {size} failed")
        out["multiscale"][size] = {"ms": times[0], "loss": loss,
                                   "counts": counts}
        del step
    del state, big, batch
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] {out['seconds']:.1f} s")
    bn = out["bn_kernels"]
    print(json.dumps({tag: {
        "card": smi, "values": values, "p50_ms": p50,
        "images_per_s": out["images_per_s"], "peak_gib": peak,
        "loss": out["loss"], "counts": counts, "steps": timed,
        "loss_on_card": out["loss_on_card"], "compare": out["compare"],
        "bn_errors": bn["errors"], "bn_totals": bn["totals"],
        "bn_rows": bn["rows"], "serve": serve, "nms_times": out["nms_times"],
        "fit": {k: v for k, v in out["fit"].items()},
        "multiscale": out["multiscale"], "seconds": out["seconds"]}},
        default=lambda x: list(x) if isinstance(x, tuple) else str(x)))
    return out


def phase_yolov2(dev, profile_dir: str = "") -> dict:
    """YOLOv2 at full width (see the module docstring, phase 12)."""
    return family_phase(dev, "yolov2", yolov2_config, YOLOV2_VALUES,
                        YOLOV2_BN, (YOLOV2_WARMUP, YOLOV2_STEPS),
                        YOLOV2_SIZES, (YOLOV2_FIT_TRAIN, YOLOV2_FIT_VAL),
                        profile_dir)


# the yolov3 phase: the port's yolov3_config() (Darknet-53 + the 3-scale FPN
# head at 416², the paper's 9 priors, C = 20, bf16, batch 32, adam, ignore
# 0.5, IoU objectness) with the BN-statistics kernels on
YOLOV3_BN = 72  # K2 and K3 a step: 52 in Darknet-53, 20 in the FPN head
# state_dict values at full width (tests/test_torch_fpn_model.py holds its
# names and shapes against the JAX model's)
YOLOV3_VALUES = 61_704_961
YOLOV3_WARMUP, YOLOV3_STEPS = 3, 5
YOLOV3_SIZES = {320: 10, 608: 19}  # the coarsest S (then 2S and 4S)
YOLOV3_FIT_TRAIN, YOLOV3_FIT_VAL = 128, 64


def yolov3_config(kernels: bool = True):
    """The port's yolov3_config() (YOLOv3 as published, see its
    docstring); ``kernels`` picks bn_mode fused (K2/K3) or flax."""
    from keras_object_detection_torch.config import yolov3_config as base

    cfg = base()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bn_mode="fused" if kernels else "flax"))


def phase_yolov3(dev, profile_dir: str = "") -> dict:
    """YOLOv3 at full width (see the module docstring, phase 13): K2/K3 at
    72 shapes are timed as graphs of 10 calls replayed 3 times, to keep
    the phase short."""
    return family_phase(dev, "yolov3", yolov3_config, YOLOV3_VALUES,
                        YOLOV3_BN, (YOLOV3_WARMUP, YOLOV3_STEPS),
                        YOLOV3_SIZES, (YOLOV3_FIT_TRAIN, YOLOV3_FIT_VAL),
                        profile_dir, bn_reps=(10, 3))


# the serving_extras and int8 phases: the flagship, YOLOv3 (both at batch 1
# and 32) and YOLOv2 (batch 1) at full width, seeded weights and BatchNorm
# statistics drawn from their own generator
INT8_OPS_PER_S = 1979e12  # dense int8 on the tensor cores (TOP/s)
SOFT_NMS_RTOL = 1e-5  # decayed confidences, card against CPU: see below
EXTRAS_NMS_CASES = ("tied 4x49", "one class 4x196", "identical boxes 4x49",
                    "identical boxes, tied 2x1024", "signed zeros",
                    "iou tie 0.3", "iou tie 0.5", "iou tie 0.7")


def serving_weights(tag: str):
    """``(config, state_dict)`` of ``tag`` (flagship, yolov2, yolov3) on the
    CPU: build_model's seeded weights, and BatchNorm statistics and affine
    terms drawn from a seeded generator (means N(0, 0.1), variances U(0.5,
    2), scales U(0.8, 1.2), biases N(0, 0.05)), so that a fold is no
    identity."""
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.models import build_model

    cfg = {"flagship": voc_full_config, "yolov2": yolov2_config,
           "yolov3": yolov3_config}[tag]()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    g = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.endswith("bn.running_mean"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.1)
        elif k.endswith("bn.running_var"):
            v.copy_(torch.rand(v.shape, generator=g) * 1.5 + 0.5)
        elif k.endswith("bn.weight"):
            v.copy_(torch.rand(v.shape, generator=g) * 0.4 + 0.8)
        elif k.endswith("bn.bias"):
            v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    return cfg, sd


def serving_images(cfg, batch: int, dev, seed: int = 7) -> torch.Tensor:
    size = cfg.model.image_size
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (batch, size, size, 3), np.uint8)).to(dev)


def call_p50(fn, runs: int) -> float:
    """Median host milliseconds of ``fn`` with a synchronise after each
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def nms_mode_fn(mode: str):
    """``rows -> (rows, valid)`` of an NMS mode at IoU 0.5 (or the case's),
    confidence 0.4, sigma 0.5."""
    from keras_object_detection_torch.ops.nms import (
        batched_fast_non_max_suppression, batched_soft_non_max_suppression)

    if mode == "fast":
        return batched_fast_non_max_suppression
    return lambda rows, iou=0.5, conf=0.4: batched_soft_non_max_suppression(
        rows, iou, conf, 0.5, mode)


def same_nms_result(card, cpu, rtol: float) -> tuple:
    """(equal keep sets, order, classes and boxes; largest relative
    difference of column 1), card against CPU."""
    rows, valid = (t.cpu() for t in card)
    want_rows, want_valid = cpu
    fixed = [0, 2, 3, 4, 5]
    same = (torch.equal(valid, want_valid)
            and torch.equal(rows[..., fixed], want_rows[..., fixed]))
    denom = want_rows[..., 1].abs().clamp_min(1e-30)
    rel = float(((rows[..., 1] - want_rows[..., 1]).abs() / denom).max())
    return same and rel <= rtol, rel


def phase_serving_extras(dev) -> dict:
    """Soft and fast NMS and the staged latency on the card (see the module
    docstring, phase 14)."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.cuda_nms import \
        cuda_batched_non_max_suppression
    from keras_object_detection_torch.ops.nms import (
        batched_non_max_suppression, top_k_candidates)

    smi = card()
    t_phase = time.perf_counter()
    out = {"card": smi, "modes": {}, "nms": {}, "checks": {}}
    cfg, sd = serving_weights("yolov3")
    images = {b: serving_images(cfg, b, dev) for b in (1, 32)}
    model = InferenceModel(cfg, sd)
    cut = {b: top_k_candidates(model.predict_decoded(images[b]),
                               cfg.eval.max_candidates).contiguous()
           for b in (1, 32)}
    del model
    # seeded weights put no confidence above 0.4: serve at the median of the
    # cut candidates', so that half of them take part
    thr = float(cut[32][..., 1].median())
    out["conf_threshold"] = thr
    for mode in ("hard", "soft_gaussian", "soft_linear", "fast"):
        mcfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, nms_mode=mode, conf_threshold=thr))
        model = InferenceModel(mcfg, sd)
        # the main path of each mode: counts at 0 just before, read after
        cuda_nms.LAUNCHES = 0
        served = {b: model.predict(images[b]) for b in (1, 32)}
        torch.cuda.synchronize()
        launches = cuda_nms.LAUNCHES
        if launches != (2 if mode == "hard" else 0):
            raise SystemExit(f"[serving_extras] {mode}: K1 launched "
                             f"{launches} times in 2 predict calls")
        fn = (nms_mode_fn(mode.removeprefix("soft_")) if mode != "hard"
              else batched_non_max_suppression)
        for b, (rows, valid) in served.items():
            ok, _ = same_nms_result((rows, valid),
                                    fn(cut[b].cpu(), 0.5, thr), SOFT_NMS_RTOL)
            if not ok or not bool(torch.isfinite(rows).all()):
                raise SystemExit(f"[serving_extras] {mode} predict at batch "
                                 f"{b} differs from its NMS on the CPU")
        out["modes"][mode] = {
            "k1_launches": launches, "kept_32": int(served[32][1].sum()),
            **{f"p50_ms_{b}": model.benchmark_latency(
                images[b], runs=5)["p50_ms"] for b in (1, 32)}}
        del model, served
    torch.cuda.empty_cache()
    log(f"[serving_extras] YOLOv3 serving p50 by nms_mode on {smi}, conf "
        f"threshold {thr:.4f} (batch 1 / 32, ms): " + "; ".join(
            f"{m} {v['p50_ms_1']:.3f} / {v['p50_ms_32']:.3f} (K1 "
            f"{v['k1_launches']} in 2 calls, kept {v['kept_32']} at 32)"
            for m, v in out["modes"].items())
        + "; each predict == its NMS of the cut rows on the CPU")

    # each mode on the card against the plain torch version on the CPU
    cases = {f"yolov3 {b}x512": (cut[b], 0.5, thr) for b in (1, 32)}
    for name in EXTRAS_NMS_CASES:
        rows, iou, conf = NMS_CASES[name]()
        cases[name] = (torch.from_numpy(rows).to(dev), iou, conf)
    worst = 0.0
    for name, (rows, iou, conf) in cases.items():
        for mode in ("gaussian", "linear", "fast"):
            fn = nms_mode_fn(mode)
            ok, rel = same_nms_result(fn(rows, iou, conf),
                                      fn(rows.cpu(), iou, conf),
                                      SOFT_NMS_RTOL)
            out["checks"][f"{mode} {name}"] = rel
            worst = max(worst, rel)
            if not ok:
                raise SystemExit(f"[serving_extras] {mode} NMS on the card "
                                 f"differs from the CPU's on {name} (decayed "
                                 f"confidences within {rel:.3e})")
    log(f"[serving_extras] soft gaussian, soft linear and fast NMS on the "
        f"card = the plain version on the CPU on {len(cases)} cases: keep "
        f"sets, order, classes and boxes equal, decayed confidences within "
        f"{worst:.3e} relative (limit {SOFT_NMS_RTOL})")

    for b in (1, 32):
        rows = cut[b]
        t = {"k1": {"ms": graph_ms(lambda: cuda_batched_non_max_suppression(
                 rows, 0.5, thr)),
                 "call_p50_ms": call_p50(lambda: cuda_batched_non_max_suppression(
                     rows, 0.5, thr), 20)}}
        for mode in ("gaussian", "linear", "fast"):
            fn = nms_mode_fn(mode)
            t[mode] = {"ms": cuda_ms(lambda: fn(rows, 0.5, thr), 3, warmup=1),
                       "call_p50_ms": call_p50(lambda: fn(rows, 0.5, thr), 5)}
        out["nms"][f"{b}x512"] = t
        log(f"[serving_extras] NMS at {b}x512 (YOLOv3's cut rows) on {smi}, "
            f"device ms / per-call p50 ms: " + "; ".join(
                f"{k} {v['ms']:.4f} / {v['call_p50_ms']:.4f}"
                for k, v in t.items()))

    fcfg, fsd = serving_weights("flagship")
    model = InferenceModel(fcfg, fsd)
    x = serving_images(fcfg, 1, dev)
    staged_rows = model._staged(x)
    rows = model.predict(x)
    if not (torch.equal(staged_rows[0], rows[0])
            and torch.equal(staged_rows[1], rows[1])):
        raise SystemExit("[serving_extras] staged predict differs")
    fused = model.benchmark_latency(x, runs=20, pipeline_k=20)
    staged = model.benchmark_latency(x, runs=20, staged=True, pipeline_k=20)
    if set(fused) != set(staged):
        raise SystemExit("[serving_extras] staged latency keys differ")
    out["staged"] = {"fused": fused, "staged": staged}
    log(f"[serving_extras] flagship batch 1 on {smi}: fused p50 "
        f"{fused['p50_ms']:.3f} ms (pipelined "
        f"{fused['pipelined_per_call_ms']:.3f}), staged p50 "
        f"{staged['p50_ms']:.3f} ms (pipelined "
        f"{staged['pipelined_per_call_ms']:.3f}); same rows")
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[serving_extras] {out['seconds']:.1f} s")
    print(json.dumps({"serving_extras": out}))
    return out


def as_grids(y) -> tuple:
    return tuple(y) if isinstance(y, (tuple, list)) else (y,)


def int8_conv_layers(model, x) -> list:
    """``(xq shape, w_q shape, stride, pad)`` of every int8 conv of one
    forward of the int8 ``model`` on ``x``."""
    from keras_object_detection_torch.export import int8_serving

    seen = []
    route = int8_serving.int8_conv2d

    def record(xq, w_q, stride, pad):
        seen.append((tuple(xq.shape), tuple(w_q.shape), stride, pad))
        return route(xq, w_q, stride, pad)

    with unittest.mock.patch.object(int8_serving, "int8_conv2d", record):
        model.predict_raw(x)
    return seen


def int8_layer_times(layer, dev) -> dict:
    """One int8 conv at its serving shape: the route (im2col + _int_mm),
    _int_mm alone, the plain float64 GEMM, the bf16 cuDNN conv of the same
    layer and the bound (each input read once, the int32 output written
    once, against 2*M*N*K operations at the int8 tensor-core rate)."""
    import torch.nn.functional as F

    from keras_object_detection_torch.ops import int8_conv

    xs, ws, stride, pad = layer
    g = torch.Generator(device="cpu").manual_seed(3)
    xq = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8).to(dev)
    wq = torch.randint(-127, 128, ws, generator=g, dtype=torch.int8).to(dev)
    a, (b, ho, wo) = int8_conv.im2col(xq, ws[1], stride, pad)
    w = int8_conv._kernel_matrix(wq, a.shape[1])
    m, k, n = a.shape[0], ws[1] * ws[2] * ws[3], ws[0]
    route = cuda_ms(lambda: int8_conv.int8_conv2d(xq, wq, stride, pad), 20)
    mm = cuda_ms(lambda: torch._int_mm(a, w.t()), 20)
    plain = cuda_ms(lambda: int8_conv.plain_int8_matmul(a, w), 3, warmup=1)
    wb = wq.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels-last OIHW
    if isinstance(pad, int):  # the padding inside the conv, as the route's
        xb, conv_pad = xq.to(torch.bfloat16).permute(0, 3, 1, 2), pad
    else:
        xb, conv_pad = int8_conv.pad_nhwc(xq, ws[1], stride, pad).to(
            torch.bfloat16).permute(0, 3, 1, 2), 0
    bf16 = cuda_ms(lambda: F.conv2d(xb, wb, None, stride, conv_pad), 20)
    nbytes = xq.numel() + wq.numel() + m * n * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return {"x": list(xs), "w_ohwi": list(ws), "stride": stride,
            "pad": pad, "m": m, "k": k, "n": n, "route_ms": route,
            "int_mm_ms": mm, "plain_ms": plain, "bf16_cudnn_ms": bf16,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


INT8_PHASE = {"flagship": (1, 32), "yolov3": (1, 32), "yolov2": (1,)}


def phase_int8(dev) -> dict:
    """Int8 serving at full width (see the module docstring, phase 15)."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.export import (Int8InferenceModel,
                                                     QuantizedInferenceModel,
                                                     select_serving_model)
    from keras_object_detection_torch.ops import cuda_nms, int8_conv
    from keras_object_detection_torch.ops.nms import (
        batched_non_max_suppression, top_k_candidates)

    smi = card()
    t_phase = time.perf_counter()
    out = {"card": smi, "tf32": torch.backends.cudnn.allow_tf32}
    acc_shapes = {}
    route_matmul = int8_conv.int8_matmul

    def checked(a, w):  # the route, held against the plain GEMM
        got = route_matmul(a, w)
        key = "x".join(map(str, (a.shape[0], a.shape[1], w.shape[0])))
        acc_shapes[key] = acc_shapes.get(key, True) and torch.equal(
            got, int8_conv.plain_int8_matmul(a, w))
        return got

    for tag, batches in INT8_PHASE.items():
        cfg, sd = serving_weights(tag)
        e = cfg.eval
        images = {b: serving_images(cfg, b, dev) for b in batches}
        model = Int8InferenceModel(cfg, sd)  # the default device: the GPU
        # as in phase 14: the median candidate confidence as the filter
        decoded = model.predict_decoded(images[batches[-1]])
        if e.max_candidates:
            decoded = top_k_candidates(decoded, e.max_candidates)
        e = dataclasses.replace(e, conf_threshold=float(
            decoded[..., 1].median()))
        cfg = dataclasses.replace(cfg, eval=e)
        model.config = cfg
        del decoded
        n_int8 = sum("w_q" in layer for layer in model.layers)
        res = {"int8_convs": n_int8, "layers": len(model.layers),
               "conf_threshold": e.conf_threshold}
        # the main path: counts at 0 just before, read just after
        cuda_nms.LAUNCHES = int8_conv.LAUNCHES = 0
        served = {b: model.predict(images[b]) for b in batches}
        torch.cuda.synchronize()
        res["k1_launches"], res["int8_launches"] = (cuda_nms.LAUNCHES,
                                                    int8_conv.LAUNCHES)
        if (res["k1_launches"] != len(batches)
                or res["int8_launches"] != n_int8 * len(batches)):
            raise SystemExit(f"[int8] {tag}: K1 {res['k1_launches']}, int8 "
                             f"GEMMs {res['int8_launches']} in "
                             f"{len(batches)} predict calls (expected 1 and "
                             f"{n_int8} a call)")
        for b, (rows, valid) in served.items():
            decoded = model.predict_decoded(images[b])
            res[f"candidates_{b}"] = decoded.shape[1]
            if e.max_candidates and decoded.shape[1] > e.max_candidates:
                decoded = top_k_candidates(decoded, e.max_candidates)
            plain = batched_non_max_suppression(decoded, e.iou_threshold,
                                                e.conf_threshold)
            if not (torch.equal(plain[0], rows) and torch.equal(plain[1], valid)
                    and bool(torch.isfinite(rows).all())):
                raise SystemExit(f"[int8] {tag} batch {b}: predict() differs "
                                 "from the plain NMS of predict_decoded()")
            res[f"kept_{b}"] = int(valid.sum())
        with unittest.mock.patch.object(int8_conv, "int8_matmul", checked):
            for b in batches:
                model.predict_raw(images[b])
        torch.backends.cudnn.deterministic = True
        try:
            for b in batches:
                route = as_grids(model.predict_raw(images[b]))
                with unittest.mock.patch.object(
                        int8_conv, "int8_matmul", int8_conv.plain_int8_matmul):
                    plain = as_grids(model.predict_raw(images[b]))
                if not all(torch.equal(r, p) for r, p in zip(route, plain)):
                    raise SystemExit(f"[int8] {tag} batch {b}: predict_raw on "
                                     "the route differs from the plain GEMM")
        finally:
            torch.backends.cudnn.deterministic = False
        fmodel = InferenceModel(cfg, sd)
        for b in batches:
            x = images[b]
            yq, yf = as_grids(model.predict_raw(x)), as_grids(
                fmodel.predict_raw(x))
            res[f"rel_err_{b}"] = max(rel_norm(q, f.float())
                                      for q, f in zip(yq, yf))
            runs = 20 if b == 1 else 10
            res[f"p50_ms_{b}"] = model.benchmark_latency(x, runs=runs)["p50_ms"]
            res[f"float_p50_ms_{b}"] = fmodel.benchmark_latency(
                x, runs=runs)["p50_ms"]
            res[f"stages_{b}"] = stage_ms(model, x)
            res[f"float_stages_{b}"] = stage_ms(fmodel, x)
        res["memory"] = model.memory_footprint()
        if tag == "flagship":
            res["layer_shapes"] = int8_conv_layers(model, images[32])
        out[tag] = res
        log(f"[int8] {tag} on {smi}: {n_int8} int8 convs of {len(model.layers)} "
            f"layers; K1 {res['k1_launches']} and int8 GEMMs "
            f"{res['int8_launches']} in {len(batches)} predict calls; "
            f"predict == plain NMS; predict_raw route == plain GEMM; "
            f"p50 int8 / float (ms): " + ", ".join(
                f"batch {b} {res[f'p50_ms_{b}']:.3f} / "
                f"{res[f'float_p50_ms_{b}']:.3f}" for b in batches)
            + "; int8 stages (device ms): " + "; ".join(
                f"{b}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                     res[f"stages_{b}"].items())
                for b in batches)
            + f"; grids' relative distance to float "
            + ", ".join(f"{res[f'rel_err_{b}']:.4f}" for b in batches)
            + f"; weights {res['memory']['quantized_bytes']} bytes int8, "
            f"{res['memory']['float_bytes']} float")
        del model, fmodel, images, served
        torch.cuda.empty_cache()
        if tag == "flagship":
            flagship = (cfg, sd)
    if not all(acc_shapes.values()):
        raise SystemExit(f"[int8] route accumulators differ from the plain "
                         f"GEMM at {[k for k, v in acc_shapes.items() if not v]}")
    out["acc_shapes"] = sorted(acc_shapes)
    log(f"[int8] s32 accumulators of the route torch.equal to the plain "
        f"float64 GEMM at all {len(acc_shapes)} (M x K8 x N8) shapes of the "
        f"three plans")

    cfg, sd = flagship
    layers = out["flagship"].pop("layer_shapes")
    heavy = max(layers, key=lambda s: s[0][0] * s[0][1] * s[0][2]
                * s[1][0] * s[1][1] * s[1][2] * s[1][3] // s[2] ** 2)
    out["gemm"] = int8_layer_times(heavy, dev)
    g = out["gemm"]
    log(f"[int8] the flagship's heaviest int8 conv at batch 32 ({g['x']} * "
        f"{g['w_ohwi']}, stride {g['stride']}; M {g['m']} K {g['k']} N "
        f"{g['n']}) on {smi}: route {g['route_ms']:.4f} ms, _int_mm "
        f"{g['int_mm_ms']:.4f}, plain float64 GEMM {g['plain_ms']:.4f}, "
        f"bf16 cuDNN conv {g['bf16_cudnn_ms']:.4f}, bound {g['bound_ms']:.4f} "
        f"({g['bound_by']})")

    rng = np.random.RandomState(11)
    calib = rng.randint(0, 256, (8, 448, 448, 3), np.uint8)
    x1 = serving_images(cfg, 1, dev)
    f1 = InferenceModel(cfg, sd).predict_raw(x1).float()
    variants = {}
    for name, kw in (("dynamic", {}),
                     ("static", dict(calib_images=calib)),
                     ("bias_corrected", dict(calib_images=calib,
                                             bias_correct=True)),
                     ("qat", dict(calib_images=calib, qat_steps=2,
                                  qat_batch=4))):
        t0 = time.perf_counter()
        m = Int8InferenceModel(cfg, sd, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        y = m.predict_raw(x1)
        if not bool(torch.isfinite(y).all()):
            raise SystemExit(f"[int8] the {name} flagship is not finite")
        variants[name] = {"build_s": build_s, "rel_err": rel_norm(y, f1),
                          "p50_ms_1": m.benchmark_latency(x1, runs=10)[
                              "p50_ms"]}
        if name == "qat":
            variants[name]["qat_info"] = m.qat_info
        del m
    out["variants"] = variants
    model, info = select_serving_model(cfg, sd, "auto")
    out["auto"] = info
    if info["chosen"] != ("int8" if info["int8_p50_ms"] <= info["float_p50_ms"]
                          else "float"):
        raise SystemExit(f"[int8] select_serving_model chose against its "
                         f"probe: {info}")
    del model
    qmodel = QuantizedInferenceModel(cfg, sd)
    out["weight_only"] = {"p50_ms_1": qmodel.benchmark_latency(
        x1, runs=10)["p50_ms"], **qmodel.memory_footprint()}
    del qmodel
    torch.cuda.empty_cache()
    log(f"[int8] flagship variants on {smi} (build s, grid distance to float "
        f"at batch 1, p50 ms at 1): " + "; ".join(
            f"{k} {v['build_s']:.2f} / {v['rel_err']:.4f} / "
            f"{v['p50_ms_1']:.3f}" for k, v in variants.items())
        + f"; QAT {variants['qat']['qat_info']}; select_serving_model(auto) "
        f"{info}; weight-only int8 p50 {out['weight_only']['p50_ms_1']:.3f} ms"
        f", {out['weight_only']['quantized_bytes']} of "
        f"{out['weight_only']['float_bytes']} bytes")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[int8] {out['seconds']:.1f} s")
    print(json.dumps({"int8": out}, default=str))
    return out


def family_kernel_entry(out: dict, name: str, tag: str) -> dict:
    """A family phase's keys of one kernel's entry in the kernels line."""
    fit = out["fit"]
    entry = {f"launches_{tag}": out["counts"].get(name, 0),
             f"launches_{tag}_steps": out["steps"],
             f"launches_{tag}_fit": fit["counts"].get(name, 0)}
    key = {"bn_stats": "k2", "bn_grad_stats": "k3"}.get(name)
    if key:
        tot = out["bn_kernels"]["totals"][key]
        err = out["bn_kernels"]["errors"][key]
        entry.update({f"{f}_{tag}": tot[f] for f in
                      ("ms", "plain_ms", "bound_ms", "library_ms")})
        entry.update({f"max_rel_err_{tag}": err["max_rel_err"],
                      f"shapes_{tag}": len(out["bn_kernels"]["rows"][key])})
    return entry


def profile_train(state, step, batch, profile_dir: str,
                  name: str = "train_b64") -> None:
    """A torch.profiler trace of 3 steps: ``name``.json.gz and its
    key_averages table ``name``.txt in ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, *batch, 1)
        torch.cuda.synchronize()
    trace = os.path.join(profile_dir, f"{name}.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(profile_dir, f"{name}.txt"), "w") as f:
        f.write(table)
    log(table)


# phase parallel: data parallelism on the card
PARALLEL_DIR = os.path.join("build", "parallel")
PARALLEL_WARMUP, PARALLEL_STEPS = 2, 5
# float32 updates of the two-rank step, in norm: the worst parameter and
# the median parameter each within twice what the one process's step
# parts from itself with its batch reversed (the order of its sums alone
# changes), or these, whichever is larger
PARALLEL_UPDATE_RTOL = 2e-2
PARALLEL_MEDIAN_RTOL = 1e-4
PARALLEL_LOSS_RTOL = 1e-4  # its loss and running statistics
# wrong reductions planted in the two ranks' step (``planted``), each of
# which the comparison above must catch
PLANTED_FAULTS = ("bn_stats_local", "bn_grad_stats_local", "grads_averaged")
PARALLEL_SERVE_BATCH = 16
FLAGSHIP_BN_LAUNCHES = {"bn_stats": 25, "bn_grad_stats": 25,
                        "yolo_loss_forward": 1, "yolo_loss_backward": 1}


def parallel_f32_config():
    """The flagship at full width in float32 with SGD: the two-rank step's
    yardstick (bf16 rounding makes the early layers' gradients at a random
    init nearly independent of the summation order, see compare_paths)."""
    cfg = train_config(True)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, optimizer="sgd"))


@contextlib.contextmanager
def planted(fault):
    """Inside the block the data-parallel step reduces wrongly, as a bug
    would (``None``: as it should): ``bn_stats_local`` the training
    BatchNorms normalise with their rank's own statistics (K2's sums not
    all-reduced), ``bn_grad_stats_local`` K3's sums are not all-reduced
    (the forward's are), ``grads_averaged`` the gradients are averaged over
    the ranks instead of summed."""
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.parallel import distributed

    saved = bn.bn_batch_stats, bn.all_reduce_, distributed.all_reduce_flat_
    stats, reduce_, flat_ = saved
    if fault == "bn_stats_local":
        bn.bn_batch_stats = lambda x, group=None: stats(x, None)
    elif fault == "bn_grad_stats_local":
        def forward_reduced(x, group=None):
            bn.all_reduce_ = reduce_
            try:
                return stats(x, group)
            finally:
                bn.all_reduce_ = lambda t, group: t

        bn.bn_batch_stats = forward_reduced
        bn.all_reduce_ = lambda t, group: t
    elif fault == "grads_averaged":
        def averaged(tensors, group):
            flat_(tensors, group)
            for t in tensors:
                t.div_(distributed.world_size(group))

        distributed.all_reduce_flat_ = averaged
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        bn.bn_batch_stats, bn.all_reduce_, distributed.all_reduce_flat_ = saved


@contextlib.contextmanager
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def dp_step(cfg, dev, group, seed: int = 5, reverse: bool = False,
            state=None):
    """One step of ``cfg`` from seeded weights on this rank's block of the
    synthetic global batch of 64 with the global batch's draws (the same
    on every rank); deterministic cuDNN. The images' brightness ramps down
    the batch, so that the ranks' row blocks differ in their statistics
    (noise rows all alike would hide a rank that normalised with its own).
    ``reverse``: the batch and its draws in reverse order, which changes
    only the order of the step's sums. ``state``: those seeded weights,
    already built (the step updates it in place). Returns (state,
    metrics)."""
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step,
                                                    sample_step_draws)

    world, rank = distributed.world_size(group), distributed.rank_of(group)
    b = cfg.data.batch_size
    if state is None:
        state = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    images, boxes, valid = synthetic_batch(b, cfg.model.image_size,
                                           cfg.data.max_boxes_per_image, dev)
    ramp = torch.linspace(1.0, 0.25, b, device=dev)[:, None, None, None]
    batch = ((images.float() * ramp).to(torch.uint8), boxes, valid)
    own = slice(rank * b // world, (rank + 1) * b // world)
    draws = sample_step_draws(cfg, state.model, b, seed, 0)
    if reverse:
        batch = tuple(t.flip(0) for t in batch)
        draws = [x.replaced(iter([t.flip(0) for t in x.tensors()]))
                 for x in draws]
    with deterministic_cudnn():
        state, metrics = make_train_step(cfg, group=group)(
            state, *(t[own] for t in batch), seed, draws=draws)
        torch.cuda.synchronize()
    return state, metrics


def dp_timed(cfg, dev, group) -> dict:
    """PARALLEL_WARMUP then PARALLEL_STEPS timed steps of ``cfg`` on this
    rank's block: p50 ms, the kernels' launches and the collectives of the
    timed steps (counts at 0 just before, read just after)."""
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    world, rank = distributed.world_size(group), distributed.rank_of(group)
    b = cfg.data.batch_size
    state = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    batch = synthetic_batch(b, cfg.model.image_size,
                            cfg.data.max_boxes_per_image, dev)
    own = slice(rank * b // world, (rank + 1) * b // world)
    step = make_train_step(cfg, group=group)
    for _ in range(PARALLEL_WARMUP):
        state, metrics = step(state, *(t[own] for t in batch), 1)
    torch.cuda.synchronize()
    reset_kernel_counts()
    distributed.reset_counts()
    times = []
    for _ in range(PARALLEL_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, *(t[own] for t in batch), 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernel_counts()
    n_grad = sum(p.numel() for p in state.model.parameters())
    return {"p50_ms": float(np.median(times)), "counts": counts,
            "all_reduces": distributed.ALL_REDUCES,
            "all_reduce_bytes": distributed.ALL_REDUCE_BYTES,
            "gathers": distributed.GATHERS, "loss": metrics["total"].item(),
            "grad_values": n_grad, "rows": own.stop - own.start}


def all_reduce_ms(n: int, dev, group, reps: int = 10) -> float:
    """Device milliseconds (CUDA events) of one SUM all-reduce of ``n``
    float32 values, the flat gradient bucket of a step."""
    import torch.distributed as dist

    flat = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(2):
        dist.all_reduce(flat, group=group)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        dist.all_reduce(flat, group=group)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_step_counts(tag: str, res: dict) -> None:
    per_step = {k: v / PARALLEL_STEPS for k, v in res["counts"].items()}
    if per_step != FLAGSHIP_BN_LAUNCHES:
        raise SystemExit(f"[parallel] {tag}: launched {per_step} a step, "
                         f"expected {FLAGSHIP_BN_LAUNCHES}")


def parallel_rank(job_path: str) -> int:
    """One rank of phase parallel (b): joins the group the environment
    describes (``job["backend"]``; gloo with CUDA tensors on one card), takes
    the float32 step (every rank saves its state), the same step with each
    of PLANTED_FAULTS (rank 0 saves its state) and the timed bf16
    kernel-path steps, and writes its results."""
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import create_train_state

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.maybe_initialize(backend=job["backend"])
    group = torch.distributed.group.WORLD
    cfg = parallel_f32_config()
    seeded = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    for fault in (None,) + PLANTED_FAULTS:
        with planted(fault):
            state, metrics = dp_step(cfg, dev, group,
                                     state=copy.deepcopy(seeded))
        if rank == 0 or fault is None:
            torch.save({"model": {k: v.cpu() for k, v in
                                  state.model.state_dict().items()},
                        "loss": metrics["total"].item()},
                       os.path.join(job["dir"], f"{job['tag']}_"
                                    f"{fault or 'f32'}_rank{rank}.pt"))
        del state
    del seeded
    torch.cuda.empty_cache()
    res = dp_timed(train_config(True), dev, group)
    res["all_reduce_ms"] = all_reduce_ms(res["grad_values"], dev, group, 3)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with open(os.path.join(job["dir"], f"{job['tag']}_rank{rank}.json"),
              "w") as f:
        json.dump(res, f)
    distributed.barrier(group)
    torch.distributed.destroy_process_group()
    return 0


def parallel_two_ranks(dev, tag: str, backend: str) -> dict:
    """Phase parallel (b): two ranks over ``backend`` against the one
    process's float32 step (loss and running statistics to
    PARALLEL_LOSS_RTOL; the parameters' updates in norm, the worst and the
    median within twice the one process's reversed-batch distance or
    PARALLEL_UPDATE_RTOL and PARALLEL_MEDIAN_RTOL), rank 1's state equal to
    rank 0's, each planted fault caught by the same comparison, and their
    timed kernel-path steps (25/25/1/1 a rank a step)."""
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.parallel import distributed

    ref, ref_metrics = dp_step(parallel_f32_config(), dev, None)
    want = {k: v.detach().cpu() for k, v in ref.model.state_dict().items()}
    del ref
    rev, _ = dp_step(parallel_f32_config(), dev, None, reverse=True)
    reordered = {k: v.detach().cpu() for k, v in rev.model.state_dict().items()}
    del rev
    torch.cuda.empty_cache()

    init = build_model(parallel_f32_config(),
                       torch.Generator().manual_seed(0)).state_dict()
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    job = os.path.join(PARALLEL_DIR, f"{tag}.json")
    with open(job, "w") as f:
        json.dump({"backend": backend, "dir": PARALLEL_DIR, "tag": tag}, f)
    t0 = time.perf_counter()
    rc = distributed.launch_local("chip_smoke", ["--parallel-rank", job], 2)
    wall = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"[parallel] {tag}: a rank exited with {rc}")
    ranks = []
    for r in range(2):
        with open(os.path.join(PARALLEL_DIR, f"{tag}_rank{r}.json")) as f:
            ranks.append(json.load(f))
    ref_loss = ref_metrics["total"].item()

    def distances(run):
        """(loss, running statistics, worst update with its tensor, median
        update) of a two-rank run's state against the one process's."""
        got = torch.load(os.path.join(PARALLEL_DIR, f"{tag}_{run}_rank0.pt"))
        stat, updates = 0.0, []
        for k, v in want.items():
            if "running" in k:
                stat = max(stat, rel_norm(got["model"][k], v))
            elif not zero_gradient(k) and k in init and v.is_floating_point():
                updates.append((rel_norm(got["model"][k] - init[k],
                                         v - init[k]), k))
        return (abs(got["loss"] - ref_loss) / abs(ref_loss), stat,
                max(updates), float(np.median([u for u, _ in updates])))

    reversed_updates = [(rel_norm(reordered[k] - init[k], v - init[k]), k)
                        for k, v in want.items()
                        if "running" not in k and not zero_gradient(k)
                        and k in init and v.is_floating_point()]
    worst_reordered = max(reversed_updates)
    median_reordered = float(np.median([u for u, _ in reversed_updates]))
    update_tol = max(PARALLEL_UPDATE_RTOL, 2 * worst_reordered[0])
    median_tol = max(PARALLEL_MEDIAN_RTOL, 2 * median_reordered)

    def caught(d):
        return (d[0] > PARALLEL_LOSS_RTOL or d[1] > PARALLEL_LOSS_RTOL
                or d[2][0] > update_tol or d[3] > median_tol)

    loss_err, worst_stat, worst_update, median_update = distances("f32")
    rank1 = torch.load(os.path.join(PARALLEL_DIR, f"{tag}_f32_rank1.pt"))
    rank0 = torch.load(os.path.join(PARALLEL_DIR, f"{tag}_f32_rank0.pt"))
    ranks_equal = rank1["loss"] == rank0["loss"] and all(
        torch.equal(v, rank1["model"][k]) for k, v in rank0["model"].items())
    del rank0, rank1
    faults = {}
    for fault in PLANTED_FAULTS:
        d = distances(fault)
        faults[fault] = {"loss_rel_err": d[0], "running_rel_err": d[1],
                         "update_rel_err": d[2][0],
                         "update_rel_err_tensor": d[2][1],
                         "median_update_rel_err": d[3], "caught": caught(d)}
    res = {"backend": backend, "wall_s": wall, "loss_rel_err": loss_err,
           "running_rel_err": worst_stat, "update_rel_err": worst_update[0],
           "update_rel_err_tensor": worst_update[1],
           "median_update_rel_err": median_update,
           "reversed_update_rel_err": worst_reordered[0],
           "reversed_update_rel_err_tensor": worst_reordered[1],
           "reversed_median_update_rel_err": median_reordered,
           "update_tol": update_tol, "median_tol": median_tol,
           "ranks_equal": ranks_equal, "faults": faults, "ranks": ranks}
    log(f"[parallel] ({tag}) 2 ranks over {backend} on "
        f"{sorted({r['rows'] for r in ranks})} rows each: float32 step loss "
        f"rel err {loss_err:.3e}, running statistics {worst_stat:.3e}, "
        f"worst update {worst_update[0]:.3e} in norm ({worst_update[1]}), "
        f"median update {median_update:.3e}; the one process against itself "
        f"with the batch reversed {worst_reordered[0]:.3e} "
        f"({worst_reordered[1]}), median {median_reordered:.3e}; tolerances "
        f"{PARALLEL_LOSS_RTOL}, {PARALLEL_LOSS_RTOL}, {update_tol:.3e}, "
        f"{median_tol:.3e}; rank 1's state equal to rank 0's {ranks_equal}")
    for fault, d in faults.items():
        log(f"[parallel] ({tag}) planted {fault}: loss rel err "
            f"{d['loss_rel_err']:.3e}, running statistics "
            f"{d['running_rel_err']:.3e}, worst update "
            f"{d['update_rel_err']:.3e} ({d['update_rel_err_tensor']}), "
            f"median update {d['median_update_rel_err']:.3e}: caught "
            f"{d['caught']}")
    for r, rr in enumerate(ranks):
        log(f"[parallel] ({tag}) rank {r}: bf16 kernel path p50 "
            f"{rr['p50_ms']:.3f} ms a step at {rr['rows']} rows, launches "
            f"{rr['counts']} over {PARALLEL_STEPS} steps, {rr['all_reduces']}"
            f" all-reduces ({rr['all_reduce_bytes'] / PARALLEL_STEPS / 1e6:.1f}"
            f" MB a step), gradient all-reduce {rr['all_reduce_ms']:.3f} ms, "
            f"peak {rr['peak_gib']:.3f} GiB")
        check_step_counts(f"({tag}) rank {r}", rr)
    if caught((loss_err, worst_stat, worst_update, median_update)):
        raise SystemExit(f"[parallel] ({tag}) the two-rank step parts from "
                         "the one-process step beyond its tolerance")
    if not ranks_equal:
        raise SystemExit(f"[parallel] ({tag}) rank 1's state differs from "
                         "rank 0's")
    missed = [f for f, d in faults.items() if not d["caught"]]
    if missed:
        raise SystemExit(f"[parallel] ({tag}) the comparison does not catch "
                         f"the planted {missed}")
    return res


def parallel_serving(dev) -> dict:
    """Phase parallel (c): float and int8 serving of the flagship and YOLOv3
    over the device mesh [cuda:0, cuda:0] at batch 16 (8 a shard), the
    filter at the median confidence (phase 14), deterministic cuDNN: the
    mesh's rows and masks torch.equal to one device serving each shard
    (the program each replica runs), K1 once a shard a predict call (and
    the int8 GEMM once an int8 conv a shard); against one device serving
    all 16 at once the int8 models' valid counts, kept classes and kept
    rows exact, and the float models' (whose bf16 cuDNN convs may choose
    other algorithms at batch 16) decoded candidates' largest difference,
    valid counts and kept classes reported."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.export import Int8InferenceModel
    from keras_object_detection_torch.ops import cuda_nms, int8_conv
    from keras_object_detection_torch.ops.nms import top_k_candidates
    from keras_object_detection_torch.parallel import create_mesh

    mesh = create_mesh(devices=[dev, dev])
    half = PARALLEL_SERVE_BATCH // 2
    out = {}
    for tag in ("flagship", "yolov3"):
        cfg, sd = serving_weights(tag)
        images = serving_images(cfg, PARALLEL_SERVE_BATCH, dev)
        for kind, cls in (("float", InferenceModel),
                          ("int8", Int8InferenceModel)):
            single = cls(cfg, sd, device=dev)
            decoded = single.predict_decoded(images)
            if cfg.eval.max_candidates:
                decoded = top_k_candidates(decoded, cfg.eval.max_candidates)
            e = dataclasses.replace(cfg.eval, conf_threshold=float(
                decoded[..., 1].median()))
            lcfg = dataclasses.replace(cfg, eval=e)
            single.config = lcfg
            meshed = cls(lcfg, sd, mesh=mesh)
            with deterministic_cudnn():
                shards = [single.predict(images[i:i + half])
                          for i in (0, half)]
                want_rows = torch.cat([r for r, _ in shards])
                want_valid = torch.cat([v for _, v in shards])
                whole_rows, whole_valid = single.predict(images)
                whole_decoded = single.predict_decoded(images)
                decoded_err = float((meshed.predict_decoded(images)
                                     - whole_decoded).abs().max())
                # the witness without a mesh: one device at batch 8 twice
                # against the same device at batch 16
                b8_err = float((torch.cat([single.predict_decoded(
                    images[i:i + half]) for i in (0, half)])
                    - whole_decoded).abs().max())
                # the main path: counts at 0 just before, read just after
                cuda_nms.LAUNCHES = int8_conv.LAUNCHES = 0
                rows, valid = meshed.predict(images)
                torch.cuda.synchronize()
                k1, gemms = cuda_nms.LAUNCHES, int8_conv.LAUNCHES
            n_int8 = (sum("w_q" in layer for layer in meshed.layers)
                      if kind == "int8" else 0)
            exact = torch.equal(rows, want_rows) and torch.equal(valid,
                                                                 want_valid)
            counts_equal = torch.equal(valid.sum(1), whole_valid.sum(1))
            classes_equal = counts_equal and all(
                torch.equal(rows[i][valid[i]][:, 0],
                            whole_rows[i][whole_valid[i]][:, 0])
                for i in range(PARALLEL_SERVE_BATCH))
            box_err = (float((rows[valid] - whole_rows[whole_valid]).abs()
                             .max()) if classes_equal and valid.any()
                       else float("nan"))
            p50 = call_p50(lambda: meshed.predict(images), 5)
            p50_single = call_p50(lambda: single.predict(images), 5)
            res = {"k1_launches": k1, "int8_launches": gemms,
                   "kept": int(valid.sum()), "equal_to_shards": exact,
                   "kept_one_device": int(whole_valid.sum()),
                   "counts_equal_one_device": counts_equal,
                   "classes_equal_one_device": classes_equal,
                   "max_box_err_one_device": box_err,
                   "max_decoded_err_one_device": decoded_err,
                   "max_decoded_err_b8_b16_no_mesh": b8_err,
                   "p50_ms": p50, "p50_ms_single": p50_single,
                   "replicas": len(meshed._replicas)}
            out[f"{tag}_{kind}"] = res
            log(f"[parallel] (c) {tag} {kind} over [cuda:0, cuda:0] at batch "
                f"{PARALLEL_SERVE_BATCH}: K1 {k1}, int8 GEMMs {gemms} in one "
                f"predict, {res['kept']} kept, equal to one device on each "
                f"shard {exact}; one device on all {PARALLEL_SERVE_BATCH}: "
                f"{res['kept_one_device']} kept, counts equal {counts_equal}, "
                f"classes equal {classes_equal}, max kept-row error "
                f"{box_err:.3e}, max decoded difference {decoded_err:.3e}; "
                f"one device alone at batch 8 against batch 16 (no mesh): "
                f"max decoded difference {b8_err:.3e}; "
                f"p50 {p50:.3f} ms against one device's {p50_single:.3f}")
            if k1 != 2 or gemms != 2 * n_int8:
                raise SystemExit(f"[parallel] (c) {tag} {kind}: K1 {k1}, "
                                 f"int8 GEMMs {gemms} (expected 2 and "
                                 f"{2 * n_int8}: once a shard)")
            if not exact:
                raise SystemExit(f"[parallel] (c) {tag} {kind}: the mesh's "
                                 "rows differ from one device's on each shard")
            # int8 convs accumulate in integers: batch 16 on one device is
            # the same function; the bf16 cuDNN convs may not be
            if kind == "int8" and not (counts_equal and classes_equal
                                       and box_err == 0.0):
                raise SystemExit(f"[parallel] (c) {tag} int8: the mesh's rows "
                                 "differ from one device's at batch 16")
            del single, meshed
            torch.cuda.empty_cache()
    return out


def phase_parallel(dev) -> dict:
    """Data parallelism on the card (module docstring, phase 17)."""
    import torch.distributed as dist

    from keras_object_detection_torch.parallel import distributed

    t_phase = time.perf_counter()
    out = {"card": card()}
    # (a) one rank over NCCL: the data-parallel path is the one-device step
    cfg = train_config(True)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{distributed.free_port()}", rank=0,
                            world_size=1)
    group = dist.group.WORLD
    try:
        single, m1 = dp_step(cfg, dev, None)
        want = {k: v.clone() for k, v in single.model.state_dict().items()}
        del single
        distributed.reset_counts()
        dp, m2 = dp_step(cfg, dev, group)
        equal = (torch.equal(m1["total"], m2["total"]) and all(
            torch.equal(v, want[k]) for k, v in dp.model.state_dict().items()))
        collectives = distributed.ALL_REDUCES + distributed.GATHERS
        del dp, want
        torch.cuda.empty_cache()
        timed = dp_timed(cfg, dev, group)
        ar_ms = all_reduce_ms(timed["grad_values"], dev, group)
    finally:
        dist.destroy_process_group()
    out["world1"] = dict(timed, bit_equal=equal, collectives=collectives,
                         all_reduce_ms=ar_ms)
    log(f"[parallel] (a) 1 rank over NCCL: step bit-equal to the one-device "
        f"step {equal}, {collectives} collectives in it; bf16 kernel path p50 "
        f"{timed['p50_ms']:.3f} ms, launches {timed['counts']} over "
        f"{PARALLEL_STEPS} steps; one all-reduce of the "
        f"{timed['grad_values']} float32 gradient values "
        f"({timed['grad_values'] * 4 / 1e6:.1f} MB) {ar_ms:.3f} ms")
    if not equal or collectives:
        raise SystemExit("[parallel] (a) the one-rank data-parallel step is "
                         "not the one-device step")
    check_step_counts("(a)", timed)
    torch.cuda.empty_cache()
    # (b) two ranks on the card over gloo with CUDA tensors (and over NCCL
    # where there are two cards)
    out["gloo"] = parallel_two_ranks(dev, "gloo", "gloo")
    if torch.cuda.device_count() >= 2:
        out["nccl"] = parallel_two_ranks(dev, "nccl", "nccl")
    # (c) mesh serving
    out["serving"] = parallel_serving(dev)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[parallel] phase wall {out['wall_s']:.1f} s")
    print(json.dumps({"parallel": out}))
    return out


TP_DIR = os.path.join("build", "tensor_parallel")
TP_WARMUP, TP_STEPS = 1, 3
TP_RANKS = 4  # (b)'s dp2 x tp2; (a) runs on ranks 0 and 1
TP_FAULTS = ("copy_in_not_summed", "gather_backward_summed",
             "grads_over_world", "partial_grads_local")
TP_SHARDED_LEAVES = 39  # JAX's state_sharding of the flagship's nadam state
TP_SHARDED_VALUES = 67_239_936  # the 13 kernels it shards


@contextlib.contextmanager
def tp_planted(fault, mesh):
    """Inside the block the tensor-parallel step combines wrongly, as a bug
    would (``None``: as it should): ``copy_in_not_summed`` a column-parallel
    layer's input gradient is not summed over the model group,
    ``gather_backward_summed`` the gather's backward sums the gradient over
    the model group before it slices (it should only slice),
    ``grads_over_world`` the gradients are all-reduced over every rank
    instead of the data group, ``partial_grads_local`` the replicated 1-D
    parameters of the sharded channels keep each rank's slice of their
    gradient (not summed over the model group)."""
    from keras_object_detection_torch.parallel import distributed, tensor

    gather = distributed.GatherChannels
    saved = (distributed.sum_over, gather.backward,
             distributed.all_reduce_flat_, tensor.reduce_partial_grads)
    sum_over, backward, flat_, _ = saved
    if fault == "copy_in_not_summed":
        distributed.sum_over = lambda t, group: t
    elif fault == "gather_backward_summed":
        def summed(ctx, grad):
            return (sum_over(grad.contiguous(), ctx.group)
                    .narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None)

        gather.backward = staticmethod(summed)
    elif fault == "grads_over_world":
        def over_world(tensors, group):
            flat_(tensors, torch.distributed.group.WORLD
                  if group is mesh.data_group else group)

        distributed.all_reduce_flat_ = over_world
    elif fault == "partial_grads_local":
        tensor.reduce_partial_grads = lambda model: None
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        (distributed.sum_over, gather.backward, distributed.all_reduce_flat_,
         tensor.reduce_partial_grads) = saved


@contextlib.contextmanager
def collective_timer(out: dict):
    """Host seconds inside each kind of collective, the device synchronised
    before and after each (gloo stages CUDA tensors through the host):
    ``gather`` (the column-parallel gathers and the running statistics'),
    ``input_grad_sum`` (copy_in's backward), ``all_reduce`` (the
    BatchNorms' sums, the 1-D gradients over the model group, the gradient
    and metrics all-reduces over the data group)."""
    from keras_object_detection_torch.models import layers
    from keras_object_detection_torch.ops import bn
    from keras_object_detection_torch.parallel import distributed

    def timed(kind, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            out[kind] = out.get(kind, 0.0) + time.perf_counter() - t0
            return result
        return wrapped

    with contextlib.ExitStack() as stack:
        for module, attr, kind in (
                (distributed, "all_gather_dim", "gather"),
                (layers, "all_gather_dim", "gather"),
                (distributed, "sum_over", "input_grad_sum"),
                (distributed, "all_reduce_", "all_reduce"),
                (bn, "all_reduce_", "all_reduce"),
                (layers, "all_reduce_", "all_reduce")):
            stack.enter_context(unittest.mock.patch.object(
                module, attr, timed(kind, getattr(module, attr))))
        yield


def tp_state_bytes(state) -> int:
    """Bytes of this rank's parameters and optimizer moments."""
    opt = state.opt
    return sum(t.numel() * t.element_size() for t in
               list(state.model.parameters()) + opt.mu + opt.nu + opt.trace)


def tp_bn_shapes(calls: dict) -> list:
    """K2 and K3 at each distinct shape of a captured step's calls:
    bit-equal from call to call, device ms (CUDA graph), the bound, and
    how many of the step's calls have that shape."""
    from keras_object_detection_torch.ops import bn

    rows = []
    for name, kernel in (("k2", bn.cuda_bn_stats_sums),
                         ("k3", bn.cuda_bn_grad_sums)):
        seen = {}
        for args in calls[name]:
            x = args[0] if name == "k2" else args[1]
            key = tuple(x.shape)
            if key in seen:
                seen[key]["calls"] += 1
                continue
            if not torch.equal(kernel(*args), kernel(*args)):
                raise SystemExit(f"[tensor_parallel] {name.upper()} differs "
                                 f"from call to call at {key}")
            bound, by = bn_bound_ms(key, x.element_size(), name == "k3")
            seen[key] = {"kernel": name, "shape": list(key),
                         "rows_x_channels": [math.prod(key) // key[1],
                                             key[1]],
                         "calls": 1, "ms": graph_ms(lambda: kernel(*args),
                                                    20, 5),
                         "bound_ms": bound, "bound_by": by}
        rows += list(seen.values())
    return rows


def tp_flagship_rank(dev, mesh, out: dict) -> None:
    """(a) on this rank of the (1, 2) mesh: the flagship's kernel-path step
    at batch 64 (every rank all 64 rows), its sharded leaves, bytes,
    launches, collectives, p50, the collectives' share and K2/K3 at the
    step's shapes (rank 0)."""
    from keras_object_detection_torch.parallel import distributed, dryrun
    from keras_object_detection_torch.parallel import tensor
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    cfg = train_config(True)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    whole = tp_state_bytes(state)
    leaves = dryrun.sharded_leaves(state, mesh)
    tensor.shard_state(state, mesh)
    values = sum(state.model.get_parameter(n).numel()
                 for n in tensor.placement(state.model).sharded)
    batch = synthetic_batch(cfg.data.batch_size, cfg.model.image_size,
                            cfg.data.max_boxes_per_image, dev)
    step = make_train_step(cfg, group=mesh.data_group)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TP_WARMUP):
        state, metrics = step(state, *batch, 1)
    torch.cuda.synchronize()
    reset_kernel_counts()
    distributed.reset_counts()
    times = []
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernel_counts()
    collectives = {k: getattr(distributed, k) / TP_STEPS for k in (
        "GATHERS", "GATHER_BYTES", "ALL_REDUCES", "ALL_REDUCE_BYTES")}
    spent: dict = {}
    with collective_timer(spent):
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, 1)
        torch.cuda.synchronize()
        instrumented = (time.perf_counter() - t0) * 1e3
    out.update({
        "sharded_leaves": leaves, "sharded_kernels":
            len(tensor.placement(state.model).sharded),
        "sharded_kernel_values": values * mesh.model_parallel,
        "state_bytes": tp_state_bytes(state), "state_bytes_whole": whole,
        "p50_ms": float(np.median(times)), "step_ms": times,
        "counts": counts, "collectives_a_step": collectives,
        "instrumented_step_ms": instrumented,
        "collective_ms": {k: v * 1e3 for k, v in spent.items()},
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "loss": metrics["total"].item()})
    # every rank takes the captured step (its collectives need them all);
    # rank 0 checks and times the kernels on its inputs
    calls = capture_kernel_calls(step, state, batch, 1)
    if mesh.model_index == 0:
        out["errors"] = kernel_errors(calls)
        out["bn_shapes"] = tp_bn_shapes(calls)


def tp_float32_rank(dev, mesh, job: dict) -> None:
    """(b) on this rank of the (2, 2) mesh: the float32 SGD step of
    parallel_f32_config on the ramped batch (dp_step), clean and with each
    of TP_FAULTS; the gathered whole state saved (every rank's for the
    clean run, rank 0's for the faults)."""
    from keras_object_detection_torch.parallel import tensor
    from keras_object_detection_torch.train import create_train_state

    cfg = parallel_f32_config()
    seeded = create_train_state(cfg, torch.Generator().manual_seed(0), dev)
    rank = torch.distributed.get_rank()
    for fault in (None,) + TP_FAULTS:
        state = tensor.shard_state(copy.deepcopy(seeded), mesh)
        with tp_planted(fault, mesh):
            state, metrics = dp_step(cfg, dev, mesh.data_group, state=state)
        whole = tensor.full_tensors(state.model, state.model.state_dict())
        if rank == 0 or fault is None:
            torch.save({"model": {k: v.cpu() for k, v in whole.items()},
                        "loss": metrics["total"].item()},
                       os.path.join(job["dir"],
                                    f"f32_{fault or 'clean'}_rank{rank}.pt"))
        del state, whole
        if rank == 0:
            log(f"[tensor_parallel] (b) {fault or 'clean'} step done")
    del seeded
    torch.cuda.empty_cache()


def tp_rank(job_path: str) -> int:
    """One rank of phase tensor_parallel: joins the 4-rank gloo group the
    environment describes, runs (a) on ranks 0 and 1 (a (1, 2) mesh of
    their own), then (b) on all four ((2, 2)), and writes its results."""
    from keras_object_detection_torch.parallel import create_mesh, distributed

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    distributed.maybe_initialize(backend="gloo")
    world = torch.distributed.group.WORLD
    res: dict = {"rank": rank}
    pair = torch.distributed.new_group([0, 1])  # every rank creates it
    if rank < 2:
        tp_flagship_rank(dev, create_mesh(1, 2, group=pair), res)
        torch.cuda.empty_cache()
        log(f"[tensor_parallel] rank {rank}: (a) done")
    distributed.barrier(world)
    tp_float32_rank(dev, create_mesh(2, 2), job)
    res["peak_gib_process"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with open(os.path.join(job["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier(world)
    torch.distributed.destroy_process_group()
    return 0


def tp_float32_check(dev) -> dict:
    """(b) against the one process: PR 12's four limits (loss and running
    statistics to PARALLEL_LOSS_RTOL; the parameters' updates in norm, the
    worst and the median within twice the one process's reversed-batch
    distance, at least PARALLEL_UPDATE_RTOL and PARALLEL_MEDIAN_RTOL), the
    four ranks' gathered states bit-equal, each planted fault caught."""
    from keras_object_detection_torch.models import build_model

    ref, ref_metrics = dp_step(parallel_f32_config(), dev, None)
    want = {k: v.detach().cpu() for k, v in ref.model.state_dict().items()}
    del ref
    rev, _ = dp_step(parallel_f32_config(), dev, None, reverse=True)
    reordered = {k: v.detach().cpu() for k, v in rev.model.state_dict().items()}
    del rev
    torch.cuda.empty_cache()
    init = build_model(parallel_f32_config(),
                       torch.Generator().manual_seed(0)).state_dict()
    ref_loss = ref_metrics["total"].item()

    def updates(got):
        return [(rel_norm(got[k] - init[k], v - init[k]), k)
                for k, v in want.items()
                if "running" not in k and not zero_gradient(k)
                and k in init and v.is_floating_point()]

    def distances(run):
        got = torch.load(os.path.join(TP_DIR, f"f32_{run}_rank0.pt"))
        stat = max(rel_norm(got["model"][k], v) for k, v in want.items()
                   if "running" in k)
        ups = updates(got["model"])
        return (abs(got["loss"] - ref_loss) / abs(ref_loss), stat, max(ups),
                float(np.median([u for u, _ in ups])))

    rev_ups = updates(reordered)
    update_tol = max(PARALLEL_UPDATE_RTOL, 2 * max(rev_ups)[0])
    median_tol = max(PARALLEL_MEDIAN_RTOL,
                     2 * float(np.median([u for u, _ in rev_ups])))

    def caught(d):
        return (d[0] > PARALLEL_LOSS_RTOL or d[1] > PARALLEL_LOSS_RTOL
                or d[2][0] > update_tol or d[3] > median_tol)

    clean = distances("clean")
    states = [torch.load(os.path.join(TP_DIR, f"f32_clean_rank{r}.pt"))
              for r in range(TP_RANKS)]
    ranks_equal = all(s["loss"] == states[0]["loss"] and all(
        torch.equal(v, s["model"][k]) for k, v in states[0]["model"].items())
        for s in states[1:])
    del states
    faults = {}
    for fault in TP_FAULTS:
        d = distances(fault)
        faults[fault] = {"loss_rel_err": d[0], "running_rel_err": d[1],
                         "update_rel_err": d[2][0],
                         "update_rel_err_tensor": d[2][1],
                         "median_update_rel_err": d[3], "caught": caught(d)}
    res = {"loss_rel_err": clean[0], "running_rel_err": clean[1],
           "update_rel_err": clean[2][0],
           "update_rel_err_tensor": clean[2][1],
           "median_update_rel_err": clean[3], "update_tol": update_tol,
           "median_tol": median_tol, "ranks_equal": ranks_equal,
           "faults": faults}
    log(f"[tensor_parallel] (b) float32 SGD step over dp2 x tp2 (4 gloo "
        f"ranks on the card, 32 rows a data rank) against one process: loss "
        f"rel err {clean[0]:.3e}, running statistics {clean[1]:.3e}, worst "
        f"update {clean[2][0]:.3e} ({clean[2][1]}), median update "
        f"{clean[3]:.3e}; tolerances {PARALLEL_LOSS_RTOL}, "
        f"{PARALLEL_LOSS_RTOL}, {update_tol:.3e}, {median_tol:.3e}; the four "
        f"ranks' gathered states bit-equal {ranks_equal}")
    for fault, d in faults.items():
        log(f"[tensor_parallel] (b) planted {fault}: loss rel err "
            f"{d['loss_rel_err']:.3e}, running statistics "
            f"{d['running_rel_err']:.3e}, worst update "
            f"{d['update_rel_err']:.3e} ({d['update_rel_err_tensor']}), "
            f"median update {d['median_update_rel_err']:.3e}: caught "
            f"{d['caught']}")
    if caught(clean):
        raise SystemExit("[tensor_parallel] (b) the dp2 x tp2 step parts "
                         "from the one-process step beyond its tolerance")
    if not ranks_equal:
        raise SystemExit("[tensor_parallel] (b) the ranks' gathered states "
                         "differ")
    missed = [f for f, d in faults.items() if not d["caught"]]
    if missed:
        raise SystemExit(f"[tensor_parallel] (b) the comparison does not "
                         f"catch the planted {missed}")
    return res


def tp_serving(dev) -> dict:
    """(c) float and int8 serving of the flagship and YOLOv3 over a (2, 2)
    device mesh of [cuda:0] x 4 at batch 16 (deterministic cuDNN): rows and
    masks torch.equal to the (2, 1) mesh's, K1 once a data shard a
    predict call (2)."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.export import Int8InferenceModel
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import top_k_candidates
    from keras_object_detection_torch.parallel import create_mesh

    two_by_two = create_mesh(2, 2, devices=[dev] * 4)
    two_by_one = create_mesh(2, devices=[dev] * 2)
    out = {}
    for tag in ("flagship", "yolov3"):
        cfg, sd = serving_weights(tag)
        images = serving_images(cfg, PARALLEL_SERVE_BATCH, dev)
        for kind, cls in (("float", InferenceModel),
                          ("int8", Int8InferenceModel)):
            probe = cls(cfg, sd, device=dev)
            decoded = probe.predict_decoded(images)
            if cfg.eval.max_candidates:
                decoded = top_k_candidates(decoded, cfg.eval.max_candidates)
            lcfg = dataclasses.replace(cfg, eval=dataclasses.replace(
                cfg.eval, conf_threshold=float(decoded[..., 1].median())))
            del probe
            wide, narrow = (cls(lcfg, sd, mesh=two_by_two),
                            cls(lcfg, sd, mesh=two_by_one))
            with deterministic_cudnn():
                want_rows, want_valid = narrow.predict(images)
                cuda_nms.LAUNCHES = 0
                rows, valid = wide.predict(images)
                torch.cuda.synchronize()
                k1 = cuda_nms.LAUNCHES
            equal = torch.equal(rows, want_rows) and torch.equal(valid,
                                                                 want_valid)
            out[f"{tag}_{kind}"] = {
                "k1_launches": k1, "equal_to_data_axis_mesh": equal,
                "replicas": len(wide._replicas), "kept": int(valid.sum()),
                "p50_ms": call_p50(lambda: wide.predict(images), 5)}
            log(f"[tensor_parallel] (c) {tag} {kind} over a (2, 2) mesh of "
                f"[cuda:0] x 4 at batch {PARALLEL_SERVE_BATCH}: K1 {k1} in "
                f"one predict, {int(valid.sum())} kept, rows equal to the "
                f"(2, 1) mesh's {equal}, p50 "
                f"{out[f'{tag}_{kind}']['p50_ms']:.3f} ms")
            if k1 != 2 or not equal:
                raise SystemExit(f"[tensor_parallel] (c) {tag} {kind}: K1 "
                                 f"{k1} (expected 2), rows equal {equal}")
            del wide, narrow
            torch.cuda.empty_cache()
    return out


def tp_export(dev) -> dict:
    """(d) the flagship's float32 serving function exported
    (torch.export, .pt2) on the card, loaded and run at batch 2 against the
    model's float32 forward on the same weights."""
    from keras_object_detection_torch.export import litert

    cfg, sd = serving_weights("flagship")
    os.makedirs(TP_DIR, exist_ok=True)
    path = os.path.join(TP_DIR, "flagship.pt2")
    t0 = time.perf_counter()
    blob = litert.export_program(cfg, sd, path, batch_size=2, device=dev)
    export_s = time.perf_counter() - t0
    program = litert.load_program(path)
    x = torch.from_numpy(np.random.RandomState(3).rand(
        2, 448, 448, 3).astype(np.float32)).to(dev)
    with torch.no_grad(), deterministic_cudnn():
        got = program(x)
        want = litert._make_serving_fn(cfg, sd, dev)(x)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[tensor_parallel] (d) export of the flagship (float32, batch 2): "
        f"{len(blob)} bytes in {export_s:.1f} s; the loaded program's grids "
        f"{tuple(got.shape)} against the model's float32 forward on the card:"
        f" max abs difference {err:.3e} (grid scale {scale:.3e})")
    if not (torch.isfinite(got).all() and err <= 1e-4 * max(scale, 1.0)):
        raise SystemExit(f"[tensor_parallel] (d) the exported program parts "
                         f"from the model by {err:.3e}")
    return {"bytes": len(blob), "export_s": export_s, "max_abs_err": err,
            "grid_scale": scale, "shape": list(got.shape)}


def tp_profile(dev) -> dict:
    """(e) utils/profiling.trace of two flagship kernel-path steps (batch
    64, one process): the trace's K2, K3, K4 and K5 (traced_port_kernels)
    equal to their launch counters (50, 50, 2, 2); retaken where the
    profiler lost its device events (profiling.checked_trace)."""
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)
    from keras_object_detection_torch.utils import profiling

    cfg = train_config(True)
    box = {"state": create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)}
    batch = synthetic_batch(cfg.data.batch_size, cfg.model.image_size,
                            cfg.data.max_boxes_per_image, dev)
    step = make_train_step(cfg)

    def one():
        box["state"], _ = step(box["state"], *batch, 1)

    one()
    events, traced, launched, tries = profiling.checked_trace(one, 2)
    breakdown = profiling.op_breakdown(events, top_k=None)
    lanes = profiling.device_lane_ms(events)
    log(f"[tensor_parallel] (e) profiling.trace of 2 flagship steps: "
        f"traced {traced} against the launch counters "
        f"{launched} ({tries} trace(s)); device busy "
        f"{breakdown['total_ms']:.3f} ms over {len(lanes)} lanes; top "
        f"categories " + ", ".join(f"{k} {v:.3f}" for k, v in list(
            breakdown["categories"].items())[:5]))
    want = {"nms": 0, "bn_stats": 50, "bn_grad_stats": 50,
            "yolo_loss_forward": 2, "yolo_loss_backward": 2, "optim_update": 2}
    if traced != launched or launched != want:
        raise SystemExit(f"[tensor_parallel] (e) traced {traced}, launched "
                         f"{launched}, expected {want}")
    return {"traced": traced, "launched": launched,
            "device_busy_ms": breakdown["total_ms"],
            "categories_ms": dict(list(breakdown["categories"].items())[:10]),
            "attempts": tries}


def phase_tensor_parallel(dev) -> dict:
    """Tensor parallelism on the card (module docstring, phase 18)."""
    from keras_object_detection_torch.parallel import distributed, dryrun

    t_phase = time.perf_counter()
    out = {"card": card()}
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR, exist_ok=True)
    torch.cuda.empty_cache()
    job = os.path.join(TP_DIR, "job.json")
    with open(job, "w") as f:
        json.dump({"dir": TP_DIR}, f)
    t0 = time.perf_counter()
    rc = distributed.launch_local("chip_smoke", ["--tp-rank", job], TP_RANKS)
    out["ranks_wall_s"] = time.perf_counter() - t0
    if rc:
        raise SystemExit(f"[tensor_parallel] a rank exited with {rc}")
    ranks = []
    for r in range(TP_RANKS):
        with open(os.path.join(TP_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    flagship = ranks[:2]
    out["flagship"] = flagship
    want_bytes = (69_653_342 - TP_SHARDED_VALUES // 2) * 12
    for rr in flagship:
        per_step = {k: v / TP_STEPS for k, v in rr["counts"].items()}
        c, ms = rr["collectives_a_step"], rr["collective_ms"]
        log(f"[tensor_parallel] (a) rank {rr['rank']} of the flagship over "
            f"dp1 x tp2 (bf16, nadam, fused, batch 64, 2 gloo ranks on the "
            f"card): {rr['sharded_leaves']} sharded leaves, "
            f"{rr['sharded_kernels']} kernels of {rr['sharded_kernel_values']}"
            f" values; parameters and moments {rr['state_bytes'] / 1e6:.1f} MB"
            f" against {rr['state_bytes_whole'] / 1e6:.1f} MB whole; p50 "
            f"{rr['p50_ms']:.3f} ms a step, launches {per_step} a step, "
            f"{c['GATHERS']:.0f} gathers ({c['GATHER_BYTES'] / 1e6:.1f} MB a "
            f"rank) and {c['ALL_REDUCES']:.0f} reductions "
            f"({c['ALL_REDUCE_BYTES'] / 1e6:.1f} MB) a step; in an "
            f"instrumented step of {rr['instrumented_step_ms']:.1f} ms: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
            + f"; peak {rr['peak_gib']:.3f} GiB; loss {rr['loss']:.4f}")
        if per_step != FLAGSHIP_BN_LAUNCHES:
            raise SystemExit(f"[tensor_parallel] (a) rank {rr['rank']} "
                             f"launched {per_step} a step, expected "
                             f"{FLAGSHIP_BN_LAUNCHES}")
        if (rr["sharded_leaves"] != TP_SHARDED_LEAVES
                or rr["sharded_kernel_values"] != TP_SHARDED_VALUES
                or rr["state_bytes"] != want_bytes):
            raise SystemExit(f"[tensor_parallel] (a) rank {rr['rank']}: "
                             f"{rr['sharded_leaves']} leaves, "
                             f"{rr['sharded_kernel_values']} values, "
                             f"{rr['state_bytes']} bytes; expected "
                             f"{TP_SHARDED_LEAVES}, {TP_SHARDED_VALUES}, "
                             f"{want_bytes}")
    for row in flagship[0]["bn_shapes"]:
        log(f"[tensor_parallel] (a) {row['kernel'].upper()} at "
            f"{'x'.join(map(str, row['shape']))} ({row['rows_x_channels'][0]}"
            f" rows x {row['rows_x_channels'][1]} channels, {row['calls']} a "
            f"step): {row['ms']:.5f} ms device, bound {row['bound_ms']:.5f} "
            f"({row['bound_by']}), {row['bound_ms'] / row['ms'] * 100:.1f} %")
    out["float32"] = tp_float32_check(dev)
    out["float32"]["peak_gib_ranks"] = [r["peak_gib_process"] for r in ranks]
    out["serving"] = tp_serving(dev)
    out["export"] = tp_export(dev)
    out["profile"] = tp_profile(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(4)
    out["dryrun_s"] = time.perf_counter() - t0
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[tensor_parallel] (f) dry run over 4 ranks on the card "
        f"{out['dryrun_s']:.1f} s; phase wall {out['wall_s']:.1f} s")
    print(json.dumps({"tensor_parallel": out}))
    return out


SURFACE_IMAGE = 7  # the image of phase surface's 32 x 512 rows held alone
SURFACE_LOSS_RTOL = 1e-5  # YoloV1Loss, card against CPU: sums in other orders


def phase_surface(dev) -> dict:
    """The public names the JAX package has beside the batched paths
    (module docstring, phase 19): ``YoloV1Loss`` on the card against K4's
    total and the CPU; one image's soft, fast and hard NMS against the
    batched twins, K1 and the plain NMS."""
    from keras_object_detection_torch import ops
    from keras_object_detection_torch.losses import YoloV1Loss
    from keras_object_detection_torch.ops import nms as plain_nms
    from keras_object_detection_torch.ops.yolo_loss import fused_yolo_v1_loss
    from keras_object_detection_torch.utils.profiling import (
        launches_since, port_kernel_launches)

    t0 = time.perf_counter()
    out = {"card": card(), "loss": {}}
    t_np, p_np = loss_rows(11, 64 * 49, 20, 2)
    t, p = (torch.from_numpy(a).reshape(64, 7, 7, 30) for a in (t_np, p_np))
    tc, pc = t.to(dev), p.to(dev)
    for mode in ("selected", "all"):
        loss = YoloV1Loss(noobj_mode=mode)
        before = port_kernel_launches()
        got = loss(tc, pc).item()
        launched = launches_since(before)
        k4 = fused_yolo_v1_loss(tc, pc, 20, 2, noobj_mode=mode).item()
        cpu = loss(t, p).item()
        row = {"card": got, "k4": k4, "cpu": cpu,
               "rel_k4": abs(got - k4) / abs(k4),
               "rel_cpu": abs(got - cpu) / abs(cpu)}
        out["loss"][mode] = row
        log(f"[surface] YoloV1Loss(noobj_mode={mode!r}) at (64, 7, 7, 30) on "
            f"the card {got!r}: K4's total {k4!r} (rel {row['rel_k4']:.3e}), "
            f"the CPU's {cpu!r} (rel {row['rel_cpu']:.3e}); port kernels "
            f"launched by it {launched}")
        if any(launched.values()):
            raise SystemExit("[surface] YoloV1Loss launched a kernel of the "
                             f"port: {launched}")
        if row["rel_k4"] > 1e-6 or row["rel_cpu"] > SURFACE_LOSS_RTOL:
            raise SystemExit(f"[surface] YoloV1Loss disagrees: {row}")

    x = torch.from_numpy(nms_rows(16, 32, 512)).to(dev)
    i = SURFACE_IMAGE
    one = {"soft_gaussian": plain_nms.soft_non_max_suppression(x[i]),
           "soft_linear": plain_nms.soft_non_max_suppression(
               x[i], method="linear"),
           "fast": ops.fast_non_max_suppression(x[i])}
    batched = {"soft_gaussian": plain_nms.batched_soft_non_max_suppression(x),
               "soft_linear": plain_nms.batched_soft_non_max_suppression(
                   x, method="linear"),
               "fast": ops.batched_fast_non_max_suppression(x)}
    before = port_kernel_launches()
    k1 = ops.auto_batched_non_max_suppression(x[i][None])
    launched = launches_since(before)
    one["hard"] = ops.non_max_suppression(x[i])
    out["nms"] = {}
    for mode, (rows, valid) in one.items():
        twin = (k1[0][0], k1[1][0]) if mode == "hard" else (
            batched[mode][0][i], batched[mode][1][i])
        equal = torch.equal(rows, twin[0]) and torch.equal(valid, twin[1])
        out["nms"][mode] = {"kept": int(valid.sum()), "bit_equal": equal}
        log(f"[surface] image {i} of 32x512, {mode}: one image "
            f"{'==' if equal else '!='} "
            + ("K1 on boxes[None]" if mode == "hard"
               else f"row {i} of the batched twin")
            + f", kept {int(valid.sum())}")
        if not equal or not valid.any():
            raise SystemExit(f"[surface] {mode} NMS of one image: "
                             f"{out['nms'][mode]}")
    out["launches"] = launched
    log(f"[surface] port kernels launched by K1's one-image call {launched}")
    if launched != dict(dict.fromkeys(launched, 0), nms=1):
        raise SystemExit(f"[surface] expected one K1 launch, got {launched}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[surface] phase wall {out['wall_s']:.1f} s")
    print(json.dumps({"surface": out}))
    return out


MEASURE_DIR = os.path.join("build", "measure")
MEASURE_SERVING = dict(batches=(1, 32), runs=15, pipeline_k=32,
                       trace_calls=8)
TRACE_LOSS_TRACES = 10  # traces of K1 alone in phases nms and measure
# the JAX package's records of the same measurements (read as data)
JAX_RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks")


def measure_config(tag: str, cfg) -> str:
    """A run directory holding ``cfg`` as config.json, as the tools'
    ``--checkpoint`` reads it."""
    path = os.path.join(MEASURE_DIR, tag)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return path


def jax_record(name: str) -> dict:
    with open(os.path.join(JAX_RECORDS, name)) as f:
        return json.load(f)


def run_child(argv: list, out: str) -> dict:
    """``python -m *argv`` in a child process from the repository's root
    (for a tool: as a user runs it), its output in ``out``'s ``.log``; the
    JSON it wrote to ``out`` read back. The child is a young process: the
    profiler loses a trace's device events the more often the longer its
    process has run (PERF.md §6, fault 3.5), so every trace phase measure
    reads is taken in one."""
    log_path = os.path.splitext(out)[0] + ".log"
    with open(log_path, "w") as f:
        rc = subprocess.run([sys.executable, "-m", *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=900).returncode
    if rc:
        with open(log_path) as f:
            print(f.read()[-4000:], flush=True)
        raise SystemExit(f"[measure] {argv[0]} exited {rc}")
    with open(out) as f:
        return json.load(f)


def run_tool(module: str, argv: list, out_name: str) -> dict:
    """The port's measurement tool ``cli/<module>.py`` through its ``python
    -m`` entry point (``run_child``), its ``--out`` MEASURE_DIR/<out_name>.
    """
    out = os.path.abspath(os.path.join(MEASURE_DIR, out_name))
    return run_child([f"keras_object_detection_torch.cli.{module}", *argv,
                      "--out", out], out)


def measure_breakdown(tag: str, cfg, want: dict, scan: int = 0) -> dict:
    """(a) cli/train_step_breakdown.py on ``cfg``, in a child process: the
    port's kernels a step in the trace and in the counters equal to
    ``want`` (the bare step and the --scan chunk), device time at most the
    wall p50."""
    res = run_tool("train_step_breakdown", [
        "--checkpoint", os.path.abspath(measure_config(tag, cfg)),
        "--steps", "4", "--timed-steps", "10",
        *(["--scan", str(scan)] if scan else [])],
        f"train_step_{tag}.json")
    recs = {"bare": res, **({"scan": res["scan_dispatch"]} if scan else {})}
    for name, rec in recs.items():
        k = rec["port_kernels_per_step"]
        wall = (res["wall_p50_ms"] if name == "bare"
                else rec["wall_p50_ms_per_step"])
        dev_ms = rec["device_ms_per_step"]
        log(f"[measure] (a) {tag} {name}: wall p50 {wall:.3f} ms a step, "
            f"device {'null' if dev_ms is None else f'{dev_ms:.3f}'} ms a "
            f"step; kernels a "
            f"step traced {k['traced']}, counted {k['counted']}; "
            f"{rec['trace_note'][:160]}")
        if k["traced"] != want or k["counted"] != want:
            raise SystemExit(f"[measure] (a) {tag} {name}: kernels a step "
                             f"{k}, expected {want}")
        if rec["device_ms_per_step"] is None or not (
                0 < rec["device_ms_per_step"] <= wall):
            raise SystemExit(f"[measure] (a) {tag} {name}: device "
                             f"{rec['device_ms_per_step']} ms against wall "
                             f"{wall} ms")
    top = list(res["categories_ms_per_step"].items())[:8]
    log(f"[measure] (a) {tag}: idle "
        f"{(1 - res['device_ms_per_step'] / res['wall_p50_ms']) * 100:.1f} %"
        f" of the wall p50; top categories " + ", ".join(
            f"{c} {ms:.3f}" for c, ms in top)
        + (f"; the chunk of {scan} against the bare step's device time "
           f"{res['scan_dispatch']['vs_bare_step_device']:.4f}" if scan
           else "") + f"; launches in the run {res['port_kernel_launches']}")
    return res


def measure_serving() -> dict:
    """(b) cli/serving_device_time.py on random flagship weights at batch 1
    and 32, in a child process: every row's trace holds its device time,
    K1's launches counted."""
    m = MEASURE_SERVING
    res = run_tool("serving_device_time", [
        "--batches", ",".join(map(str, m["batches"])), "--runs",
        str(m["runs"]), "--pipeline-k", str(m["pipeline_k"]),
        "--trace-calls", str(m["trace_calls"])], "serving_device_time.json")
    launched = res["port_kernel_launches"]["nms"]
    # a predict call launches K1 once: per batch a warm-up, the runs, the
    # pipelined calls, the traced calls of each trace taken and the FLOP
    # count; the NMS alone the same but the FLOP count
    rows = res["fused_serving"] + [res["pallas_nms"]]
    want = sum(1 + m["runs"] + m["pipeline_k"]
               + m["trace_calls"] * row["traces"] for row in rows) + len(
        res["fused_serving"])
    if any(row["trace_device_ms"] is None for row in rows):
        raise SystemExit("[measure] (b) a trace holds no device time: "
                         + "; ".join(row["trace_note"] for row in rows))
    jax_rec = jax_record("serving_device_time.json")
    for row, jrow in zip(res["fused_serving"], jax_rec["fused_serving"]):
        log(f"[measure] (b) batch {row['batch']}: serial p50 "
            f"{row['serial_p50_ms']:.3f} ms (min {row['serial_min_ms']:.3f}),"
            f" pipelined {row['pipelined_per_call_ms']:.3f} ms a call, trace "
            f"device {row['trace_device_ms']:.4f} ms a call, "
            f"{row['cost_analysis_gflops']:.2f} GFLOP (JAX's record, a TPU, "
            f"quoted as work only: {jrow['cost_analysis_gflops']} GFLOP); "
            f"{row['traces']} trace(s)")
        if not 0 < row["trace_device_ms"] <= row["serial_p50_ms"]:
            raise SystemExit(f"[measure] (b) batch {row['batch']}: trace "
                             f"device {row['trace_device_ms']} ms")
    nms = res["pallas_nms"]
    log(f"[measure] (b) K1 alone at 32x512: serial p50 "
        f"{nms['serial_p50_ms']:.4f} ms, pipelined "
        f"{nms['pipelined_per_call_ms']:.4f}, trace device "
        f"{nms['trace_device_ms']:.5f} ms a call ({nms['traces']} trace(s): "
        f"{nms['trace_note']}); launches in the run "
        f"{res['port_kernel_launches']} (K1 expected {want})")
    if launched != want:
        raise SystemExit(f"[measure] (b) K1 launched {launched} times, "
                         f"expected {want}")
    return res


def measure_k1_alone(dev) -> dict:
    """(b) K1 on the tool's standalone 32 x 512 boxes (JAX's, drawn after
    the serving images) against its plain version: bit-equal; its device
    time as a CUDA graph (graph_ms)."""
    from keras_object_detection_torch.cli import serving_device_time as sdt
    from keras_object_detection_torch.ops import cuda_nms
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    _, boxes = sdt.draw_inputs(MEASURE_SERVING["batches"], 448, 20)
    boxes = torch.from_numpy(boxes).to(dev)
    got = cuda_nms.cuda_batched_non_max_suppression(boxes, sdt.NMS_IOU,
                                                    sdt.NMS_CONF)
    plain = batched_non_max_suppression(boxes, sdt.NMS_IOU, sdt.NMS_CONF)
    equal = all(torch.equal(a, b) for a, b in zip(got, plain))
    err = (got[0] - plain[0]).abs().max().item()
    ms = graph_ms(lambda: cuda_nms.cuda_batched_non_max_suppression(
        boxes, sdt.NMS_IOU, sdt.NMS_CONF))
    log(f"[measure] (b) K1 alone on the tool's 32x512 boxes (IoU "
        f"{sdt.NMS_IOU}, confidence {sdt.NMS_CONF}): bit-equal to the plain "
        f"NMS {equal}, kept {int(got[1].sum())}, max_abs_err {err}; "
        f"{ms:.5f} ms device (CUDA graph)")
    if not equal:
        raise SystemExit("[measure] (b) K1 disagrees with its plain version")
    return {"max_abs_err": err, "graph_ms": ms}


def measure_collectives() -> dict:
    """(c) cli/tp_comm_analysis.py: the flagship (JAX's config: flax
    BatchNorm, the plain loss, global batch 32 at 448²) over dp8 and dp4 x
    tp2, 8 gloo ranks on the card: ranks agree, the gradient bucket, the
    sharded leaves, beside JAX's record."""
    from keras_object_detection_torch.cli import tp_comm_analysis

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    doc = tp_comm_analysis.main(["--out", os.path.join(
        MEASURE_DIR, "tp_comm_analysis.json")])
    wall = time.perf_counter() - t0
    jax_rec = jax_record("tp_comm_analysis.json")
    buckets = {"dp8": 69_653_342 * 4,
               "dp4_tp2": (69_653_342 - TP_SHARDED_VALUES // 2) * 4}
    for name, rec in doc["configs"].items():
        jrec = jax_rec["configs"][name]
        log(f"[measure] (c) {name}: {rec['total_collective_ops']} "
            f"collectives, {rec['total_collective_bytes_per_device']:,} B a "
            f"rank ({json.dumps(rec['collectives'])}; JAX's record "
            f"{jrec['total_collective_ops']}, "
            f"{jrec['total_collective_bytes_per_device']:,} B: "
            f"{json.dumps(jrec['collectives'])}); sharded leaves "
            f"{rec['tp_sharded_leaves']} (JAX {jrec['tp_sharded_leaves']}); "
            f"counted step {rec['counted_step_ms']:.1f} ms over gloo; "
            f"ranks agree {rec['ranks_agree']}")
        if (rec["tp_sharded_leaves"] != TP_SHARDED_LEAVES
                or rec["all_reduce_sizes"].get(str(buckets[name])) != 1
                or not rec["ranks_agree"]):
            raise SystemExit(f"[measure] (c) {name}: leaves "
                             f"{rec['tp_sharded_leaves']}, all-reduce sizes "
                             f"{rec['all_reduce_sizes']}, ranks agree "
                             f"{rec['ranks_agree']}; expected "
                             f"{TP_SHARDED_LEAVES} and one gradient bucket of "
                             f"{buckets[name]} B")
    log(f"[measure] (c) delta {doc['delta']} (JAX's {jax_rec['delta']}); "
        f"{wall:.1f} s")
    doc["wall_s"] = wall
    return doc


def trace_loss_child(out: str) -> int:
    """``python -m chip_smoke --trace-loss OUT``, phase measure's child:
    first thing in a young process, ``trace_loss`` on
    ``serving_device_time.draw_inputs``' 32 x 512 boxes (the tool's K1
    alone), written to OUT with the process's age."""
    from keras_object_detection_torch.cli.serving_device_time import \
        draw_inputs

    boxes = torch.from_numpy(draw_inputs(MEASURE_SERVING["batches"], 448,
                                         20)[1]).to("cuda")
    res = trace_loss(boxes, TRACE_LOSS_TRACES)
    res["process_s"] = time.perf_counter() - START
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def phase_measure(dev) -> dict:
    """The port's three measurement tools (module docstring, phase 20)."""
    from keras_object_detection_torch.utils.profiling import PORT_KERNELS

    t0 = time.perf_counter()
    shutil.rmtree(MEASURE_DIR, ignore_errors=True)
    os.makedirs(MEASURE_DIR, exist_ok=True)
    out = {"card": card()}
    # the main path: each tool's child process counts from 0 and reports
    # its run's launches (port_kernel_launches)
    out["flagship"] = measure_breakdown(
        "flagship", train_config(True),
        dict(FLAGSHIP_BN_LAUNCHES, nms=0, optim_update=1), scan=4)
    out["yolov3"] = measure_breakdown(
        "yolov3", yolov3_config(True),
        {"nms": 0, "bn_stats": 72, "bn_grad_stats": 72,
         "yolo_loss_forward": 0, "yolo_loss_backward": 0, "optim_update": 1})
    out["serving"] = measure_serving()
    out["launches"] = {k: sum(out[t]["port_kernel_launches"][k] for t in (
        "flagship", "yolov3", "serving")) for k in PORT_KERNELS}
    out["serving"]["k1_alone"] = measure_k1_alone(dev)
    path = os.path.abspath(os.path.join(MEASURE_DIR, "trace_loss.json"))
    loss = run_child(["chip_smoke", "--trace-loss", path], path)
    out["serving"]["trace_loss"] = loss
    log(f"[measure] (b) 10 traces of 8 K1 calls at 32x512, each taken once, "
        f"in a child process {loss['process_s']:.1f} s old: "
        f"{json.dumps(loss)}")
    if loss["lost"] or loss["partial"]:
        raise SystemExit(f"[measure] (b) of {loss['traces']} traces, "
                         f"{loss['lost']} held no device event and "
                         f"{loss['partial']} not K1's 8")
    torch.cuda.empty_cache()
    out["collectives"] = measure_collectives()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[measure] launches in the phase {out['launches']}; phase wall "
        f"{out['wall_s']:.1f} s")
    print(json.dumps({"measure": out}))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default="",
                        help="write torch.profiler traces of batch-32 serving "
                        "and of 3 flagship, 3 YOLOv2 and 3 YOLOv3 train steps "
                        "here")
    parser.add_argument("--parent", default="",
                        help="a checkout of another commit (the parent's tree) "
                        "whose NMS, loss and BN kernels are timed in turns "
                        "with these")
    parser.add_argument("--parallel-rank", default="",
                        help=argparse.SUPPRESS)  # a rank of phase parallel
    parser.add_argument("--tp-rank", default="",
                        help=argparse.SUPPRESS)  # of phase tensor_parallel
    parser.add_argument("--trace-loss", default="",
                        help=argparse.SUPPRESS)  # phase measure's child
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import keras_object_detection_torch  # noqa: F401  fails outside the repo

    if args.parallel_rank:
        return parallel_rank(args.parallel_rank)
    if args.tp_rank:
        return tp_rank(args.tp_rank)
    if args.trace_loss:
        return trace_loss_child(args.trace_loss)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build(args.parent)
    nms = phase_nms(dev, args.parent)
    phase_check(dev)
    serve = phase_serve(dev, args.profile)
    loss = phase_loss(dev, args.parent)
    bn = phase_bn(dev, args.parent)
    optim = phase_optim(dev)
    phase_train_check(dev)
    train = phase_train(dev, args.profile)
    fit = phase_fit(dev, train)
    learn = phase_learn(dev)
    variants = phase_variants(dev)
    recipe = phase_recipe(dev)
    yolov2 = phase_yolov2(dev, args.profile)
    yolov3 = phase_yolov3(dev, args.profile)
    extras = phase_serving_extras(dev)
    int8 = phase_int8(dev)
    phase_launches(loss, nms, bn)
    parallel = phase_parallel(dev)
    tp = phase_tensor_parallel(dev)
    phase_surface(dev)
    measure = phase_measure(dev)
    counts = train["kernels"]["counts"]
    no_library = ("no single PyTorch call computes this function")
    nt = nms["timing"]
    k1 = {
        "name": "nms", "route": "cuda",
        "source": "keras_object_detection_torch/ops/csrc/nms.cu",
        "replaces": "keras_object_detection_tpu/ops/pallas_nms.py:81",
        "tpu": "ops/pallas_nms.py:_nms_kernel", "checked": True,
        "launches": (serve["launches"] + extras["modes"]["hard"]["k1_launches"]
                     + sum(int8[t]["k1_launches"] for t in INT8_PHASE)),
        "launches_serve": serve["launches"],
        "launches_serving_extras": extras["modes"]["hard"]["k1_launches"],
        **{f"launches_int8_{t}": int8[t]["k1_launches"] for t in INT8_PHASE},
        "launches_fit": fit["counts"]["nms"],
        "launches_fit_device_cache": fit["device_cache_counts"]["nms"],
        "launches_learn": learn["counts"]["nms"],
        "launches_learn_map_updates": learn["map_updates"],
        "launches_learn_round_trip": learn["round_trip"]["launches"],
        "learn_err": learn["errors"]["k1"],
        "max_abs_err": nms["max_abs_err"],
        "shape": [32, 49, 6], "ms": nt["32x49"]["new"]["ms"],
        "call_ms": nt["32x49"]["new"]["call_ms"],
        "plain_ms": nt["32x49"]["plain_ms"],
        "bound_ms": nt["32x49"]["bound_ms"], "bound_by": nt["32x49"]["bound_by"],
        "bound_ms_n2_rank": nt["32x49"]["bound_ms_n2_rank"],
        "library_ms": None, "library_note": no_library,
        "cuda_launches_per_call": nms["cuda_launches"]["new"],
        "floor_ms": nms["floor_ms"],
        "launch": {name: {k: t[k] for k in ("grid", "cluster", "threads",
                                             "smem_bytes")}
                   for name, t in nt.items()},
    }
    for name, t in nt.items():
        if name == "32x49":
            continue
        key = name.replace(" ", "_")
        k1.update({f"ms_{key}": t["new"]["ms"], f"call_ms_{key}": t["new"]["call_ms"],
                   f"plain_ms_{key}": t["plain_ms"], f"bound_ms_{key}": t["bound_ms"],
                   f"bound_ms_n2_rank_{key}": t["bound_ms_n2_rank"]})
    if "parent" in nt["32x49"]:
        k1.update(parent_ms=nt["32x49"]["parent"]["ms"],
                  parent_call_ms=nt["32x49"]["parent"]["call_ms"],
                  parent_cuda_launches_per_call=nms["cuda_launches"]["parent"])
        for name, t in nt.items():
            if name != "32x49":
                k1[f"parent_ms_{name.replace(' ', '_')}"] = t["parent"]["ms"]
    k1["launches_variants"] = {name: v["serve"]["launches"]
                               for name, v in variants.items()}
    k1["launches_recipe_fit"] = {f"steps_per_dispatch_{k}": v["counts"]["nms"]
                                 for k, v in recipe["fit"].items()}
    for tag, out in (("yolov2", yolov2), ("yolov3", yolov3)):
        k1.update({f"launches_{tag}": out["serve"]["launches"],
                   f"launches_{tag}_fit": out["fit"]["counts"]["nms"],
                   f"launches_{tag}_fit_map_updates": out["fit"]["map_updates"],
                   f"candidates_{tag}": out["serve"]["candidates"]})
        for name, t in out["nms_times"].items():
            k1.update({f"{f}_{tag}_{name}": t[f]
                       for f in ("ms", "plain_ms", "bound_ms", "bound_by")})
    k1["launches_parallel_mesh"] = {k: v["k1_launches"] for k, v in
                                    parallel["serving"].items()}
    k1["launches"] += sum(k1["launches_parallel_mesh"].values())
    k1["launches_tensor_parallel_mesh"] = {k: v["k1_launches"] for k, v in
                                           tp["serving"].items()}
    k1["launches"] += sum(k1["launches_tensor_parallel_mesh"].values())
    k1["launches_measure"] = measure["launches"]["nms"]
    k1["launches"] += k1["launches_measure"]
    k1["measure_err"] = measure["serving"]["k1_alone"]["max_abs_err"]
    k1["ms_measure_32x512"] = measure["serving"]["k1_alone"]["graph_ms"]
    k1["trace_loss"] = {"nms": nms["trace_loss"],
                        "measure": measure["serving"]["trace_loss"]}
    kernels = [k1]

    def parallel_entry(name: str) -> dict:
        two = [r["counts"][name] for r in parallel["gloo"]["ranks"]]
        return {"launches_parallel_world1": parallel["world1"]["counts"][name],
                "launches_parallel_gloo_ranks": two,
                "launches_parallel_steps": PARALLEL_STEPS,
                "launches_tensor_parallel_ranks": [
                    r["counts"][name] for r in tp["flagship"]],
                "launches_tensor_parallel_steps": TP_STEPS,
                "launches_tensor_parallel_profiled": tp["profile"]["launched"][
                    name],
                "launches_measure": measure["launches"][name]}

    def tp_shapes(key: str) -> list:
        return [{k: row[k] for k in ("shape", "calls", "ms", "bound_ms",
                                     "bound_by")}
                for row in tp["flagship"][0]["bn_shapes"] if row["kernel"] == key]

    for name, key, line in (("yolo_loss_forward", "forward", 107),
                            ("yolo_loss_backward", "backward", 149)):
        lt = loss["timing"][key]
        entry = {
            "name": name, "route": "cuda",
            "source": "keras_object_detection_torch/ops/csrc/yolo_loss.cu",
            "replaces": f"keras_object_detection_tpu/ops/pallas_loss.py:{line}",
            "checked": True, "launches": counts[name],
            "launches_fit": fit["counts"][name],
            "launches_fit_device_cache": fit["device_cache_counts"][name],
            "launches_learn": learn["counts"][name],
            "launches_learn_steps": learn["steps"],
            "learn_err": learn["errors"]["k4" if key == "forward" else "k5"],
            "max_abs_err": loss[f"{key}_err"], "shape": [3136, 30],
            "ms": lt["new"]["ms"], "call_ms": lt["new"]["call_ms"],
            "cuda_launches_per_call": lt["new"]["cuda_launches"],
            "blocks": lt["blocks"], "plain_ms": lt["plain_ms"],
            "bound_ms": lt["bound_ms"], "bound_by": lt["bound_by"],
            "library_ms": None, "library_note": no_library}
        entry["launches_variants"] = {v: out["counts"][name]
                                      for v, out in variants.items()}
        entry.update(recipe_kernel_entry(recipe, name, "k4" if key == "forward"
                                         else "k5"))
        entry.update(family_kernel_entry(yolov2, name, "yolov2"))
        entry.update(family_kernel_entry(yolov3, name, "yolov3"))
        entry.update(parallel_entry(name))
        if "parent" in lt:
            entry.update(parent_ms=lt["parent"]["ms"],
                         parent_call_ms=lt["parent"]["call_ms"],
                         parent_cuda_launches_per_call=lt["parent"]["cuda_launches"])
        kernels.append(entry)
    tot, big = bn["total"]["flagship"], bn["largest"]["flagship"]
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
            "launches_fit": fit["counts"][name],
            "launches_fit_device_cache": fit["device_cache_counts"][name],
            "launches_learn": learn["counts"][name],
            "launches_learn_steps": learn["steps"],
            "learn_err": learn["errors"][k],
            "max_abs_err": bn["max_abs"][key], "max_rel_err": bn["max_rel"][key],
            "shape": "the step's 25 BatchNorm inputs, bf16, batch 64",
            "ms": tot[k], "plain_ms": tot[p], "bound_ms": tot[b_],
            "bound_by": "bytes", "library_ms": tot[lib],
            "library_call_ms": tot[f"{lib}_call"], "library_call": call,
            "cuda_launches_per_call": bn["cuda_launches"][k]["new"],
            "call_ms": {"x".join(map(str, shape)): float(np.mean(tags["new"][k]))
                        for shape, tags in bn["call_ms"].items()},
            "largest_shape": big["shape"], "ms_largest": big[k],
            "plain_ms_largest": big[p], "bound_ms_largest": big[b_],
            "library_ms_largest": big[lib],
            "launches_variants": {v: out["counts"][name]
                                  for v, out in variants.items()},
            **{f"{field}_{group}": bn["total"][group][key_]
               for group in ("mobilenetv2", "gap_dense_2d")
               for field, key_ in (("ms", k), ("plain_ms", p),
                                   ("bound_ms", b_), ("library_ms", lib),
                                   ("library_call_ms", f"{lib}_call"))},
            **({f"parent_ms{suffix}": bn["total"][group][f"{k}_parent"]
                for group, suffix in (("flagship", ""),
                                      ("mobilenetv2", "_mobilenetv2"),
                                      ("gap_dense_2d", "_gap_dense_2d"))}
               if f"{k}_parent" in tot else {}),
            **({"parent_cuda_launches_per_call": bn["cuda_launches"][k]["parent"],
                "worst_ratio_to_parent": {g: w[k] for g, w in bn["worst"].items()}}
               if "parent" in bn["cuda_launches"][k] else {}),
            "shapes_mobilenetv2": len(bn["groups"]["mobilenetv2"]),
            "shape_gap_dense_2d": list(bn["groups"]["gap_dense_2d"][0]),
            **recipe_kernel_entry(recipe, name, "k2" if key == "stats"
                                  else "k3"),
            **family_kernel_entry(yolov2, name, "yolov2"),
            **family_kernel_entry(yolov3, name, "yolov3"),
            **parallel_entry(name),
            "tensor_parallel_shapes": tp_shapes(k)})
    kernels += optim_kernel_entries(optim)
    log(f"[train] kernels path p50 {train['kernels']['p50_ms']:.3f} ms, "
        f"{train['kernels']['images_per_s']:.1f} images/s; plain path p50 "
        f"{train['plain']['p50_ms']:.3f} ms, "
        f"{train['plain']['images_per_s']:.1f} images/s")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
