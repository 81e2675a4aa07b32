"""Serving latency split into device time and the host's dispatch
(counterpart of the repository's ``tools/serving_device_time.py``, which
measures the JAX package).

Three measurements a batch size of ``InferenceModel.predict`` (u8 / 255 ->
forward -> decode -> NMS, the kernel K1 on the GPU) over device-resident
u8 images:

1. ``serial_p50_ms`` / ``serial_min_ms``: one call at a time, each ended
   by a device synchronise (``benchmark_latency``): what a client calling
   one request at a time sees;
2. ``pipelined_per_call_ms``: ``--pipeline-k`` calls issued back to back
   and one synchronise (``benchmark_latency(pipeline_k=)``): the host
   queues work ahead of the card, so this tends to max(device time, host
   time a call);
3. ``trace_device_ms``: a ``utils/profiling.py`` trace of ``--trace-calls``
   calls, the busiest GPU stream lane's kernel time a call (JAX's "XLA
   Modules" lane); null where the trace has no GPU lane (the CPU), or
   where K1's events in it still differ from its launch counter after
   three traces, with a note of what the last trace held.

Each row adds ``traces``: how many traces ``checked_trace`` took (the
profiler now and then loses every device event of a trace while it keeps
the host's launch records, more often the longer the process has run).
The record adds ``port_kernel_launches``: each of the port's hand-written
kernels' launches over the whole run, from the wrappers' counters.
``cost_analysis_gflops`` (JAX: XLA's cost analysis of the program) is
``torch.utils.flop_counter.FlopCounterMode`` over one call: it counts the
FLOPs of convolutions and matrix products only. ``pallas_nms`` (JAX's key,
kept so the records read key by key) times the NMS alone the same three
ways at JAX's 32 x 512 candidates, IoU 0.5, confidence 0.25: here the CUDA
kernel K1 (``ops/csrc/nms.cu`` through ``auto_batched_non_max_suppression``).

Usage:
  python -m keras_object_detection_torch.cli.serving_device_time \\
      --checkpoint run/ckpt --batches 1,32 --out serving.json

Weights: ``--checkpoint`` (``load_serving_state``), by default random
flagship weights (``voc_full_config``, seed 0). Runs on ``--device``
(default cuda); writes the record only where ``--out`` names a file.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable

NMS_IOU, NMS_CONF = 0.5, 0.25  # JAX's tool's standalone NMS
NMS_SHAPE = (32, 512)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir with config.json; default: random "
                        "flagship weights (timing does not depend on "
                        "their values)")
    p.add_argument("--batches", default="1,32")
    p.add_argument("--runs", type=int, default=15)
    p.add_argument("--pipeline-k", type=int, default=32)
    p.add_argument("--trace-calls", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="output JSON (default: print only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def trace_device_ms(run: Callable[[], None], calls: int) -> dict:
    """``trace_device_ms`` (a call) and ``trace_note`` of a trace of
    ``calls`` calls of ``run`` (``checked_trace``: K1's launches in the
    trace equal to its counter's)."""
    from keras_object_detection_torch.utils.profiling import (
        checked_trace, device_busy_ms, trace_contents)

    events, seen, counted, tries = checked_trace(run, calls)
    if seen != counted:
        return {"trace_device_ms": None, "traces": tries, "trace_note": (
            f"the profiler lost device events in {tries} traces: K1 "
            f"{seen['nms']} traced, {counted['nms']} launched; the last "
            f"trace held {trace_contents(events)}")}
    busy, note = device_busy_ms(events)
    return {"trace_device_ms": None if busy is None else busy / calls,
            "trace_note": f"{note} over {calls} calls", "traces": tries}


def latency_keys(lat: dict, pipeline_k: int, runs: int) -> dict:
    """``profiling.call_latency``'s result under JAX's record's keys."""
    return {"serial_p50_ms": lat["p50_ms"], "serial_min_ms": lat["min_ms"],
            "pipelined_per_call_ms": lat["pipelined_per_call_ms"],
            "pipeline_depth": pipeline_k, "runs": runs}


def call_gflops(fn: Callable[[], object]) -> float:
    """GFLOPs of one call of ``fn`` (convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e9


def draw_inputs(batches, size: int, num_classes: int):
    """JAX's tool's inputs, drawn in its order from ``RandomState(0)``:
    ``({batch: (batch, size, size, 3) u8 images}, boxes)``, the boxes the
    standalone NMS input ``(32, 512, 6)``, rows ``[class, conf, cx, cy, w,
    h]`` with classes below ``num_classes`` and the rest uniform in [0,
    1)."""
    import numpy as np

    rng = np.random.RandomState(0)
    images = {b: rng.randint(0, 255, (b, size, size, 3), np.uint8)
              for b in batches}
    b, n = NMS_SHAPE
    boxes = np.concatenate([
        rng.randint(0, num_classes, (b, n, 1)).astype(np.float32),
        rng.uniform(0, 1, (b, n, 5)).astype(np.float32)], axis=-1)
    return images, boxes


def load_model(checkpoint, device):
    """``(config, InferenceModel, source)``: the checkpoint's best state,
    else random flagship weights."""
    import torch

    from keras_object_detection_torch.config import Config, voc_full_config
    from keras_object_detection_torch.eval import (InferenceModel,
                                                   load_serving_state)
    from keras_object_detection_torch.models import build_model

    if checkpoint:
        with open(os.path.join(checkpoint, "config.json")) as f:
            cfg = Config.from_json(f.read())
        _, state_dict, info = load_serving_state(cfg, checkpoint,
                                                 device=device)
        src = f"checkpoint {checkpoint} ({info})"
    else:
        cfg = voc_full_config()
        state_dict = build_model(cfg, torch.Generator().manual_seed(0)
                                 ).state_dict()
        src = "random flagship-shaped weights (voc_full_config)"
    return cfg, InferenceModel(cfg, state_dict, device=device), src


def measure(cfg, model, src: str, batches, runs: int = 15,
            pipeline_k: int = 32, trace_calls: int = 8) -> dict:
    """The record of JAX's tool for ``model`` at each batch size, and the
    NMS alone."""
    import torch

    from keras_object_detection_torch.cli.train_step_breakdown import platform
    from keras_object_detection_torch.ops.cuda_nms import \
        auto_batched_non_max_suppression
    from keras_object_detection_torch.utils.profiling import call_latency

    device = model.device
    size = cfg.model.image_size

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    results = {
        "description": (
            "Serving latency decomposition: serial (a synchronise a call, "
            "what a client sending one request at a time sees), pipelined "
            "(calls queued ahead of the device: an upper bound on device "
            "time) and the profiler trace's device busy time. "
            "InferenceModel.predict: u8/255, forward, decode, NMS (K1)."),
        "model": {"backbone": cfg.model.backbone, "head": cfg.model.head,
                  "image_size": size, "source": src,
                  "platform": platform(device)},
        "fused_serving": [],
    }
    images_of, nms_input = draw_inputs(batches, size, cfg.grid.num_classes)
    for b in batches:
        images = torch.from_numpy(images_of[b]).to(device)
        lat = model.benchmark_latency(images, runs=runs,
                                      pipeline_k=pipeline_k)
        row = {"batch": b, **latency_keys(lat, pipeline_k, runs)}

        def call():
            model.predict(images)
            sync()

        row.update(trace_device_ms(call, trace_calls))
        row["cost_analysis_gflops"] = call_gflops(
            lambda: model.predict(images))
        row["cost_note"] = ("torch.utils.flop_counter.FlopCounterMode over "
                            "one predict call: convolution and matrix "
                            "product FLOPs only")
        results["fused_serving"].append(row)
        print("fused", row)

    boxes = torch.from_numpy(nms_input).to(device)

    def nms():
        return auto_batched_non_max_suppression(boxes, NMS_IOU, NMS_CONF)

    lat = call_latency(nms, sync, runs, pipeline_k)
    row = {"batch": NMS_SHAPE[0], "candidates": NMS_SHAPE[1],
           **latency_keys(lat, pipeline_k, runs)}
    row.update(trace_device_ms(lambda: (nms(), sync()), trace_calls))
    row["note"] = ("the port's CUDA kernel K1 (ops/csrc/nms.cu) through "
                   "auto_batched_non_max_suppression" if device.type == "cuda"
                   else "K1's plain version (the boxes lie on the CPU)")
    results["pallas_nms"] = row
    print("nms", row)
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)

    from keras_object_detection_torch.cli.train_step_breakdown import write
    from keras_object_detection_torch.train.loop import _device
    from keras_object_detection_torch.utils.profiling import (
        launches_since, port_kernel_launches)

    device = _device(args.device, "serving")
    cfg, model, src = load_model(args.checkpoint, device)
    before = port_kernel_launches()
    results = measure(cfg, model, src,
                      [int(x) for x in args.batches.split(",")], args.runs,
                      args.pipeline_k, args.trace_calls)
    results["port_kernel_launches"] = launches_since(before)
    write(results, args.out)
    return results


if __name__ == "__main__":
    main()
