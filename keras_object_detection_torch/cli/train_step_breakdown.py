"""Device time of the train step by kernel (counterpart of the repository's
``tools/train_step_breakdown.py``, which measures the JAX package).

The step of a config (``make_train_step``) is warmed up, timed untraced
(wall p50, each step ended by a value readback), then traced for
``--steps`` steps with ``utils/profiling.py``'s ``trace``: the GPU stream
lane's busy time is the step's device time (JAX's "XLA Modules" lane) and
its kernels, grouped by ``kernel_category`` (the CUDA kernel's function
name, where JAX groups HLO ops by category), the breakdown. With ``--scan
K`` the same is done for the chunk of K steps that
``TrainConfig.steps_per_dispatch`` runs from the device cache (the steps'
row indices and draws staged in one copy, ``train.loop.stage_chunk``),
reported beside the bare step as JAX reports its ``lax.scan`` program.

Inputs are JAX's: ``RandomState(0)`` u8 images, two fixed boxes an image,
weights drawn from seed 0, the step's draws from seed 1. The JSON keeps
JAX's keys, plus ``trace_note``, ``port_kernels_per_step`` (each of the
port's hand-written kernels a step, from the trace and from the wrappers'
launch counters) and ``port_kernel_launches`` (each one's launches over
the whole run, from the counters). Where the trace has no GPU lane (on the CPU), or its
port kernels still differ from the counters after three traces (the
profiler lost device events), the device fields are null and
``trace_note`` says why. A category is a kernel's function name only: a
name such as ``elementwise_kernel`` covers every layer that launches it
(BatchNorm, the optimizer, augmentation alike), so the categories do not
say which layer spent the time.

Usage:
  python -m keras_object_detection_torch.cli.train_step_breakdown \\
      --checkpoint run/ckpt --steps 8 --out breakdown.json
  python -m keras_object_detection_torch.cli.train_step_breakdown \\
      --preset voc_full --batch 32 --scan 4

Runs on ``--device`` (default cuda); prints the summary and writes the
record only where ``--out`` names a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

WARMUP = 3


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint dir with config.json: that run's step "
                        "shape (weights are drawn anew; timing does not "
                        "depend on their values)")
    p.add_argument("--preset", default="voc_full",
                   help="config preset (<preset>_config of "
                        "keras_object_detection_torch.config) when no "
                        "--checkpoint")
    p.add_argument("--batch", type=int, default=None,
                   help="override the batch size (default: the config's)")
    p.add_argument("--steps", type=int, default=8,
                   help="traced steps (after 3 warm-up steps)")
    p.add_argument("--timed-steps", type=int, default=20,
                   help="untraced steps for the wall-clock p50")
    p.add_argument("--scan", type=int, default=0, metavar="K",
                   help="also measure the steps_per_dispatch chunk of K "
                        "steps and report its per-step device time beside "
                        "the bare step's")
    p.add_argument("--out", default=None,
                   help="output JSON (default: print only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def load_config(checkpoint: Optional[str], preset: str,
                batch: Optional[int] = None):
    """``(config, source)``: ``checkpoint/config.json``'s, else the
    preset's, with ``batch`` as its batch size where given."""
    import keras_object_detection_torch.config as config_mod

    if checkpoint:
        with open(os.path.join(checkpoint, "config.json")) as f:
            cfg = config_mod.Config.from_json(f.read())
        src = f"checkpoint config {checkpoint}"
    else:
        cfg = getattr(config_mod, f"{preset}_config")()
        src = f"preset {preset}"
    if batch:
        cfg = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, batch_size=batch))
    return cfg, src


def synthetic_batch(cfg, device):
    """JAX's tool's batch: ``RandomState(0)`` u8 images, two boxes an
    image, on ``device``."""
    import numpy as np
    import torch

    batch, size = cfg.data.batch_size, cfg.model.image_size
    n = cfg.data.max_boxes_per_image
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (batch, size, size, 3), np.uint8)
    boxes = np.zeros((batch, n, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    boxes[:, 1] = [0.2, 0.25, 0.2, 0.3, 2.0]
    valid = np.zeros((batch, n), bool)
    valid[:, :2] = True
    return tuple(torch.from_numpy(x).to(device)
                 for x in (images, boxes, valid))


def chunk_runner(cfg, step, batch, seed: int, k: int) -> Callable:
    """``run(state) -> (state, metrics summed over the chunk)``: K steps
    as ``Trainer._train_batches`` feeds them from the device cache, their
    row indices (here each the whole batch, in order) and draws staged in
    one copy (``stage_chunk``), each step's batch gathered by its
    indices."""
    import numpy as np

    from keras_object_detection_torch.train.loop import stage_chunk

    images, boxes, valid = batch
    rows = [np.arange(images.shape[0])] * k

    def run(state):
        idx_rows, draws = stage_chunk(cfg, state.model, rows, seed,
                                      state.step, images.device)
        total: Dict = {}
        for idx, step_draws in zip(idx_rows, draws):
            state, metrics = step(state, images[idx], boxes[idx], valid[idx],
                                  seed, draws=step_draws)
            total = {n: total[n] + v if n in total else v
                     for n, v in metrics.items()}
        return state, total

    return run


def trace_breakdown(run: Callable[[], None], calls: int, steps: int) -> dict:
    """A trace of ``calls`` calls of ``run`` (``steps`` train steps in
    all, ``profiling.checked_trace``) per step: device ms, categories, top
    kernels, and each port kernel's launches from the trace and from the
    counters. A trace whose port kernels still differ from the counters
    after its retakes gives null device fields and says so."""
    from keras_object_detection_torch.utils.profiling import (
        checked_trace, device_busy_ms, op_breakdown, trace_contents)

    events, seen, counted, tries = checked_trace(run, calls)
    kernels = {"traced": {k: v / steps for k, v in seen.items()},
               "counted": {k: v / steps for k, v in counted.items()}}
    if seen != counted:
        return {"device_ms": None, "categories_ms_per_step": None,
                "top_ops_ms_per_step": None,
                "trace_note": (f"the profiler lost device events in {tries} "
                               f"traces: port kernels {seen} traced, "
                               f"{counted} launched; the last trace held "
                               f"{trace_contents(events)}"),
                "port_kernels_per_step": kernels}
    busy, note = device_busy_ms(events)
    bd = op_breakdown(events)
    return {
        "device_ms": None if busy is None else busy / steps,
        "trace_note": f"{note} over {steps} steps, {tries} trace(s)",
        "categories_ms_per_step": {k: v / steps
                                   for k, v in bd["categories"].items()},
        "top_ops_ms_per_step": [
            {"name": o["name"], "ms": o["ms"] / steps,
             "count_per_step": o["count"] / steps} for o in bd["top_ops"]],
        "port_kernels_per_step": kernels,
    }


def wall_ms(run: Callable[[], None], n: int) -> List[float]:
    """Host milliseconds of ``n`` calls of ``run`` (each ends in a value
    readback), sorted."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1000)
    return sorted(times)


def measure(cfg, src: str, device, steps: int = 8, timed_steps: int = 20,
            scan: int = 0, seed: int = 1) -> dict:
    """The record of JAX's tool for ``cfg``'s train step on ``device``."""
    import torch

    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    batch = synthetic_batch(cfg, device)
    b = cfg.data.batch_size
    step = make_train_step(cfg)
    box = {"state": create_train_state(cfg, torch.Generator().manual_seed(0),
                                       device)}

    def one():
        box["state"], metrics = step(box["state"], *batch, seed)
        float(metrics["total"])  # value readback: a true sync

    for _ in range(WARMUP):
        one()
    times = wall_ms(one, timed_steps)
    bare = trace_breakdown(one, steps, steps)
    dev_ms = bare["device_ms"]
    result = {
        "description": (
            "Per-step device breakdown of the train step: the GPU stream "
            "lane's kernels grouped by CUDA kernel function name "
            "(kernel_category; JAX groups HLO ops by category) over a "
            "torch.profiler trace; a function name does not name the layer "
            "that launched it. "
            "wall_p50_ms includes the host's dispatch; device_ms is the "
            "busiest stream lane's summed kernel time (device busy time)."),
        "model": {"backbone": cfg.model.backbone, "head": cfg.model.head,
                  "image_size": cfg.model.image_size, "batch": b,
                  "source": src, "platform": platform(device)},
        "wall_p50_ms": times[len(times) // 2],
        "device_ms_per_step": dev_ms,
        "images_per_s_device": None if dev_ms is None else b / dev_ms * 1000,
        "traced_steps": steps,
        "categories_ms_per_step": bare["categories_ms_per_step"],
        "top_ops_ms_per_step": bare["top_ops_ms_per_step"],
        "trace_note": bare["trace_note"],
        "port_kernels_per_step": bare["port_kernels_per_step"],
    }
    if scan:
        del box["state"]
        box["state"] = create_train_state(
            cfg, torch.Generator().manual_seed(0), device)
        chunk = chunk_runner(cfg, step, batch, seed, scan)

        def dispatch():
            box["state"], metrics = chunk(box["state"])
            float(metrics["total"])

        for _ in range(2):
            dispatch()
        stimes = wall_ms(dispatch, max(timed_steps // scan, 3))
        n_disp = max(steps // scan, 2)
        sb = trace_breakdown(dispatch, n_disp, n_disp * scan)
        result["scan_dispatch"] = {
            "steps_per_dispatch": scan,
            "wall_p50_ms_per_step": stimes[len(stimes) // 2] / scan,
            "device_ms_per_step": sb["device_ms"],
            "vs_bare_step_device": (
                None if sb["device_ms"] is None or not dev_ms
                else sb["device_ms"] / dev_ms),
            "categories_ms_per_step": sb["categories_ms_per_step"],
            "trace_note": sb["trace_note"],
            "port_kernels_per_step": sb["port_kernels_per_step"],
        }
    return result


def platform(device) -> str:
    """The device's name as the record states it."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def write(result: dict, out: Optional[str]) -> None:
    """Write ``result`` as JSON to ``out`` (nothing without one)."""
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
        print("wrote", out)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from keras_object_detection_torch.train.loop import _device
    from keras_object_detection_torch.utils.profiling import (
        launches_since, port_kernel_launches)

    device = _device(args.device, "the breakdown")
    cfg, src = load_config(args.checkpoint, args.preset, args.batch)
    before = port_kernel_launches()
    result = measure(cfg, src, device, args.steps, args.timed_steps,
                     args.scan)
    result["port_kernel_launches"] = launches_since(before)
    print(json.dumps({k: result[k] for k in (
        "wall_p50_ms", "device_ms_per_step", "images_per_s_device",
        "categories_ms_per_step", "scan_dispatch") if k in result},
        indent=2))
    write(result, args.out)
    return result


if __name__ == "__main__":
    main()
