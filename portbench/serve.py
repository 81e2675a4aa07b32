"""The ``serve`` traffic kind: one client in a closed loop over the system's
``InferenceModel.predict``.

Each call serves ``batch`` u8 images taken in turn from a device-resident
pool and reads its rows and mask to the host before the next call
starts. A call's latency runs from its start to its results on the host.
Set-up makes the pool and the weights (running statistics from one
batch, ``weights.calibrate``), builds the model and warms it up on the
pool's first batch; the candidates above the confidence threshold and the
boxes kept an image go to standard error, since the random weights set
them. ``SAMPLE`` calls of the window, drawn from the seed by reservoir
sampling, are compared with the reference once the window has closed.
"""

from __future__ import annotations

import math
import random
import sys
import time

import torch

from portbench import check, traffic, weights as weights_mod
from portbench.reference import steps as reference
from portbench.cell import Cell, Outcome, sync

WARMUP = 3
TRACED = 8
SAMPLE = 8


def run(cell: Cell) -> Outcome:
    cfg, spec, dev, seed = cell.program_config, cell.traffic, cell.device, \
        cell.seed
    program = cell.program
    batch = spec["batch"]
    pool = traffic.dataset(cell.config, spec, seed, dev).images
    if pool.shape[0] % batch:
        raise ValueError(f"the pool of {pool.shape[0]} images does not "
                         f"divide into batches of {batch}")
    weights = weights_mod.make(cell.config, cell.weight_seed, dev,
                               **cell.weight_params)
    weights_mod.calibrate(cell.config, weights, pool[:batch])
    model = program.InferenceModel(cfg, weights, device=dev)
    batches = pool.shape[0] // batch
    calls = 0

    def one():
        nonlocal calls
        at = (calls % batches) * batch
        t0 = time.perf_counter()
        with cell.span("serve.predict"):
            rows, valid = model.predict(pool[at:at + batch])
        t1 = time.perf_counter()
        with cell.span("serve.readback"):
            rows, valid = rows.cpu(), valid.cpu()
        latency.append(time.perf_counter() - t0)
        dispatch.append(t1 - t0)
        # reservoir sampling of the calls the reference will check
        if len(sample) < SAMPLE:
            sample.append((at, rows, valid))
        else:
            j = chooser.randrange(calls + 1)
            if j < SAMPLE:
                sample[j] = (at, rows, valid)
        calls += 1

    with torch.inference_mode():
        decoded = model.predict_decoded(pool[:batch])
    above = (decoded[..., 1] > cfg.eval.conf_threshold).sum(1).float()
    for _ in range(WARMUP):
        rows, valid = model.predict(pool[:batch])
    kept = valid.sum(1).float()
    sync(dev)
    print(f"serve candidates {decoded.shape[1]} an image, above "
          f"{cfg.eval.conf_threshold}: mean {float(above.mean())} max "
          f"{float(above.max())}; kept: mean {float(kept.mean())} max "
          f"{float(kept.max())}", file=sys.stderr, flush=True)
    del decoded, rows, valid

    latency, dispatch, sample = [], [], []
    chooser = random.Random(seed)
    cell.setup_done()
    if cell.tracing:
        cell.take_trace(one, TRACED)
        latency.clear()
        dispatch.clear()
        sample.clear()
        chooser.seed(seed)
        calls = 0
    done, seconds = cell.window(one)
    peak = cell.memory_peak()

    del model
    cell.free()
    inputs = [pool[at:at + batch] for at, _, _ in sample]
    cell.compared = {"batches": inputs, "weights": weights,
                     "served": [(rows, valid) for _, rows, valid in sample]}
    ref = reference.serve(cell.config, weights, inputs)
    compared = ({"rows": rows.to(dev), "valid": valid.to(dev), "ref": r}
                for (_, rows, valid), r in zip(sample, ref))
    readings = check.serve_readings(compared, cell.config["eval"])
    latency.sort()
    p95 = latency[math.ceil(0.95 * len(latency)) - 1]  # nearest rank
    return Outcome(
        attempted=done, failed=0,
        end_to_end={"serve_images_per_s": done * batch / seconds,
                    "serve_p95_ms": p95 * 1e3},
        window={"images": done * batch, "seconds": seconds, "steps": done,
                "dispatch_s": dispatch, "batch": batch, "train": False},
        readings=readings, memory_peak=peak)
