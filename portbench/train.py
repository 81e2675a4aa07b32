"""The ``train`` traffic kind: the system's train step driven as its
``Trainer`` drives it from a device-resident dataset.

Each step's rows are gathered from the dataset by the epoch's shuffled
indices; their indices and the step's draws go to the device in one copy a
chunk of ``steps_per_dispatch`` steps (``stage_chunk``); the step's loss
terms are summed on the device and read back once an epoch, so the host
dispatches ahead of the device.

Set-up makes the dataset and the weights, builds the train state and its
step, and drives that same object through ``WARMUP`` steps: the first
three are the ones the reference follows (their losses, the first
gradient from the optimizer's state and the parameters' change are kept).
The traced run then traces ``TRACED`` steps. The window runs steps until
``seconds`` have passed on the host, then waits for the device.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from portbench import check, traffic, weights as weights_mod
from portbench.reference import steps as reference
from portbench.reference.optim import ONE_MINUS_B1
from portbench.cell import Cell, Outcome, sync

WARMUP = 5
FOLLOWED = 3  # steps the reference follows
TRACED = 4


class Feed:
    """The epochs' batches of row indices, in order, from the seed."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch, self.seed = n, batch, seed
        self.epoch, self.at = 0, 0
        self.order = traffic.epoch_order(n, batch, seed, 0)

    def take(self, k: int):
        """The next ``k`` steps' indices (fewer at an epoch's end) and
        whether they end the epoch."""
        rows = list(self.order[self.at:self.at + k].numpy())
        self.at += len(rows)
        ends = self.at == len(self.order)
        if ends:
            self.epoch += 1
            self.at = 0
            self.order = traffic.epoch_order(self.n, self.batch, self.seed,
                                             self.epoch)
        return rows, ends


def run(cell: Cell) -> Outcome:
    cfg, spec, dev, seed = cell.program_config, cell.traffic, cell.device, \
        cell.seed
    program = cell.program
    batch = spec["batch"]
    data = traffic.dataset(cell.config, spec, seed, dev)
    weights = weights_mod.make(cell.config, cell.weight_seed, dev,
                               **cell.weight_params)
    state = program.create_train_state(cfg, torch.Generator().manual_seed(0),
                                       dev)
    state.model.load_state_dict(weights)
    del weights  # made again for the reference: a run holds no second copy
    step = program.make_train_step(cfg)
    feed = Feed(data.images.shape[0], batch, seed)
    k = cfg.train.steps_per_dispatch or 1
    pending = []  # staged steps not yet run: (indices, draws)
    followed = []  # the followed steps' row indices, for the reference

    def next_step():
        nonlocal pending
        ends = False
        if not pending:
            rows, ends = feed.take(k)
            idx_rows, draws = program.stage_chunk(cfg, state.model, rows, seed,
                                                  state.step, dev)
            pending = list(zip(idx_rows, draws))
        idx, draws = pending.pop(0)
        return (idx, data.images[idx], data.boxes[idx], data.valid[idx],
                draws, ends and not pending)

    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    start = [p.detach().clone() for p in params]
    prog: Dict = {"loss": []}
    for i in range(WARMUP):
        idx, images, boxes, valid, draws, _ = next_step()
        if i < FOLLOWED:
            followed.append(idx)
        state, metrics = step(state, images, boxes, valid, seed, draws)
        if i < FOLLOWED:
            prog["loss"].append(float(metrics["total"]))
        if i == 0:
            prog["grad"] = {n: float(m.norm()) / ONE_MINUS_B1
                            for n, m in zip(names, state.opt.mu)}
        if i == FOLLOWED - 1:
            prog["change"] = {n: float((p.detach() - s).norm())
                              for n, p, s in zip(names, params, start)}
            del start
    sync(dev)

    def one():
        _, images, boxes, valid, draws, ends = next_step()
        with cell.span("train.dispatch"):
            t0 = time.perf_counter()
            out = step(state, images, boxes, valid, seed, draws)
            dispatch.append(time.perf_counter() - t0)
        acc["total"] = acc.get("total", 0.0) + out[1]["total"]
        if ends:  # the epoch's one readback
            with cell.span("train.readback"):
                sums.append(float(acc.pop("total")))

    dispatch, acc, sums = [], {}, []
    cell.setup_done()
    if cell.tracing:
        cell.take_trace(one, TRACED)
    dispatch.clear()
    steps, seconds = cell.window(one)
    peak = cell.memory_peak()
    if "total" in acc:
        sums.append(float(acc.pop("total")))
    finite = all(math.isfinite(x) for x in sums)

    rows = [(data.images[i], data.boxes[i], data.valid[i]) for i in followed]
    del state, step, data, pending, params
    cell.free()
    weights = weights_mod.make(cell.config, cell.weight_seed, dev,
                               **cell.weight_params)
    ref = reference.train(cell.config, weights, rows, seed)
    cell.compared = {"rows": rows, "weights": weights, "prog": prog,
                     "ref": ref}
    images = steps * batch
    return Outcome(
        attempted=steps, failed=0 if finite else steps,
        end_to_end={"train_images_per_s": images / seconds,
                    "train_peak_mem_gib": peak / 2 ** 30},
        window={"images": images, "seconds": seconds, "steps": steps,
                "dispatch_s": dispatch, "batch": batch, "train": True},
        readings=check.train_readings(prog, ref), memory_peak=peak)
