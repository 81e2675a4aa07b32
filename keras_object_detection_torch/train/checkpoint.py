"""Checkpoints of the whole train state, kept by a best-by-metric rule
(counterpart of ``keras_object_detection_tpu/train/checkpoint.py``
``CheckpointManager`` and ``average_checkpoints``).

The format is the port's own: one directory per step (the epoch, as
``Trainer.fit`` saves), ``<dir>/<step>/state.pt`` a ``torch.save`` of CPU
tensors (the model's state dict, the optimizer state, the step count, the
EMA) and ``<dir>/<step>/metrics.json``. The JAX package's orbax checkpoints
are not read; ``models/convert.py`` carries their weights over.

Retention follows orbax's ``CheckpointManager`` under
``CheckpointManagerOptions(max_to_keep, best_fn, best_mode="min")`` as the
JAX package configures it (checked against orbax itself):

- the steps are ordered worst to best by the metric, a tie ranking the
  newer step better, and the best ``max_to_keep`` are kept; a new step
  that does not make that cut is dropped at once;
- ``best_step`` is the best of them, ``latest_step`` the newest kept;
- a save at a step not above ``latest_step`` is skipped.

``save`` copies the state to host memory before it returns, since the train
step updates the state in place; the file is written by a background
thread, as orbax saves asynchronously (``wait`` joins it). ``restore``
returns a new state that shares no tensor with the template or the model
being trained. A manager that is not the ``writer`` (a data-parallel rank
other than 0) keeps the same books and writes nothing; every rank reads.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_NAME = "state.pt"
METRICS_NAME = "metrics.json"
MONITOR = "val_loss"  # lower is better


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_to_host(state) -> Dict[str, Any]:
    """A ``TrainState`` as a dict of CPU tensor copies."""
    opt = state.opt
    return {
        "step": int(state.step),
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "opt": {"name": opt.name, "lr": _host(opt.lr), "count": int(opt.count),
                "mu": [_host(t) for t in opt.mu],
                "nu": [_host(t) for t in opt.nu],
                "trace": [_host(t) for t in opt.trace],
                "weight_decay": opt.weight_decay},
        "ema": (None if state.ema is None
                else {k: _host(v) for k, v in state.ema.items()}),
    }


def state_from_host(template, payload: Dict[str, Any]):
    """A copy of ``template`` (a ``TrainState``) holding ``payload``'s
    values on the template's devices. A checkpoint without an EMA keeps the
    template's."""
    state = copy.deepcopy(template)
    state.model.load_state_dict(payload["model"], strict=True)
    opt, saved = state.opt, payload["opt"]
    trace = saved.get("trace", [])  # checkpoints written before sgdw: none
    if (saved["name"] != opt.name or len(saved["mu"]) != len(opt.mu)
            or len(trace) != len(opt.trace)):
        raise ValueError(f"the checkpoint's optimizer is {saved['name']!r}, "
                         f"the template's {opt.name!r}")
    with torch.no_grad():
        opt.lr.copy_(saved["lr"])
        for dst, src in zip(opt.mu + opt.nu + opt.trace,
                            saved["mu"] + saved["nu"] + trace):
            dst.copy_(src)
    opt.count = saved["count"]
    opt.weight_decay = saved.get("weight_decay", opt.weight_decay)
    if payload["ema"] is not None:
        dev = next(state.model.parameters()).device
        state.ema = {k: v.to(dev, copy=True) for k, v in payload["ema"].items()}
    state.step = payload["step"]
    return state


class CheckpointManager:
    """The best ``max_to_keep`` checkpoints by ``MONITOR``, as orbax keeps
    them (module docstring)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 writer: bool = True):
        self.directory = os.path.abspath(directory)
        self.writer = writer
        if writer:
            os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._metrics: Dict[int, float] = {}
        # a reader may come before the writer has made the directory
        names = (os.listdir(self.directory) if os.path.isdir(self.directory)
                 else [])
        for name in names:
            path = os.path.join(self.directory, name, METRICS_NAME)
            if name.isdigit() and os.path.exists(path):
                with open(path) as f:
                    self._metrics[int(name)] = json.load(f)[MONITOR]
        self._pool = concurrent.futures.ThreadPoolExecutor(1)
        self._pending: List[concurrent.futures.Future] = []

    def _ranked(self) -> List[int]:
        """Kept steps, worst first (a tie ranks the newer step better)."""
        by_step = sorted(self._metrics.items())
        return [s for s, _ in sorted(by_step, key=lambda kv: kv[1],
                                     reverse=True)]

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _write(self, step: int, payload, metrics: dict,
               dropped: List[int]) -> None:
        if payload is not None:
            tmp = f"{self._path(step)}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, STATE_NAME))
            with open(os.path.join(tmp, METRICS_NAME), "w") as f:
                json.dump(metrics, f)
            shutil.rmtree(self._path(step), ignore_errors=True)
            os.replace(tmp, self._path(step))
        for s in dropped:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def save(self, step: int, state, metrics: dict) -> bool:
        """Save ``state`` at ``step`` with ``metrics[MONITOR]``; False when
        the step is not above ``latest_step`` and nothing is saved."""
        latest = self.latest_step
        if latest is not None and step <= latest:
            return False
        value = float(metrics[MONITOR])
        self._metrics[step] = value
        ranked = self._ranked()
        cut = (len(ranked) - self._max_to_keep
               if self._max_to_keep is not None else 0)
        dropped = ranked[:max(cut, 0)]
        for s in dropped:
            del self._metrics[s]
        if not self.writer:
            return True
        # the host copy is taken before the next step changes the state
        payload = None if step in dropped else state_to_host(state)
        self._pending.append(self._pool.submit(
            self._write, step, payload, {"step": step, MONITOR: value},
            [s for s in dropped if s != step]))
        return True

    def load(self, step: int) -> Dict[str, Any]:
        """The checkpoint at ``step`` as CPU tensors (``state_to_host``'s
        layout)."""
        self.wait()
        if step not in self._metrics:
            raise FileNotFoundError(f"no checkpoint at step {step} in "
                                    f"{self.directory} (kept: {self.all_steps})")
        return torch.load(os.path.join(self._path(step), STATE_NAME),
                          map_location="cpu", weights_only=True)

    def restore(self, template, step: Optional[int] = None):
        """A new state like ``template`` holding the checkpoint at ``step``,
        by default the best (every checkpoint has a metric, so there is a
        best whenever there is a checkpoint)."""
        step = self.best_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return state_from_host(template, self.load(step))

    @property
    def all_steps(self) -> List[int]:
        return sorted(self._metrics)

    @property
    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._metrics) if self._metrics else None

    @property
    def latest_epoch(self) -> Optional[int]:
        """``Trainer.fit`` saves at the epoch, so a resumed run continues at
        ``latest_epoch + 1``."""
        return self.latest_step

    def wait(self) -> None:
        """Block until every save has reached the disk (and raise what a
        background write raised)."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def average_checkpoints(manager: CheckpointManager, template,
                        steps: Optional[List[int]] = None, last_k: int = 0):
    """The uniform average of checkpoints ``steps`` (default: all kept, or
    the newest ``last_k``): every floating entry of the model's state dict
    (parameters and BN running statistics) and of the EMA is averaged; the
    optimizer state and the step come from the newest."""
    if steps is None:
        steps = manager.all_steps
        if last_k:
            steps = steps[-last_k:]
    if not steps:
        raise FileNotFoundError("no checkpoints to average")
    payloads = [manager.load(s) for s in sorted(steps)]

    def mean(tensors):
        if not tensors[0].is_floating_point():
            return tensors[-1]
        return sum(tensors[1:], tensors[0]) / len(tensors)

    out = dict(payloads[-1])
    for field in ("model", "ema"):
        trees = [p[field] for p in payloads]
        if any(t is None for t in trees):
            continue
        out[field] = {k: mean([t[k] for t in trees]) for k in trees[-1]}
    return state_from_host(template, out)
