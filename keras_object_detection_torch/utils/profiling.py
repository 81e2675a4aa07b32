"""Profiling and tracing (counterpart of
``keras_object_detection_tpu/utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of everything inside the
  context (CPU and, where there is a GPU, CUDA activities), written as a
  Chrome trace into ``logdir``;
- ``StepTimer``: steady-state step timing, each measured window ended by a
  value readback (a true device synchronisation);
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` of the current
  GPU, None on the CPU;
- ``traced_events`` / ``device_lane_ms`` / ``op_breakdown``: the Chrome
  traces under a directory read back into per-lane device busy time and a
  per-kernel-category breakdown. A torch trace's device events are its GPU
  kernels, copies and sets (``cat`` ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), one lane a stream; the JAX package's trace layout (a
  device process, its "XLA Ops" lane) is read as JAX reads it, so the same
  events give the same numbers.

``tools/torch_trace_summary.py`` attributes the device time of a trace to
the CPU ops that launched it; this module keeps JAX's interface.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of everything inside the context
    into ``logdir/trace_<pid>.json`` (CUDA activities too where a GPU is
    available). Pending device work is synchronised at both ends, so the
    trace holds the context's kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Rolling throughput meter for a training loop.

    >>> timer = StepTimer(batch_size=64)
    >>> for batch in ds: state, m = step(state, *batch); timer.tick(m["total"])
    >>> timer.summary()  # {'steps': ..., 'images_per_s': ..., 'p50_ms': ...}
    """

    def __init__(self, batch_size: int, sync_every: int = 10):
        self.batch_size = batch_size
        self.sync_every = sync_every
        self._times: list = []
        self._last = None
        self._steps = 0

    def tick(self, sync_value=None) -> None:
        """Call once per step; pass a device scalar to force a sync point
        every ``sync_every`` steps."""
        self._steps += 1
        if sync_value is not None and self._steps % self.sync_every == 0:
            float(sync_value)  # device round-trip = true step boundary
            now = time.perf_counter()
            if self._last is not None:
                self._times.append((now - self._last) / self.sync_every)
            self._last = now

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": self._steps, "images_per_s": 0.0, "p50_ms": 0.0}
        ts = sorted(self._times)
        p50 = ts[len(ts) // 2]
        return {
            "steps": self._steps,
            "images_per_s": self.batch_size / p50,
            "p50_ms": p50 * 1000.0,
        }


def traced_events(trace_dir: str) -> List[dict]:
    """Every event of the Chrome traces (``*.json``, ``*.json.gz``) under
    ``trace_dir``, as one ``traceEvents`` list; raises RuntimeError where
    there is none."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True)
                   + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                               recursive=True))
    if not paths:
        raise RuntimeError(f"no trace (*.json, *.json.gz) under {trace_dir}")
    events: List[dict] = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        events += data.get("traceEvents", []) if isinstance(data, dict) \
            else data
    return events


def _lane_names(events: List[dict]) -> Tuple[Dict, Dict]:
    """(pid -> process name, (pid, tid) -> thread/lane name) metadata."""
    pnames = {e["pid"]: str(e.get("args", {}).get("name", ""))
              for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    tnames = {(e["pid"], e.get("tid")): str(e.get("args", {}).get("name", ""))
              for e in events
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    return pnames, tnames


def _device_pids(pnames: Dict) -> set:
    """Accelerator-plane pids of the JAX layout ("/device:TPU:0 ..."),
    never host threads."""
    return {pid for pid, name in pnames.items()
            if ("tpu" in name.lower() or "device" in name.lower())
            and "host" not in name.lower()}


def _device_events(events: List[dict]):
    """``(event, lane)`` of every timed device event: a torch trace's GPU
    kernels, copies and sets (lane: the process / stream), or an event on a
    device plane of the JAX layout (lane: process / thread name)."""
    pnames, tnames = _lane_names(events)
    dev = _device_pids(pnames)
    for e in events:
        if e.get("ph") != "X" or not e.get("dur"):
            continue
        torch_device = e.get("cat") in DEVICE_CATEGORIES
        if not torch_device and e.get("pid") not in dev:
            continue
        pid, tid = e.get("pid"), e.get("tid")
        lane = tnames.get((pid, tid)) or (f"stream {tid}" if torch_device
                                          else tid)
        yield e, f"{pnames.get(pid, pid)}/{lane}"


def device_lane_ms(events: List[dict]) -> Dict[str, float]:
    """Total duration (ms) per device lane. A torch trace's GPU stream lane
    holds its kernels one after another, so its sum is that stream's busy
    time; in the JAX layout the "XLA Modules" lane is (its other lanes
    stack nested events)."""
    lanes: Dict[str, float] = {}
    for e, lane in _device_events(events):
        lanes[lane] = lanes.get(lane, 0.0) + float(e["dur"]) / 1e3
    return lanes


_OP_PREFIX = re.compile(r"^%?([a-zA-Z][a-zA-Z_-]*)")


def kernel_category(name: str) -> str:
    """A GPU event's category: the kernel's function name from its
    demangled signature (``void ns::(anonymous namespace)::bn_stats_kernel<
    float, 8, false, 8>(...)`` -> ``bn_stats_kernel``), a name without one
    as it is up to its first ``<`` or ``(`` ("Memcpy HtoD (Pinned ->
    Device)" -> "Memcpy HtoD")."""
    head = name.strip().replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head.removeprefix("void "), maxsplit=1)[0]
    return head.split("::")[-1].strip() or "other"


def op_category(name: str) -> str:
    """HLO instruction name -> coarse category, JAX's rule ("fusion.123"
    -> "fusion", "%convolution.5" -> "convolution", "copy-done.2" ->
    "copy")."""
    m = _OP_PREFIX.match(name.strip())
    if not m:
        return "other"
    cat = m.group(1).lower()
    # canonicalize async pairs and numbered variants
    for base in ("copy", "all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute", "send", "recv"):
        if cat.startswith(base):
            return base
    return cat


def op_breakdown(events: List[dict], top_k: Optional[int] = 25
                 ) -> Dict[str, object]:
    """The device's leaf ops by category: a torch trace's GPU kernels,
    copies and sets (``kernel_category``), or the JAX layout's "XLA Ops"
    lane (``op_category``; its events tile the module execution without
    nesting, so the sums are additive).

    Returns ``{"categories": {cat: ms}, "top_ops": [{name, ms, count},
    ...], "total_ms": float}`` over the whole trace (``top_k`` None: every
    op); divide by the number of traced calls for per-call numbers."""
    cats: Dict[str, float] = {}
    per_op: Dict[str, List[float]] = {}
    total = 0.0
    for e, lane in _device_events(events):
        torch_device = e.get("cat") in DEVICE_CATEGORIES
        if (not torch_device
                and "xla ops" not in lane.rsplit("/", 1)[-1].lower()):
            continue
        ms = float(e["dur"]) / 1e3
        name = str(e.get("name", ""))
        cat = kernel_category(name) if torch_device else op_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
        total += ms
        acc = per_op.setdefault(name, [0.0, 0])
        acc[0] += ms
        acc[1] += 1
    top = sorted(per_op.items(), key=lambda kv: -kv[1][0])
    return {
        "categories": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "top_ops": [{"name": n, "ms": round(v[0], 4), "count": v[1]}
                    for n, v in (top if top_k is None else top[:top_k])],
        "total_ms": round(total, 4),
    }


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The current GPU's ``torch.cuda.memory_stats`` (allocated, reserved,
    peak bytes, ...); None without a GPU."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {k: int(v) for k, v in stats.items()} if stats else None
