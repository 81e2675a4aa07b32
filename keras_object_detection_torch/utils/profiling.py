"""Profiling and tracing (counterpart of
``keras_object_detection_tpu/utils/profiling.py``):

- ``span(name)``: a named host span of the port's own (the train step's
  and ``predict``'s stages), recorded into the trace while a
  ``torch.profiler`` session records, one flag check otherwise;
- ``trace(logdir)``: a ``torch.profiler`` trace of everything inside the
  context (CPU and, where there is a GPU, CUDA activities, with a margin
  of host time on both sides), written as a Chrome trace into ``logdir``;
- ``StepTimer``: steady-state step timing, each measured window ended by a
  value readback (a true device synchronisation);
- ``device_memory_stats()``: ``torch.cuda.memory_stats`` of the current
  GPU, None on the CPU;
- ``traced_events`` / ``device_lane_ms`` / ``op_breakdown``: the Chrome
  traces under a directory read back into per-lane device busy time and a
  per-kernel-category breakdown. A torch trace's device events are its GPU
  kernels, copies and sets (``cat`` ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``), one lane a stream;
- ``port_kernel`` / ``traced_port_kernels`` / ``port_kernel_launches`` /
  ``launches_since``: the port's hand-written kernels (K1–K6) in a trace,
  by kernel name, and in their wrappers' launch counters;
- ``checked_trace`` / ``device_busy_ms`` / ``trace_contents``: a trace
  retaken where its port kernels differ from the counters, its busiest
  device lane's time, and its device events beside the host's launches;
- ``call_latency``: serial and pipelined host time of a call.

``tools/torch_trace_summary.py`` attributes the device time of a trace to
the CPU ops that launched it; this module keeps JAX's interface, less
``op_category`` (XLA's op names: the port writes torch traces only).
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

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that marks a stage of the port's work as the host span
    ``name`` in a ``torch.profiler`` trace (``record_function``), on the
    host clock onto which the trace maps the device's events. With no
    session recording it is one shared no-op context: no
    ``record_function`` (which costs its entry and exit even with no
    profiler on), no synchronise, no CUDA event. ``_is_profiler_enabled``
    is torch's own flag, true from a session's start to its stop
    (``tests/test_torch_spans.py`` holds it)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


# seconds of host time the capture window opens before the traced work and
# stays open after it: the profiler keeps only the GPU records whose
# timestamps, as CUPTI converts them to the host's clock, fall inside the
# window, and that conversion can be off by a millisecond or more (PERF.md
# §6, fault 3.5)
TRACE_MARGIN_S = 0.05


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of everything inside the context
    into ``logdir/trace_<pid>.json`` (CUDA activities too where a GPU is
    available). Pending device work is synchronised at both ends, so the
    trace holds the context's kernels; the window opens ``TRACE_MARGIN_S``
    before the context's work and closes as long after it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        time.sleep(TRACE_MARGIN_S)
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
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


def _device_events(events: List[dict]):
    """``(event, lane)`` of every timed device event: the trace's GPU
    kernels, copies and sets (lane: the process / stream)."""
    pnames, tnames = _lane_names(events)
    for e in events:
        if (e.get("ph") != "X" or not e.get("dur")
                or e.get("cat") not in DEVICE_CATEGORIES):
            continue
        pid, tid = e.get("pid"), e.get("tid")
        lane = tnames.get((pid, tid)) or f"stream {tid}"
        yield e, f"{pnames.get(pid, pid)}/{lane}"


def device_lane_ms(events: List[dict]) -> Dict[str, float]:
    """Total duration (ms) per device lane. A GPU stream's lane holds its
    kernels one after another, so its sum is that stream's busy time."""
    lanes: Dict[str, float] = {}
    for e, lane in _device_events(events):
        lanes[lane] = lanes.get(lane, 0.0) + float(e["dur"]) / 1e3
    return lanes


def kernel_category(name: str) -> str:
    """A GPU event's category: the kernel's function name from its
    demangled signature (``void ns::(anonymous namespace)::bn_stats_kernel<
    float, 8, false, 8>(...)`` -> ``bn_stats_kernel``), a name without one
    as it is up to its first ``<`` or ``(`` ("Memcpy HtoD (Pinned ->
    Device)" -> "Memcpy HtoD")."""
    head = name.strip().replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head.removeprefix("void "), maxsplit=1)[0]
    return head.split("::")[-1].strip() or "other"


# the port's hand-written kernels: each wrapper's launch counter
PORT_KERNELS = {"nms": ("cuda_nms", "LAUNCHES"),
                "bn_stats": ("bn", "STATS_LAUNCHES"),
                "bn_grad_stats": ("bn", "GRAD_STATS_LAUNCHES"),
                "yolo_loss_forward": ("yolo_loss", "FORWARD_LAUNCHES"),
                "yolo_loss_backward": ("yolo_loss", "BACKWARD_LAUNCHES"),
                "optim_update": ("optim_update", "LAUNCHES")}


def port_kernel(name: str) -> Optional[str]:
    """The port's kernel (a key of ``PORT_KERNELS``) that a GPU event of
    this name is, or None: ``ops/csrc/nms.cu``'s ``nms_kernel`` (K1),
    ``bn_stats.cu``'s ``bn_stats_kernel`` with ``GRAD`` false (K2) or true
    (K3), ``yolo_loss.cu``'s ``loss_forward_kernel`` (K4) and
    ``loss_backward_kernel`` (K5), ``optim_update.cu``'s
    ``optim_update_kernel`` (K6)."""
    cat = kernel_category(name)
    if cat == "bn_stats_kernel":
        return "bn_grad_stats" if ", true," in name else "bn_stats"
    return {"nms_kernel": "nms", "loss_forward_kernel": "yolo_loss_forward",
            "loss_backward_kernel": "yolo_loss_backward",
            "optim_update_kernel": "optim_update"}.get(cat)


def port_kernel_launches() -> Dict[str, int]:
    """The launch counters of the port's kernel wrappers (each adds one
    where it launches its kernel), by ``PORT_KERNELS`` name."""
    import importlib

    return {k: getattr(importlib.import_module(
        f"keras_object_detection_torch.ops.{module}"), attr)
        for k, (module, attr) in PORT_KERNELS.items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """The port's kernel launches since ``before`` (a
    ``port_kernel_launches()`` reading)."""
    return {k: v - before[k] for k, v in port_kernel_launches().items()}


def traced_port_kernels(events: List[dict]) -> Dict[str, int]:
    """How many GPU events of each of the port's kernels a trace holds."""
    out = dict.fromkeys(PORT_KERNELS, 0)
    for e, _ in _device_events(events):
        kind = port_kernel(str(e.get("name", "")))
        if kind is not None:
            out[kind] += 1
    return out


def checked_trace(run, calls: int, tries: int = 3
                  ) -> Tuple[List[dict], Dict, Dict, int]:
    """``(events, port kernels traced, port kernels counted, traces
    taken)`` of a ``trace`` of ``calls`` calls of ``run``. Where the
    trace's port kernels differ from their wrappers' launch counters over
    the same calls (the profiler lost device events) the trace is taken
    again, up to ``tries`` times; the caller reads ``traced != counted``
    as a failed trace."""
    import tempfile

    for attempt in range(1, tries + 1):
        before = port_kernel_launches()
        with tempfile.TemporaryDirectory() as td:
            with trace(td):
                for _ in range(calls):
                    run()
            events = traced_events(td)
        counted = launches_since(before)
        seen = traced_port_kernels(events)
        if seen == counted:
            break
    return events, seen, counted, attempt


def trace_contents(events: List[dict]) -> Dict[str, int]:
    """What a trace holds of the device: its device events (``_device_events``)
    and the host's kernel launch records (the CUDA runtime's ``*Launch*``
    calls), so that a trace whose device events were lost shows the
    launches that it should have."""
    launches = sum(1 for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cuda_runtime"
                   and "Launch" in str(e.get("name", "")))
    return {"device_events": sum(1 for _ in _device_events(events)),
            "launch_records": launches}


def call_latency(run, sync, runs: int, pipeline_k: int = 0
                 ) -> Dict[str, float]:
    """Host milliseconds of calls of ``run``: one warm-up call, then
    ``runs`` calls each ended by ``sync()`` (``p50_ms`` / ``min_ms`` /
    ``mean_ms``) and, with ``pipeline_k``, that many calls issued back to
    back and one ``sync()`` (``pipelined_per_call_ms``)."""
    run()
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        run()
        sync()
        times.append((time.perf_counter() - t0) * 1000)
    times.sort()
    out = {"p50_ms": times[len(times) // 2], "min_ms": times[0],
           "mean_ms": sum(times) / len(times)}
    if pipeline_k:
        t0 = time.perf_counter()
        for _ in range(pipeline_k):
            run()
        sync()
        out["pipelined_per_call_ms"] = (
            (time.perf_counter() - t0) * 1000 / pipeline_k)
    return out


def device_busy_ms(events: List[dict]) -> Tuple[Optional[float], str]:
    """``(ms, note)``: the busiest device lane's summed event time (a GPU
    stream's kernels, copies and sets run one after another on it, so the
    sum is its busy time), or None where the trace has no device lane."""
    lanes = device_lane_ms(events)
    if not lanes:
        return None, "no device lane events in trace"
    key = max(lanes, key=lanes.get)
    return lanes[key], (f"device lane {key!r}; all lanes ms: "
                        + json.dumps(dict(sorted(lanes.items(),
                                                 key=lambda kv: -kv[1])[:6])))


def op_breakdown(events: List[dict], top_k: Optional[int] = 25
                 ) -> Dict[str, object]:
    """The device's kernels, copies and sets by category
    (``kernel_category``).

    Returns ``{"categories": {cat: ms}, "top_ops": [{name, ms, count},
    ...], "total_ms": float}`` over the whole trace (``top_k`` None: every
    op); divide by the number of traced calls for per-call numbers."""
    cats: Dict[str, float] = {}
    per_op: Dict[str, List[float]] = {}
    total = 0.0
    for e, _ in _device_events(events):
        ms = float(e["dur"]) / 1e3
        name = str(e.get("name", ""))
        cat = kernel_category(name)
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
