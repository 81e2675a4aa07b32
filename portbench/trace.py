"""The benchmark's reading of a ``torch.profiler`` trace: the device's events
by stream lane, the busiest lane's busy time, kernels grouped by function
name, the system's hand-written kernels found by name and checked against
their wrappers' launch counters, and the idle gaps on the busiest lane,
each named by the benchmark's host span that was open when it began.

The trace is taken in a young process with a margin of host time on both
sides of the traced work: the profiler keeps only the GPU records whose
timestamps, as CUPTI puts them on the host's clock, fall inside its window,
and that conversion drifts further the older the process is. A trace whose
kernels of the system differ from the counters over the same calls has lost
records; it is taken again, up to three times, and where it still differs
the per-layer metrics that read it are left out.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARGIN_S = 0.05
TRIES = 3

# the system's hand-written kernels: wrapper module and launch counter
PORT_KERNELS = {"nms": ("cuda_nms", "LAUNCHES"),
                "bn_stats": ("bn", "STATS_LAUNCHES"),
                "bn_grad_stats": ("bn", "GRAD_STATS_LAUNCHES"),
                "yolo_loss_forward": ("yolo_loss", "FORWARD_LAUNCHES"),
                "yolo_loss_backward": ("yolo_loss", "BACKWARD_LAUNCHES")}
PACKAGE = "keras_object_detection_torch"


def kernel_category(name: str) -> str:
    """A kernel's function name from its demangled signature (``void
    ns::(anonymous namespace)::bn_stats_kernel<float, 8>(...)`` ->
    ``bn_stats_kernel``); a name without one up to its first ``<`` or
    ``(`` ("Memcpy HtoD (Pinned -> Device)" -> "Memcpy HtoD")."""
    head = name.strip().replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head.removeprefix("void "), maxsplit=1)[0]
    return head.split("::")[-1].strip() or "other"


def port_kernel(name: str) -> Optional[str]:
    """Which of ``PORT_KERNELS`` a device event of this name is: K1
    ``nms_kernel``, K2 / K3 ``bn_stats_kernel`` with ``GRAD`` false / true,
    K4 ``loss_forward_kernel``, K5 ``loss_backward_kernel``."""
    cat = kernel_category(name)
    if cat == "bn_stats_kernel":
        return "bn_grad_stats" if ", true," in name else "bn_stats"
    return {"nms_kernel": "nms", "loss_forward_kernel": "yolo_loss_forward",
            "loss_backward_kernel": "yolo_loss_backward"}.get(cat)


def launch_counters() -> Dict[str, int]:
    """The system's launch counters, read by name from its wrappers."""
    return {k: getattr(importlib.import_module(f"{PACKAGE}.ops.{mod}"), attr)
            for k, (mod, attr) in PORT_KERNELS.items()}


@dataclasses.dataclass
class Trace:
    """What a checked trace holds: ``device`` the device events of the
    busiest lane (``(start_us, dur_us, name)``, in time order), ``spans``
    the benchmark's host spans (``(start_us, end_us, name)``),
    ``traced`` / ``counted`` the system's kernels in it and by the
    counters, ``calls`` the traced calls, ``tries`` the traces taken."""

    device: List[Tuple[float, float, str]]
    spans: List[Tuple[float, float, str]]
    traced: Dict[str, int]
    counted: Dict[str, int]
    calls: int
    tries: int

    @property
    def complete(self) -> bool:
        return self.traced == self.counted and bool(self.device)

    @property
    def window_us(self) -> Tuple[float, float]:
        """From the first benchmark span's start to the later of the last
        span's end and the last device event's end: the traced work, not
        the margins."""
        start = min(s[0] for s in self.spans)
        end = max([s[1] for s in self.spans]
                  + [d[0] + d[1] for d in self.device])
        return start, end

    def busy_us(self) -> float:
        """The busiest lane's summed event time inside the window: its
        kernels run one after another, so the sum is its busy time."""
        lo, hi = self.window_us
        return sum(min(s + d, hi) - max(s, lo) for s, d, _ in self.device
                   if s + d > lo and s < hi)

    def by_category(self) -> Dict[str, float]:
        """Device microseconds by kernel function name, most first."""
        out: Dict[str, float] = {}
        for _, dur, name in self.device:
            cat = kernel_category(name)
            out[cat] = out.get(cat, 0.0) + dur
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def port_kernel_us(self, kinds) -> float:
        return sum(d for _, d, n in self.device if port_kernel(n) in kinds)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """``(host span open at the gap's start, microseconds)`` of every
        gap between consecutive events of the busiest lane inside the
        window, and before the first, longest first."""
        lo, hi = self.window_us
        gaps, prev = [], lo
        for s, d, _ in self.device:
            if s > prev:
                gaps.append((prev, s - prev))
            prev = max(prev, s + d)
        if hi > prev:
            gaps.append((prev, hi - prev))
        named = []
        for at, dur in gaps:
            open_ = [n for s, e, n in self.spans if s <= at < e]
            named.append((open_[-1] if open_ else "host.other", dur))
        return sorted(named, key=lambda g: -g[1])


def _events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def _lanes(events: List[dict], span_prefixes: Tuple[str, ...]):
    """Device events by lane, and the benchmark's spans."""
    lanes: Dict[Tuple, List] = {}
    spans = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATEGORIES and e["dur"] > 0:
            lanes.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), float(e["dur"]), str(e.get("name", ""))))
        elif (e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(span_prefixes)):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          str(e["name"])))
    return lanes, sorted(spans)


def take(run: Callable[[], None], calls: int,
         span_prefixes: Tuple[str, ...]) -> Trace:
    """A trace of ``calls`` calls of ``run`` (which opens the benchmark's
    spans with ``torch.profiler.record_function``), with ``MARGIN_S`` of
    host time on both sides, taken again where the system's kernels in it
    differ from the counters."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRIES + 1):
        before = launch_counters()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as td:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(MARGIN_S)
                for _ in range(calls):
                    run()
                torch.cuda.synchronize()
                time.sleep(MARGIN_S)
            path = os.path.join(td, "trace.json")
            prof.export_chrome_trace(path)
            events = _events(path)
        after = launch_counters()
        counted = {k: after[k] - before[k] for k in after}
        lanes, spans = _lanes(events, span_prefixes)
        traced = dict.fromkeys(PORT_KERNELS, 0)
        for lane in lanes.values():
            for _, _, name in lane:
                kind = port_kernel(name)
                if kind is not None:
                    traced[kind] += 1
        busiest = (max(lanes.values(), key=lambda lane: sum(d for _, d, _ in lane))
                   if lanes else [])
        out = Trace(sorted(busiest), spans, traced, counted, calls, attempt)
        if out.complete and spans:
            break
    return out
