#!/usr/bin/env python3
"""Device time of a torch.profiler Chrome trace, by the outermost CPU op
that launched each kernel (for example ``FusedBNTrain``,
``autograd::engine::evaluate_function: ConvolutionBackward0``,
``aten::conv2d``), and the busy share of the traced window.

    python tools/torch_trace_summary.py TRACE.json[.gz] [--steps N] [--top K]

``--steps`` divides every time by the number of steps the trace covers.
A kernel is attributed through its ``External id`` to the CPU op that
launched it, then to the outermost CPU op enclosing that one on the same
thread; kernels launched outside any op (the port's ctypes kernels are
launched inside their autograd Function's op) count under their own name.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json


def load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def outermost_ops(events: list) -> dict:
    """External id -> the name of the outermost CPU op around the op that
    carries it (same thread, by time containment)."""
    by_tid = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e:
            by_tid[e["tid"]].append(e)
    result = {}
    for ops in by_tid.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        tops = []  # outermost ops: disjoint intervals in time order
        for e in ops:
            if not tops or e["ts"] >= tops[-1]["ts"] + tops[-1]["dur"]:
                tops.append(e)
        starts = [t["ts"] for t in tops]
        for e in ops:
            ext = e.get("args", {}).get("External id")
            if ext is None:
                continue
            i = bisect.bisect_right(starts, e["ts"]) - 1
            result[ext] = tops[i]["name"] if i >= 0 else e["name"]
    return result


def summarize(events: list) -> tuple:
    owner = outermost_ops(events)
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset")]
    totals = collections.Counter()
    for k in kernels:
        ext = k.get("args", {}).get("External id")
        totals[owner.get(ext, k["name"])] += k["dur"]
    busy = sum(totals.values())
    start = min(k["ts"] for k in kernels)
    end = max(k["ts"] + k["dur"] for k in kernels)
    return totals, busy, end - start


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    totals, busy, window = summarize(load(args.trace))
    n = args.steps
    print(f"device busy {busy / 1e3 / n:.3f} ms per step of a "
          f"{window / 1e3 / n:.3f} ms window (first kernel start to last "
          f"kernel end): idle share {1 - busy / window:.3f}")
    for name, us in totals.most_common(args.top):
        print(f"{us / 1e3 / n:10.3f} ms  {100 * us / busy:5.1f} %  {name}")


if __name__ == "__main__":
    main()
