#!/usr/bin/env python3
"""Where the NMS kernel's time goes, phase by phase, on one NVIDIA GPU.

    python3 tools/nms_phase_split.py                 # this tree's nms.cu
    python3 tools/nms_phase_split.py OTHER/nms.cu keras_object_detection_torch/ops/csrc/nms.cu

For each source the script writes an instrumented copy under ``build/``
(never into the package): thread 0 of every block stamps ``clock64()`` and
``%globaltimer`` at ``nms_kernel``'s start, after each of its barriers
(``__syncthreads();`` or ``image_sync<...>();``) and at its end, into a
device array that the host reads back. A phase is named by the source line
of the barrier that ends it. Where the source holds the greedy scan's choice
between its two ways of folding a word's survivors into the later words
(``SCAN_CHOICE``), two more copies take one way each.

Each copy is built with the package's nvcc flags, checked bit-equal to the
plain NMS, and launched on ``chip_smoke.nms_rows`` at each of SHAPES. The
script prints each copy's device time under CUDA-graph replay (the stamps included), then
each phase's cycles (median over launches of the mean over the blocks that
reach it) and its share, with microseconds from the run's own ratio of
globaltimer nanoseconds to cycles.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import pathlib
import re
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = ((1, 49), (32, 49), (8, 128), (4, 196), (4, 256), (4, 384), (4, 448),
          (8, 512), (2, 1024))
LAUNCHES = 20
MAX_BLOCKS, MAX_STAMPS = 4096, 32
BARRIER = re.compile(r"(__syncthreads\(\)|image_sync<\w+>\(\));")
SCAN_CHOICE = "or_fold = words <= 14"
SCAN_WAYS = {"OR reduction only": "or_fold = true",
             "survivor list only": "or_fold = false"}

STAMP_PRELUDE = f"""
#include <cuda_runtime.h>
#include <stdint.h>
#define KOT_STAMP_BLOCKS {MAX_BLOCKS}
#define KOT_STAMPS {MAX_STAMPS}
__device__ unsigned long long kot_stamps[KOT_STAMP_BLOCKS][KOT_STAMPS][2];
__device__ __forceinline__ void kot_stamp(int k) {{
    if (threadIdx.x == 0 && blockIdx.x < KOT_STAMP_BLOCKS && k < KOT_STAMPS) {{
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        kot_stamps[blockIdx.x][k][0] = clock64();
        kot_stamps[blockIdx.x][k][1] = t;
    }}
}}
"""

STAMP_EPILOGUE = """
extern "C" int kot_nms_clear_stamps(void) {
    static unsigned long long zeros[KOT_STAMP_BLOCKS][KOT_STAMPS][2];
    return (int)cudaMemcpyToSymbol(kot_stamps, zeros, sizeof(zeros));
}
extern "C" int kot_nms_read_stamps(void* dst) {
    return (int)cudaMemcpyFromSymbol(dst, kot_stamps, sizeof(kot_stamps));
}
"""


def instrument(src: str) -> tuple:
    """The instrumented source and the phases' names: the line of each
    barrier that ends one, then "end"."""
    head = re.search(r"nms_kernel\s*\(", src)
    if head is None:
        raise SystemExit("no nms_kernel in the source")
    start = src.index("{", head.end()) + 1
    depth, end = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    end -= 1  # the body's closing brace
    names = []

    def stamp(m):
        names.append(f"to line {src.count(chr(10), 0, start + m.start()) + 1}")
        return f"{m.group(0)} kot_stamp({len(names)});"

    body = BARRIER.sub(stamp, src[start:end])
    names.append("end")
    body = f" kot_stamp(0);{body} __syncthreads(); kot_stamp({len(names)});\n"
    return STAMP_PRELUDE + src[:start] + body + src[end:] + STAMP_EPILOGUE, names


def split(lib, x: torch.Tensor, n_stamps: int) -> tuple:
    """Median over LAUNCHES of each phase's mean cycles over the blocks that
    reach its end (from the block's last stamp before it), the number of
    blocks, and nanoseconds per cycle."""
    b, n, _ = x.shape
    rows = torch.empty_like(x)
    valid = torch.empty((b, n), dtype=torch.bool, device=x.device)
    buf = np.zeros((MAX_BLOCKS, MAX_STAMPS, 2), np.uint64)
    per_launch, ratios = [], []
    for _ in range(LAUNCHES):
        torch.cuda.synchronize()
        lib.kot_nms_clear_stamps()
        launch(lib, x, rows, valid)
        torch.cuda.synchronize()
        lib.kot_nms_read_stamps(buf.ctypes.data)
        cyc = buf[..., 0].astype(np.int64)[:, :n_stamps]
        ns = buf[..., 1].astype(np.int64)[:, :n_stamps]
        used = cyc[:, 0] != 0
        cyc, ns = cyc[used], ns[used]
        sums, counts = np.zeros(n_stamps), np.zeros(n_stamps)
        for c in cyc:
            last = 0
            for k in np.flatnonzero(c)[1:]:
                sums[k] += c[k] - c[last]
                counts[k] += 1
                last = k
        per_launch.append(np.where(counts > 0, sums / np.maximum(counts, 1), 0)[1:])
        last = np.where(cyc != 0, np.arange(n_stamps), 0).max(axis=1)
        pick = np.arange(len(cyc))
        ratios.append((ns[pick, last] - ns[:, 0]).sum() / (cyc[pick, last] - cyc[:, 0]).sum())
    return np.median(per_launch, axis=0), int(used.sum()), float(np.median(ratios))


def launch(lib, x, rows, valid) -> None:
    b, n, _ = x.shape
    err = lib.kot_nms(x.data_ptr(), rows.data_ptr(), valid.data_ptr(), b, n, 0.5,
                      0.4, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("nms_phase_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_ms, nms_rows
    from keras_object_detection_torch.ops import _build
    from keras_object_detection_torch.ops.nms import batched_non_max_suppression

    sources = sys.argv[1:] or [str(ROOT / "keras_object_detection_torch" / "ops"
                                   / "csrc" / "nms.cu")]
    copies = []  # (label, instrumented text, phase names)
    for source in sources:
        src = pathlib.Path(source).read_text()
        ways = {"as written": src}
        if SCAN_CHOICE in src:
            ways.update({way: src.replace(SCAN_CHOICE, cond)
                         for way, cond in SCAN_WAYS.items()})
        for way, text in ways.items():
            copies.append((f"{source} ({way})", *instrument(text)))

    def build(text: str):
        work = ROOT / "build" / "phase_split" / hashlib.sha256(text.encode()).hexdigest()[:12]
        work.mkdir(parents=True, exist_ok=True)
        (work / "nms.cu").write_text(text)
        return _build.build("nms", work)

    with concurrent.futures.ThreadPoolExecutor(len(copies)) as pool:
        built = list(pool.map(lambda c: build(c[1]), copies))
    dev = torch.device("cuda", 0)
    print(f"[phase] {torch.cuda.get_device_name(0)}")
    for (label, _, names), (lib_path, seconds, out) in zip(copies, built):
        print(f"[phase] {label}: built {lib_path.name} in {seconds:.2f} s")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[phase] {line.strip()}")
        lib = ctypes.CDLL(str(lib_path))
        lib.kot_nms.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                ctypes.c_float, ctypes.c_void_p]
        lib.kot_nms_read_stamps.argtypes = [ctypes.c_void_p]
        for b, n in SHAPES:
            x = torch.from_numpy(nms_rows(300, b, n)).to(dev)
            rows = torch.empty_like(x)
            valid = torch.empty((b, n), dtype=torch.bool, device=dev)
            launch(lib, x, rows, valid)
            want_rows, want_valid = batched_non_max_suppression(x, 0.5, 0.4)
            if not (torch.equal(rows, want_rows) and torch.equal(valid, want_valid)):
                raise SystemExit(f"{label} disagrees with the plain NMS at {b}x{n}")
            device_ms = graph_ms(lambda: launch(lib, x, rows, valid))
            cycles, blocks, ns_per_cycle = split(lib, x, len(names) + 1)
            total = cycles.sum()
            print(f"[phase] {label} {b}x{n}: bit-equal to the plain NMS; "
                  f"{device_ms:.5f} ms on the device (graph replay); {blocks} "
                  f"blocks, per block {total:.0f} cycles = "
                  f"{total * ns_per_cycle / 1e3:.3f} us "
                  f"({1 / ns_per_cycle:.3f} GHz from globaltimer)")
            for name, c in zip(names, cycles):
                print(f"[phase] {b}x{n} {name:>9}: {c:9.0f} cycles "
                      f"{c * ns_per_cycle / 1e3:8.3f} us {100 * c / total:5.1f} %")
    return 0


if __name__ == "__main__":
    sys.exit(main())
