"""Tiny CPU versions of the cells, for the tests: the configuration files
cut to a size a CPU test holds (YOLOv1 on the ``darknet_micro`` table at
56x56, YOLOv3 at full width at 64x64), the traffic cut to a few images."""

from __future__ import annotations

import copy
import time

from portbench import run
from portbench.cell import Cell

TINY = {
    "yolov1-darknet24-448": {"model": {"backbone": "darknet_micro",
                                       "image_size": 56}},
    "yolov3-darknet53-416": {"model": {"image_size": 64}, "grid": {"grid": 2}},
}
TRAFFIC = {"train_dispatch": {"batch": 4, "dataset": 24},
           "serve_closed": {"batch": 4, "pool": 8}}
# at 64x64 YOLOv3's 252 candidates pass the threshold only with a larger
# gain; YOLOv1 on the micro table keeps one or two boxes a call out of
# rounding's reach at its own gain, and some 60 at 1.0, more than the
# served-set check's limit, so that a single call shows an empty answer
WEIGHTS = {"yolov3-darknet53-416": {"head_gain": 2.0},
           "yolov1-darknet24-448": {"head_gain": 1.0}}


def _merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def cell(workload: str, seed: int = 7, seconds: float = 0.5,
         program=None, limits=None, over=None, device="cpu",
         tracing: bool = False) -> Cell:
    """The cell ``workload`` at a tiny size on the CPU; ``over`` changes
    the configuration further."""
    bench = run.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config_file = run._json(run.ROOT / conf["file"])
    config_file = dict(
        config_file,
        config=_merged(_merged(config_file["config"], TINY[entry["config"]]),
                       over or {}),
        weights=_merged(config_file["weights"],
                        WEIGHTS.get(entry["config"], {})))
    traffic = _merged(run._json(run.HERE / "traffic"
                                / f"{entry['traffic']}.json"),
                      TRAFFIC[entry["traffic"]])
    if limits is None:
        limits = run._json(run.HERE / "limits" / f"{workload}.json")
    program = program or run.load_program()
    return Cell(workload, config_file, traffic, limits, seed, seconds,
                tracing, device, program, time.perf_counter())


def result(workload: str, **kw) -> dict:
    c = cell(workload, **kw)
    return run.run_cell(c, run.benchmark())

