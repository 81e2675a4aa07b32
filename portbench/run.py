"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the system's ``Config`` as run, with its source
and weights), a traffic mix (``traffic/<mix>.json``, whose ``kind`` names
the runner, ``train.py`` or ``serve.py``) and its limits
(``limits/<cell>.json``). With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` a trace of a few steps or calls is
taken right after warm-up, while the process is young, and the result holds
the per-layer metrics (``metrics/<metric>.py``, each a ``read(ctx)``).
Either way the window then runs for ``--seconds``, and what it produced is
compared with the plain reference (``check.py``).

The last line of standard output is the result's JSON; the numbers compared
are the last lines of standard error. Without a GPU, with fewer GPUs than
the cell asks for, or where a module of JAX or of the JAX package is
loaded once the window has closed, the run prints no result and exits 2, 2
and 3.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from portbench.cell import Cell, Outcome  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "keras_object_detection_tpu")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_program() -> types.SimpleNamespace:
    """The system under test: the entry points the runners call."""
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.train.loop import (create_train_state,
                                                         make_train_step,
                                                         stage_chunk)

    return types.SimpleNamespace(
        Config=Config, InferenceModel=InferenceModel,
        create_train_state=create_train_state,
        make_train_step=make_train_step, stage_chunk=stage_chunk)


def _reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, bench: dict) -> Dict:
    """Drive ``cell`` and assemble its result line (without printing)."""
    from portbench import check

    kind = cell.traffic["kind"]
    runner = importlib.import_module(f"portbench.{kind}")
    out: Outcome = runner.run(cell)
    checked = check.judge(out.readings, cell.limits)
    ok = all(c["ok"] for c in checked.values()) and out.failed == 0
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": out.memory_peak}
    metrics: Dict[str, Dict] = {}
    result = {"correct": ok, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if not cell.tracing:
        values = dict(out.end_to_end, setup_s=cell.setup_s)
        for m in bench["end_to_end"]:
            if applies(m, cell.name) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        t = cell.trace
        lo, hi = t.window_us
        device["busy_s"] = t.busy_us() / 1e6
        device["window_s"] = (hi - lo) / 1e6
        device["power_limit_w"] = power_limit_w()
        ctx = types.SimpleNamespace(
            trace=t, window=out.window, config=cell.config, batch=
            cell.traffic["batch"], power_limit_w=device["power_limit_w"])
        reported = {m["name"] for m in bench["end_to_end"]
                    if applies(m, cell.name)}
        for m in bench["per_layer"]:
            if not applies(m, cell.name) or m["moves"] not in reported:
                continue
            value = _reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": [[k, v / 1e6]
                           for k, v in list(t.by_category().items())[:10]],
            "idle_gaps": [[k, v / 1e6] for k, v in t.idle_gaps()[:10]]}
    result["check"] = {k: {"value": c["value"], "limit": c["limit"]}
                       for k, c in checked.items()}
    result["_checked"] = checked
    return result


def cell_from_files(workload: str, seed: int, seconds: float, tracing: bool,
                    device, program, started: float = START) -> Cell:
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(workload, _json(ROOT / config["file"]),
                _json(HERE / "traffic" / f"{entry['traffic']}.json"),
                _json(HERE / "limits" / f"{workload}.json"), seed, seconds,
                tracing, device, program, started)


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def finish(result: Dict) -> int:
    """Print the compared numbers on standard error and the result line on
    standard output, unless JAX was loaded."""
    from portbench import check

    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    check.report(result.pop("_checked"))
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be >= 0")
    build = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    program = load_program()
    bench = benchmark()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    chips = entry["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} GPU(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = cell_from_files(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", program)
    return finish(run_cell(cell, bench))


if __name__ == "__main__":
    sys.exit(main())
