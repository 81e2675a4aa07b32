"""The readings that the limits (``limits/<cell>.json``) are set from, at the
cell's own size on the card, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 2 --out <cell>.jsonl

For each seed, a run of the cell with a short window: the system's
readings, every candidate number of ``check.py``. Beside them, each judged
by ``check.judge`` against the cell's limits (``correct``), what the
faults a cell can have read, planted in the reference put in the system's
place. A train cell: the step that leaves half of the batch out (the
reference on the first half, the loss scaled to the whole), on every seed;
on each control seed besides the lower-precision control (the reference
with every convolution's input, weight and output rounded to fp8,
``reference/lowp.py``), the same rounded to bfloat16 (the witness that the
system's own gaps are bfloat16's), the step with every ReLU and LeakyReLU
made the identity, and the state left unchanged. A serve cell, on each
control seed: the control and the witness; the answer left empty; the
candidates above the threshold served without NMS; NMS at a confidence
threshold of 0.3; the cut taking the first candidates in place of the most
confident (where there are more than it keeps); each box given the next
class and moved by 0.3 of the image; the first half of the batch answered
twice; and the identity activations. One JSON line a seed on standard
output and in ``--out``.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import check, run  # noqa: E402
from portbench.reference import lowp, nms  # noqa: E402
from portbench.reference import model as reference_model  # noqa: E402
from portbench.reference import steps as reference  # noqa: E402


class IdentityActivations:
    """``torch.nn.functional`` with ReLU and LeakyReLU the identity."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def relu(x, inplace=False):
        return x

    @staticmethod
    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return x


@contextlib.contextmanager
def linear_activations():
    """The reference's activations the identity inside."""
    before = reference_model.F
    reference_model.F = IdentityActivations()
    try:
        yield
    finally:
        reference_model.F = before


def _worst_leaves(prog, ref):
    """The leaves that give the worst gaps of the first gradient and of
    the change, with the reference's norms."""
    moving = check.moving_leaves(ref["grad"])
    out = {}
    for key in ("grad", "change"):
        m = statistics.median(ref[key][k] for k in moving)
        worst = max(moving, key=lambda k: abs(prog[key][k] - ref[key][k])
                    / max(ref[key][k], m))
        out[key] = [worst, prog[key][worst], ref[key][worst], m]
    return out


def _judged(readings, limits):
    checked = check.judge(readings, limits)
    return dict(readings, correct=all(c["ok"] for c in checked.values()))


def _train(cell, control: bool):
    """The readings, and each leaf's first-gradient norm of the reference,
    the system and each fault (``leaves``), from which another statistic
    over the leaves can be read again."""
    c, cfg, limits = cell.compared, cell.config, cell.limits
    leaves = {"reference": c["ref"]["grad"], "program": c["prog"]["grad"]}

    def faulty(name, **kw):
        run_ = reference.train(cfg, c["weights"], c["rows"], cell.seed, **kw)
        leaves[name] = run_["grad"]
        return _judged(check.train_readings(run_, c["ref"]), limits)

    out = {"program": _judged(check.train_readings(c["prog"], c["ref"]),
                              limits),
           "worst_leaves": _worst_leaves(c["prog"], c["ref"]),
           "half_batch": faulty("half_batch", rows=slice(
               0, c["rows"][0][0].shape[0] // 2))}
    if control:
        out["control"] = faulty("control", lowp=lowp.fp8)
        out["bf16_witness"] = faulty("bf16_witness", lowp=lowp.bf16)
        with linear_activations():
            out["linear_activations"] = faulty("linear_activations")
        ref = c["ref"]
        still = {"loss": [ref["loss"][0]] * len(ref["loss"]),
                 "grad": {k: 0.0 for k in ref["grad"]},
                 "change": {k: 0.0 for k in ref["change"]}}
        out["unchanged"] = _judged(check.train_readings(still, ref), limits)
    out["leaves"] = leaves
    return out


def _answers(refs, e, k, c):
    """The faults' answers, made from the reference's own calls: name ->
    one ``(rows, valid)`` a call."""
    def no_nms(r):
        rows = nms.top_k(r["decoded"], k)
        return rows, rows[..., 1] > e["conf_threshold"]

    def low_threshold(r):
        return nms.nms(nms.top_k(r["decoded"], k), e["iou_threshold"], 0.3)

    def first_k(r):
        return nms.nms(r["decoded"][:, :k], e["iou_threshold"],
                       e["conf_threshold"])

    def altered(r):
        rows = r["rows"].clone()
        rows[..., 0] = (rows[..., 0] + 1) % c
        rows[..., 2] = (rows[..., 2] + 0.3) % 1.0
        return rows, r["valid"]

    def half_twice(r):
        h = r["rows"].shape[0] // 2
        return (torch.cat([r["rows"][:h], r["rows"][:h]]),
                torch.cat([r["valid"][:h], r["valid"][:h]]))

    faults = {"empty": lambda r: (r["rows"],
                                  torch.zeros_like(r["valid"])),
              "no_nms": no_nms, "low_threshold": low_threshold,
              "altered": altered, "half_twice": half_twice}
    if k and refs[0]["decoded"].shape[1] > k:
        faults["first_k"] = first_k
    return {name: [f(r) for r in refs] for name, f in faults.items()}


def _serve(cell, control: bool):
    c, cfg, limits = cell.compared, cell.config, cell.limits
    e = cfg["eval"]
    dev = cell.device
    refs = list(reference.serve(cfg, c["weights"], c["batches"]))

    def judged(answers):
        calls = ({"rows": rows.to(dev), "valid": valid.to(dev), "ref": r}
                 for (rows, valid), r in zip(answers, refs))
        return _judged(check.serve_readings(calls, e), limits)

    def by_reference(**kw):
        return [(r["rows"], r["valid"])
                for r in reference.serve(cfg, c["weights"], c["batches"],
                                         **kw)]

    out = {"program": judged(c["served"])}
    if control:
        out["control"] = judged(by_reference(lowp=lowp.fp8))
        out["bf16_witness"] = judged(by_reference(lowp=lowp.bf16))
        with linear_activations():
            out["linear_activations"] = judged(by_reference())
        for name, answers in _answers(refs, e, e["max_candidates"],
                                      cfg["grid"]["num_classes"]).items():
            out[name] = judged(answers)
    return out


def readings(cell, control: bool):
    if cell.traffic["kind"] == "train":
        return _train(cell, control)
    return _serve(cell, control)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program = run.load_program()
    bench = run.benchmark()
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds + sorted(controls - set(seeds)):
            t0 = time.perf_counter()
            cell = run.cell_from_files(args.workload, seed, args.seconds,
                                       False, "cuda:0", program,
                                       time.perf_counter())
            result = run.run_cell(cell, bench)
            line = {"workload": args.workload, "seed": seed,
                    "metrics": result["metrics"],
                    "peak": result["device"]["memory_peak_bytes"]}
            line.update(readings(cell, seed in controls))
            line["seconds"] = time.perf_counter() - t0
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
            del cell, result
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    print(f"calibrate: {time.perf_counter() - START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
