"""The collectives of a train step under data parallelism and under data x
tensor parallelism (counterpart of the repository's
``tools/tp_comm_analysis.py``, which measures the JAX package).

JAX's tool compiles the flagship step ahead of time over 8 fake CPU
devices and reads every collective out of the optimised HLO. Eager PyTorch
compiles no program, so this runs each of JAX's layouts instead (``8x1``,
pure data parallelism, and ``4x2``, data x tensor parallelism) as one
process group of dp x tp local ranks
(``parallel/distributed.py`` ``launch_local``; gloo where ranks share a
card or on the CPU), each rank on its row block of the global batch
(``--batch``, default 32, at ``--image-size``, default 448), its state
placed on the model axis (``parallel/tensor.py`` ``shard_state``). After a
warm-up step the collective counters are reset and one step is counted.

The record is JAX's: ``configs.{dp8,dp4_tp2}`` with ``mesh``,
``tp_sharded_leaves`` (the leaves of the parameters and optimizer moments
that ``state_sharding``'s rule names the model axis for: JAX counts them at
model 1 too, where its placement spans one position), ``collectives.{kind}
.{count, bytes}``, ``total_collective_bytes_per_device`` and
``total_collective_ops``, then ``delta``. Bytes are on JAX's basis: the
result each rank holds (an all-reduce's equals what it contributes, an
all-gather's is the gathered tensor). Each config adds ``all_reduce_sizes``
/ ``all_gather_sizes`` (result bytes -> count), ``ranks_agree`` (every rank
issued the same collectives), ``counted_step_ms`` (rank 0) and the raw
counters (``distributed.ALL_REDUCES`` ...).

Usage:
  python -m keras_object_detection_torch.cli.tp_comm_analysis --out tp.json

``analyse(cfg, layouts, device, min_elements, source)`` runs any config at
any layouts and sharding threshold (the tests' tiny model at 2x1 and 1x2).

Runs on ``--device`` (default cuda); writes the record only where ``--out``
names a file.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import tempfile
import time
from typing import List


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=32,
                   help="global batch (the JAX record's: 32)")
    p.add_argument("--image-size", type=int, default=None,
                   help="image size (default: the config's; the flagship's "
                        "448)")
    p.add_argument("--out", default=None,
                   help="output JSON (default: print only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for gloo ranks on "
                        "the CPU)")
    p.add_argument("--rank-job", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


LAYOUTS = [(8, 1), (4, 2)]  # JAX's record's dp8 and dp4_tp2


def layout_name(dp: int, tp: int) -> str:
    """JAX's record's name of a layout: ``dp8``, ``dp4_tp2``."""
    return f"dp{dp}" + (f"_tp{tp}" if tp > 1 else "")


def rule_leaves(state, tp: int, min_elements: int) -> int:
    """The leaves of the state's parameters and optimizer moments that
    ``state_sharding``'s rule names the model axis for, on a model axis of
    ``tp`` positions (at ``tp`` 1 too, as JAX counts them)."""
    from keras_object_detection_torch.parallel.dryrun import state_tree
    from keras_object_detection_torch.parallel.mesh import column_shardable

    return sum(column_shardable(x, tp, min_elements)
               for sub in state_tree(state).values() for x in sub.values())


def summarize(record: list) -> dict:
    """A rank's recorded collectives (``distributed.recording``) on JAX's
    basis: per kind the count and the result bytes, and the result sizes."""
    kinds: dict = {}
    sizes = {"all-reduce": collections.Counter(),
             "all-gather": collections.Counter()}
    for kind, nbytes, world in record:
        result = nbytes * world if kind == "all-gather" else nbytes
        s = kinds.setdefault(kind, {"count": 0, "bytes": 0})
        s["count"] += 1
        s["bytes"] += result
        sizes.setdefault(kind, collections.Counter())[result] += 1
    return {"collectives": kinds,
            "sizes": {k: {str(b): n for b, n in sorted(c.items())}
                      for k, c in sizes.items()}}


def run_layout(cfg, dp: int, tp: int, min_elements: int, device) -> dict:
    """This rank's part of one layout: a warm-up step, then one counted
    step with its collectives recorded."""
    import numpy as np
    import torch

    from keras_object_detection_torch.cli.train_step_breakdown import \
        synthetic_batch
    from keras_object_detection_torch.parallel import (batch_sharding,
                                                       create_mesh,
                                                       distributed, tensor)
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    mesh = create_mesh(dp, tp)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device)
    leaves = rule_leaves(state, tp, min_elements)
    tensor.shard_state(state, mesh, min_elements)
    local = batch_sharding(mesh)
    batch = [local(x) for x in synthetic_batch(cfg, device)]
    step = make_train_step(cfg, group=mesh.data_group)
    state, metrics = step(state, *batch, 1)
    float(metrics["total"])
    distributed.barrier(mesh.group)
    distributed.reset_counts()
    with distributed.recording() as record:
        t0 = time.perf_counter()
        state, metrics = step(state, *batch, 1)
        loss = float(metrics["total"])
        ms = (time.perf_counter() - t0) * 1000
    if not np.isfinite(loss):
        raise RuntimeError(f"dp{dp} x tp{tp}: non-finite loss {loss}")
    counters = {k: getattr(distributed, k) for k in (
        "ALL_REDUCES", "ALL_REDUCE_BYTES", "GATHERS", "GATHER_BYTES")}
    return {"rank": torch.distributed.get_rank(), "data_index": mesh.index,
            "model_index": mesh.model_index, "tp_sharded_leaves": leaves,
            "counted_step_ms": ms, "loss": loss, "counters": counters,
            **summarize(record)}


def run_rank(job_path: str) -> None:
    """One rank: joins the group the environment describes, runs each
    layout of the job and writes its results beside the job."""
    import torch

    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.parallel import distributed

    with open(job_path) as f:
        job = json.load(f)
    cfg = Config.from_json(job["config"])
    if job["device"] == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    world = int(os.environ["WORLD_SIZE"])
    distributed.maybe_initialize(backend="gloo" if device.type == "cpu" or
                                 world > torch.cuda.device_count() else None)
    out = {}
    for dp, tp in job["layouts"]:
        out[layout_name(dp, tp)] = run_layout(cfg, dp, tp,
                                              job["min_elements"], device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    rank = torch.distributed.get_rank()
    with open(os.path.join(os.path.dirname(job_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.barrier(torch.distributed.group.WORLD)
    torch.distributed.destroy_process_group()


def merge(ranks: List[dict], dp: int, tp: int) -> dict:
    """One layout's config of the record from its ranks' results: rank 0's
    collectives, checked equal within each data row (the ranks of one data
    index)."""
    rows: dict = {}
    for r in ranks:
        rows.setdefault(r["data_index"], []).append(r)
    for members in rows.values():
        first = members[0]
        for r in members[1:]:
            if (r["collectives"], r["sizes"]) != (first["collectives"],
                                                   first["sizes"]):
                raise RuntimeError(
                    f"{layout_name(dp, tp)}: ranks {first['rank']} and "
                    f"{r['rank']} of data row {r['data_index']} issued "
                    "different collectives")
    r0 = min(ranks, key=lambda r: r["rank"])
    stats = r0["collectives"]
    return {
        "mesh": {"data": dp, "model": tp},
        "tp_sharded_leaves": r0["tp_sharded_leaves"],
        "collectives": stats,
        "total_collective_bytes_per_device": sum(
            v["bytes"] for v in stats.values()),
        "total_collective_ops": sum(v["count"] for v in stats.values()),
        "all_reduce_sizes": r0["sizes"].get("all-reduce", {}),
        "all_gather_sizes": r0["sizes"].get("all-gather", {}),
        "ranks_agree": all((r["collectives"], r["sizes"]) ==
                           (r0["collectives"], r0["sizes"]) for r in ranks),
        "counted_step_ms": r0["counted_step_ms"],
        "counters": r0["counters"],
    }


def analyse(cfg, layouts, device: str, min_elements: int, src: str) -> dict:
    """Run each layout (one launch of ranks per world size) and build the
    record."""
    from keras_object_detection_torch.parallel import distributed

    by_world: dict = {}
    for dp, tp in layouts:
        by_world.setdefault(dp * tp, []).append((dp, tp))
    configs = {}
    for world, group in by_world.items():
        with tempfile.TemporaryDirectory() as td:
            job = os.path.join(td, "job.json")
            with open(job, "w") as f:
                json.dump({"config": cfg.to_json(), "layouts": group,
                           "device": device,
                           "min_elements": min_elements}, f)
            rc = distributed.launch_local(
                "keras_object_detection_torch.cli.tp_comm_analysis",
                ["--rank-job", job], world)
            if rc:
                raise RuntimeError(f"a rank of the {world}-rank group exited "
                                   f"with {rc}")
            ranks = []
            for r in range(world):
                with open(os.path.join(td, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        for dp, tp in group:
            name = layout_name(dp, tp)
            configs[name] = merge([r[name] for r in ranks], dp, tp)
            print(name, json.dumps(configs[name]), flush=True)
    names = [layout_name(dp, tp) for dp, tp in layouts]
    first, last = (configs[n]["total_collective_bytes_per_device"]
                   for n in (names[0], names[-1]))
    size = cfg.model.image_size
    return {
        "what": ("per-rank collective payload bytes per train step, counted "
                 f"while the step runs ({cfg.model.backbone} {size}^2 "
                 f"{cfg.model.compute_dtype}, global batch "
                 f"{cfg.data.batch_size}; {src}) as one process group of "
                 f"dp x tp ranks on {device}"),
        "why": ("the port's collectives are torch.distributed calls issued "
                "eagerly, so they are counted as a step issues them; ranks "
                "sharing one card talk over gloo, through the host, so the "
                "counts and bytes hold and no time here says anything of "
                "NVLink"),
        "configs": configs,
        "delta": {
            "extra_bytes_per_device_per_step": last - first,
            "ratio_tp_over_dp": (last / first) if first else None,
        },
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.rank_job:
        run_rank(args.rank_job)
        return {}

    from keras_object_detection_torch.cli.train_step_breakdown import write
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.parallel.mesh import TP_MIN_ELEMENTS
    from keras_object_detection_torch.train.loop import _device

    device = _device(args.device, "the analysis")
    cfg = voc_full_config()
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=args.batch),
        model=dataclasses.replace(
            cfg.model, image_size=args.image_size or cfg.model.image_size))
    doc = analyse(cfg, LAYOUTS, device.type, TP_MIN_ELEMENTS,
                  "preset voc_full")
    write(doc, args.out)
    return doc


if __name__ == "__main__":
    main()
