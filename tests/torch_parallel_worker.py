"""One rank of the data-parallel tests (not a test module: the tests start
it with ``parallel.distributed.launch_local``, two gloo ranks on the CPU).

    python -m tests.torch_parallel_worker JOB

``JOB`` is a ``torch.save`` of ``{"kind": "steps" | "fit", "out": dir,
...}``; each rank writes ``<out>/<name>_<rank>.pt``. It imports torch and
the port only, and runs one intra-op thread (several ranks share the
cores)."""

import os
import sys

import torch


def _counts():
    from keras_object_detection_torch.parallel import distributed

    return {"all_reduces": distributed.ALL_REDUCES,
            "gathers": distributed.GATHERS}


def run_steps(job, group, rank, world):
    """Each case: the port's state from the case's weights, ``steps`` train
    steps on this rank's row block of the global batch with the global
    draws; writes the state dict, EMA, metrics and collective counts."""
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    for name, case in job["cases"].items():
        cfg = Config.from_json(case["config"])
        state = create_train_state(cfg, device="cpu")
        state.model.load_state_dict(case["state_dict"])
        if state.ema is not None:
            state.ema = {k: v.detach().clone()
                         for k, v in state.model.named_parameters()}
        step = make_train_step(cfg, group=group)
        images, boxes, valid = case["batch"]
        rows = images.shape[0] // world
        own = slice(rank * rows, (rank + 1) * rows)
        distributed.reset_counts()
        metrics = []
        for draws in case["draws"]:
            state, m = step(state, images[own], boxes[own], valid[own],
                            seed=0, draws=draws)
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"state_dict": state.model.state_dict(),
                    "ema": state.ema, "metrics": metrics,
                    "counts": _counts()},
                   os.path.join(job["out"], f"{name}_{rank}.pt"))


def run_fit(job, group, rank, world):
    """``Trainer.fit`` of the job's config on its train / val directories
    (every rank), the sharded device cache's batches against the
    replicated layout's over two epochs, and the dry run's FPN step."""
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.data.pipeline import DeviceCachedDataset
    from keras_object_detection_torch.parallel import create_mesh
    from keras_object_detection_torch.train import Trainer

    cfg = Config.from_json(job["config"])
    trainer = Trainer(cfg, device="cpu", use_tensorboard=False)
    state = trainer.init_state()
    state.model.load_state_dict(job["state_dict"])
    kw = dict(max_boxes=8)
    state = trainer.fit(YoloDataset(job["train"], 56, 4, shuffle=True, seed=0,
                                    **kw),
                        YoloDataset(job["train"], 56, 4, **kw),
                        state=state, verbose=False, **job.get("fit", {}))
    test = trainer.evaluate(state, YoloDataset(job["train"], 56, 4, **kw))
    trainer.close()
    # the sharded cache: rank r's gathered block of every batch of two
    # epochs equals the replicated layout's
    mesh = create_mesh()
    same = []
    for layout in ("replicated", "sharded"):
        ds = YoloDataset(job["train"], 56, 4, shuffle=True, seed=3, **kw)
        cache = DeviceCachedDataset(ds, "cpu", layout, mesh)
        same.append([tuple(t.clone() for t in batch)
                     for _ in range(2) for batch in cache.epoch()])
    equal = all(torch.equal(a, b) for x, y in zip(*same) for a, b in zip(x, y))
    # the dry run's FPN step (parallel/dryrun.py) in this group
    from keras_object_detection_torch.parallel import dryrun

    dry = dryrun._sharded_step(dryrun.fpn_config(1), "fpn 2-scale "
                               "darknet_micro@56", torch.device("cpu"), group)
    torch.save({"state_dict": state.model.state_dict(), "test": test,
                "cache_equal": equal and len(same[0]) == len(same[1]) > 0,
                "cache_rows": cache.images.shape[0],
                "cache_batches": len(same[0]), "dryrun_fpn_loss": dry},
               os.path.join(job["out"], f"fit_{rank}.pt"))


def main(path):
    from keras_object_detection_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.maybe_initialize(backend="gloo")
    group = torch.distributed.group.WORLD
    rank, world = distributed.host_shard()
    job = torch.load(path, weights_only=False)
    {"steps": run_steps, "fit": run_fit}[job["kind"]](job, group, rank, world)
    distributed.barrier(group)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
