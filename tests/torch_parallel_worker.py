"""One rank of the data- and tensor-parallel tests (not a test module: the
tests start it with ``parallel.distributed.launch_local``, gloo ranks on
the CPU).

    python -m tests.torch_parallel_worker JOB

``JOB`` is a ``torch.save`` of ``{"kind": "steps" | "fit" | "tp", "out":
dir, ...}``; each rank writes ``<out>/<name>_<rank>.pt``. ``"tp"`` runs the
steps, the fit and a checkpoint restore on a mesh of
``job["model_parallel"]`` model ranks (``job["min_elements"]`` the
sharding threshold). States are saved whole (``parallel.tensor.
full_tensors``). It imports torch and the port only, and runs one
intra-op thread (several ranks share the cores)."""

import os
import sys

import torch


def _counts():
    from keras_object_detection_torch.parallel import distributed

    return {"all_reduces": distributed.ALL_REDUCES,
            "gathers": distributed.GATHERS}


def _mesh(job):
    from keras_object_detection_torch.parallel import create_mesh

    return create_mesh(-1, job.get("model_parallel", 1))


def _min_elements(job):
    from keras_object_detection_torch.parallel.mesh import TP_MIN_ELEMENTS

    return job.get("min_elements", TP_MIN_ELEMENTS)


def _placed(cfg, mesh, job, state_dict=None):
    """A state of ``cfg`` on the CPU (holding ``state_dict``'s weights
    where given) placed on ``mesh``'s model axis at the job's threshold."""
    from keras_object_detection_torch.parallel import tensor
    from keras_object_detection_torch.train import create_train_state

    state = create_train_state(cfg, device="cpu")
    if state_dict is not None:
        state.model.load_state_dict(state_dict)
    return tensor.shard_state(state, mesh, _min_elements(job))


def _whole(state):
    """The state's model state dict, EMA and optimizer moments (by
    parameter name) as whole tensors."""
    from keras_object_detection_torch.parallel import tensor

    model = state.model
    names = [n for n, _ in model.named_parameters()]
    moments = {k: tensor.full_tensors(model, dict(zip(names, v)))
               for k, v in (("mu", state.opt.mu), ("nu", state.opt.nu)) if v}
    return {"state_dict": tensor.full_tensors(model, model.state_dict()),
            "ema": (None if state.ema is None
                    else tensor.full_tensors(model, state.ema)),
            "moments": moments}


def run_steps(job, group, rank, world):
    """Each case: the port's state from the case's weights (placed on the
    mesh's model axis, if it has one), ``steps`` train steps on the row
    block of this rank's data index of the global batch with the global
    draws; writes the whole state dict, EMA, moments, metrics and
    collective counts."""
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.parallel import distributed, tensor
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    mesh = _mesh(job)
    for name, case in job["cases"].items():
        cfg = Config.from_json(case["config"])
        state = create_train_state(cfg, device="cpu")
        state.model.load_state_dict(case["state_dict"])
        if state.ema is not None:
            state.ema = {k: v.detach().clone()
                         for k, v in state.model.named_parameters()}
        tensor.shard_state(state, mesh, _min_elements(job))
        step = make_train_step(cfg, group=mesh.data_group)
        images, boxes, valid = case["batch"]
        rows = images.shape[0] // mesh.data_parallel
        own = slice(mesh.index * rows, (mesh.index + 1) * rows)
        distributed.reset_counts()
        metrics = []
        for draws in case["draws"]:
            state, m = step(state, images[own], boxes[own], valid[own],
                            seed=0, draws=draws)
            metrics.append({k: float(v) for k, v in m.items()})
        pl = tensor.placement(state.model)
        torch.save({**_whole(state), "metrics": metrics,
                    "counts": _counts(),
                    "sharded": [] if pl is None else list(pl.sharded)},
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
    state = _placed(cfg, trainer.mesh, job, job["state_dict"])
    kw = dict(max_boxes=8)
    state = trainer.fit(YoloDataset(job["train"], 56, 4, shuffle=True, seed=0,
                                    **kw),
                        YoloDataset(job["train"], 56, 4, **kw),
                        state=state, verbose=False, **job.get("fit", {}))
    test = trainer.evaluate(state, YoloDataset(job["train"], 56, 4, **kw))
    trainer.close()
    # the sharded cache: rank r's gathered block of every batch of two
    # epochs equals the replicated layout's
    mesh = _mesh(job)
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
                               "darknet_micro@56", torch.device("cpu"),
                               create_mesh())
    torch.save({**_whole(state), "test": test,
                "cache_equal": equal and len(same[0]) == len(same[1]) > 0,
                "cache_rows": cache.images.shape[0],
                "cache_batches": len(same[0]), "dryrun_fpn_loss": dry},
               os.path.join(job["out"], f"fit_{rank}.pt"))


def run_restore(job, group, rank, world):
    """A one-process checkpoint (``job["restore"]``) restored into a state
    on this mesh: the restored state, whole."""
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.train.checkpoint import \
        CheckpointManager

    cfg = Config.from_json(job["config"])
    manager = CheckpointManager(job["restore"], writer=False)
    state = manager.restore(_placed(cfg, _mesh(job), job))
    manager.close()
    torch.save(_whole(state), os.path.join(job["out"], f"restore_{rank}.pt"))


def run_tp(job, group, rank, world):
    """The tensor-parallel module's work in one group of ranks: its steps,
    its fit, a one-process checkpoint restored into the mesh, and the dry
    run's step on the mesh (``darknet_tiny``, whose head conv crosses JAX's
    threshold)."""
    from keras_object_detection_torch.config import tiny_cpu_config
    from keras_object_detection_torch.parallel import dryrun

    run_steps(job, group, rank, world)
    run_fit(dict(job, **job["fit_job"]), group, rank, world)
    run_restore(dict(job, **job["fit_job"]), group, rank, world)
    loss = dryrun._sharded_step(tiny_cpu_config(), "tiny conv-head",
                                torch.device("cpu"), _mesh(job))
    torch.save(loss, os.path.join(job["out"], f"dryrun_{rank}.pt"))


def main(path):
    from keras_object_detection_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.maybe_initialize(backend="gloo")
    group = torch.distributed.group.WORLD
    rank, world = distributed.host_shard()
    job = torch.load(path, weights_only=False)
    {"steps": run_steps, "fit": run_fit, "tp": run_tp}[job["kind"]](
        job, group, rank, world)
    distributed.barrier(group)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
