"""A multi-rank dry run over the real model families (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``), in JAX's layout:

1. the flagship conv-head step (``voc_full_config()``: Darknet-24 at 448²,
   bf16), one image a data rank, on a ``(n/2 data, 2 model)`` mesh from 4
   ranks on (an even count), its large kernels and their moments placed on
   the model axis (``parallel.tensor.shard_state``; at least 3 sharded
   leaves asserted, as JAX does); on the data axis alone below that;
2. the FPN (YOLOv3-style) step: ``darknet_micro``, 2 scales, 6 anchors at
   56², one image a rank, on the data axis alone;
3. sharded serving of the FPN model over a device mesh of n replicas.

Each of n ranks (``parallel.distributed.launch_local``; gloo on the CPU and
for ranks that share a card, else NCCL, one rank a card) takes one step of
1 and 2 and checks a finite loss, equal on every rank.

    python -m keras_object_detection_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

FPN_ANCHORS = ((0.08, 0.1), (0.12, 0.18), (0.2, 0.15),
               (0.3, 0.4), (0.5, 0.45), (0.7, 0.7))


def fpn_config(batch: int):
    """The dry run's FPN family config (JAX's, ``__graft_entry__.py``)."""
    from keras_object_detection_torch.config import (
        Config, DataConfig, EvalConfig, GridConfig, ModelConfig,
        ScheduleConfig, TrainConfig)

    return Config(
        grid=GridConfig(grid=7, num_boxes=2, num_classes=3,
                        anchors=FPN_ANCHORS),
        model=ModelConfig(backbone="darknet_micro", head="fpn", fpn_scales=2,
                          image_size=56, compute_dtype="float32",
                          activation="leaky_relu"),
        data=DataConfig(batch_size=batch, max_boxes_per_image=8),
        train=TrainConfig(optimizer="adam", ignore_threshold=0.5,
                          schedule=ScheduleConfig(kind="constant",
                                                  base_lr=1e-3)),
        eval=EvalConfig(conf_threshold=0.1))


def sharded_leaves(state, mesh) -> int:
    """The leaves of ``state``'s parameters and optimizer moments that
    ``state_sharding`` places on the model axis (the count JAX's dry run
    asserts)."""
    from keras_object_detection_torch.parallel.mesh import state_sharding

    opt = state.opt
    names = [n for n, _ in state.model.named_parameters()]
    tree = {"params": dict(state.model.named_parameters()),
            **{k: dict(zip(names, v)) for k, v in
               (("mu", opt.mu), ("nu", opt.nu), ("trace", opt.trace)) if v}}
    if state.ema is not None:
        tree["ema"] = state.ema
    specs = state_sharding(mesh, tree, mesh.model_axis)
    return sum(1 for sub in specs.values() for spec in sub.values() if spec)


def _sharded_step(cfg, label: str, device: torch.device, mesh) -> float:
    """One train step of ``cfg`` at one image a data rank over ``mesh`` (a
    process mesh; with a model axis the state placed on it): its loss,
    checked finite and equal on every rank."""
    from keras_object_detection_torch.parallel import distributed, tensor
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    dp = mesh.data_parallel
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=dp))
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device)
    if mesh.model_parallel > 1:
        n_sharded = sharded_leaves(state, mesh)
        # at least one large kernel and its two moments, as JAX asserts
        assert n_sharded >= 3, (f"{label}: expected tensor-parallel sharded "
                                f"leaves, got {n_sharded}")
        tensor.shard_state(state, mesh)
    size = cfg.model.image_size
    rng = np.random.RandomState(mesh.index)
    images = rng.randint(0, 255, (1, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((1, 8, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    valid = np.zeros((1, 8), bool)
    valid[:, 0] = True
    state, metrics = make_train_step(cfg, group=mesh.data_group)(
        state, images, boxes, valid, 1)
    loss = metrics["total"].detach().float().reshape(1)
    losses = distributed.all_gather_rows(loss, mesh.group)
    assert torch.isfinite(losses).all(), f"{label}: non-finite loss {losses}"
    assert bool((losses == losses[0]).all()), f"{label}: ranks differ {losses}"
    assert state.step == 1
    if distributed.is_main(mesh.group):
        print(f"dryrun_multichip {label}: OK, loss={float(loss):.4f}, "
              f"mesh={mesh.shape}", flush=True)
    return float(loss)


def run_rank(device: Optional[str] = None, flagship: bool = True) -> None:
    """One rank of the dry run: joins the group the environment describes,
    takes the flagship's step on JAX's ``(n/2, 2)`` mesh (from 4 ranks on)
    and the FPN family's on the data axis."""
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.parallel import create_mesh, distributed

    cpu = device is not None and torch.device(device).type == "cpu"
    n = int(os.environ["WORLD_SIZE"])
    # NCCL takes one rank a card: ranks that share one go through gloo
    distributed.maybe_initialize(backend="gloo" if cpu or n > (
        torch.cuda.device_count()) else None)
    dev = torch.device(device) if device else torch.device(
        "cuda", torch.cuda.current_device())
    tp = 2 if n >= 4 and n % 2 == 0 else 1
    dp_mesh = create_mesh(n)
    if flagship:
        _sharded_step(voc_full_config(), "flagship conv-head darknet24@448 "
                      "bf16", dev, dp_mesh if tp == 1 else
                      create_mesh(n // tp, tp))
    _sharded_step(fpn_config(1), "fpn 2-scale darknet_micro@56", dev,
                  dp_mesh)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     flagship: bool = True) -> None:
    """The dry run over ``n_devices`` ranks, started here as local
    processes (``device``: ``"cpu"`` for gloo ranks on the CPU; default
    the GPUs, one a rank where there are enough, else shared), then FPN
    serving over a device mesh of ``n_devices`` replicas of ``device``.
    Raises where a rank fails."""
    from keras_object_detection_torch.eval import InferenceModel
    from keras_object_detection_torch.models import build_model
    from keras_object_detection_torch.parallel import create_mesh, distributed

    argv = [str(n_devices)] + (["--device", device] if device else []) + (
        [] if flagship else ["--no-flagship"])
    rc = distributed.launch_local("keras_object_detection_torch.parallel.dryrun",
                                  argv, n_devices)
    if rc:
        raise RuntimeError(f"dryrun_multichip: a rank exited with {rc}")
    cfg = fpn_config(2 * n_devices)
    devices = ([device] * n_devices if device else
               [f"cuda:{i % torch.cuda.device_count()}"
                for i in range(n_devices)])
    mesh = create_mesh(data_parallel=n_devices, devices=devices)
    model = InferenceModel(cfg, build_model(cfg, torch.Generator().manual_seed(2))
                           .state_dict(), mesh=mesh)
    probe = np.random.RandomState(1).randint(
        0, 256, (2 * n_devices, 56, 56, 3)).astype(np.uint8)
    boxes, valid = model.predict(probe)
    assert boxes.shape[0] == 2 * n_devices and torch.isfinite(boxes).all()
    print(f"dryrun_multichip sharded serving fpn@56: OK, "
          f"batch={2 * n_devices} over dp={n_devices}")
    print(f"dryrun_multichip({n_devices}): OK")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", help="cpu (gloo ranks); default one GPU a rank")
    p.add_argument("--no-flagship", action="store_true",
                   help="the FPN step alone (the flagship is full width)")
    args = p.parse_args(argv)
    from keras_object_detection_torch.parallel import distributed

    if distributed.in_launched_world():
        run_rank(args.device, not args.no_flagship)
    else:
        dryrun_multichip(args.n, args.device, not args.no_flagship)


if __name__ == "__main__":
    main(sys.argv[1:])
