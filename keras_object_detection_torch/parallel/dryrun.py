"""A multi-rank dry run over the real model families (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``), pure data parallelism:

1. the flagship conv-head step (``voc_full_config()``: Darknet-24 at 448²,
   bf16), one image a rank;
2. the FPN (YOLOv3-style) step: ``darknet_micro``, 2 scales, 6 anchors at
   56², one image a rank;
3. sharded serving of the FPN model over a device mesh of n replicas.

Each of n ranks (``parallel.distributed.launch_local``; gloo on the CPU,
NCCL on GPUs, one a card) takes one step of 1 and 2 and checks a finite
loss, equal on every rank. JAX's dry run lays the flagship on a (n/2 data,
2 model) mesh from 4 devices on; that layout waits for tensor parallelism
(ROADMAP 1.15), so both steps here run on the data axis alone.

    python -m keras_object_detection_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _sharded_step(cfg, label: str, device: torch.device, group) -> float:
    """One data-parallel train step of ``cfg`` at one image a rank: its
    loss, checked finite and equal on every rank."""
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    world = distributed.world_size(group)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, batch_size=world))
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device)
    size = cfg.model.image_size
    rng = np.random.RandomState(distributed.rank_of(group))
    images = rng.randint(0, 255, (1, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((1, 8, 5), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.3, 0.3, 1.0]
    valid = np.zeros((1, 8), bool)
    valid[:, 0] = True
    state, metrics = make_train_step(cfg, group=group)(
        state, images, boxes, valid, 1)
    loss = metrics["total"].detach().float().reshape(1)
    losses = distributed.all_gather_rows(loss, group)
    assert torch.isfinite(losses).all(), f"{label}: non-finite loss {losses}"
    assert bool((losses == losses[0]).all()), f"{label}: ranks differ {losses}"
    assert state.step == 1
    if distributed.is_main(group):
        print(f"dryrun_multichip {label}: OK, loss={float(loss):.4f}, "
              f"mesh={{'data': {world}, 'model': 1}}", flush=True)
    return float(loss)


def run_rank(device: Optional[str] = None, flagship: bool = True) -> None:
    """One rank of the dry run: joins the group the environment describes,
    takes the flagship's and the FPN family's step."""
    from keras_object_detection_torch.config import voc_full_config
    from keras_object_detection_torch.parallel import distributed

    cpu = device is not None and torch.device(device).type == "cpu"
    distributed.maybe_initialize(backend="gloo" if cpu else None)
    group = torch.distributed.group.WORLD
    dev = torch.device(device) if device else torch.device(
        "cuda", torch.cuda.current_device())
    if flagship:
        _sharded_step(voc_full_config(), "flagship conv-head darknet24@448 "
                      "bf16", dev, group)
    _sharded_step(fpn_config(1), "fpn 2-scale darknet_micro@56", dev, group)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     flagship: bool = True) -> None:
    """The dry run over ``n_devices`` ranks, started here as local
    processes (``device``: ``"cpu"`` for gloo ranks on the CPU; default
    one GPU a rank), then FPN serving over a device mesh of
    ``n_devices`` replicas of ``device``. Raises where a rank fails."""
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
