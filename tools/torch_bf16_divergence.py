#!/usr/bin/env python3
"""How far the port's bf16 flagship train steps part, and why: the kernel
path (``use_pallas_loss=True``, ``bn_mode="fused"``) against the plain path
(both off) on ``voc_full_config()`` at batch 64, on one NVIDIA GPU.

    python3 tools/torch_bf16_divergence.py [--steps 13] [--seeds 1 2 5]
                                           [--weight-seeds 0 3]

1. Trajectories: for each weight seed and draw seed, each path runs twice
   ``--steps`` steps from the same weights on bench.py's synthetic batch;
   every step's loss is printed, and the mean of the last five. Two runs of
   one path differ only by cuDNN's run-to-run order of sums.
2. One step's gradients, per parameter tensor (conv biases, zero up to
   rounding, left out), as the relative error in norm of: the kernel path
   against the plain path; the plain path on the batch in reverse order
   (and each image's draws with it) against the plain path, which changes
   only the order of its sums; each bf16 path against the float32 step
   (the plain path with ``compute_dtype="float32"``).

Builds the kernels from the checkout first, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def trajectory(kernels: bool, steps: int, weight_seed: int, seed: int,
               dev) -> list:
    from keras_object_detection_torch.train import (create_train_state,
                                                    make_train_step)

    cfg = cs.train_config(kernels)
    state = create_train_state(cfg, torch.Generator().manual_seed(weight_seed))
    batch = cs.synthetic_batch(cfg.data.batch_size, cfg.model.image_size,
                               cfg.data.max_boxes_per_image, dev)
    step = make_train_step(cfg)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, *batch, seed)
        losses.append(metrics["total"].item())
    del state, batch
    torch.cuda.empty_cache()
    return losses


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=13)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 5])
    parser.add_argument("--weight-seeds", type=int, nargs="+", default=[0, 3])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_build()

    for weight_seed in args.weight_seeds:
        for seed in args.seeds:
            for kernels in (True, False):
                for run in ("a", "b"):
                    losses = trajectory(kernels, args.steps, weight_seed, seed,
                                        dev)
                    name = "kernels" if kernels else "plain"
                    print(f"[trajectory] weights {weight_seed} draws {seed} "
                          f"{name} run {run}: last-5 mean "
                          f"{sum(losses[-5:]) / len(losses[-5:]):.3f}; "
                          + " ".join(f"{v:.3f}" for v in losses), flush=True)

    runs = {
        "kernels": cs.first_step(True, dev),
        "plain": cs.first_step(False, dev),
        "plain reversed": cs.first_step(False, dev, reverse=True),
        "float32": cs.first_step(False, dev, "float32"),
    }
    print("[grads] losses " + ", ".join(f"{k} {v[0]:.5f}"
                                         for k, v in runs.items()))
    k, p, r, f = (runs[n][2] for n in runs)
    print("[grads] tensor: kernels-vs-plain, plain-reversed-vs-plain, "
          "plain-vs-float32, kernels-vs-float32")
    for name in f:
        print(f"[grads] {name} {cs.rel_norm(k[name], p[name]):.3e} "
              f"{cs.rel_norm(r[name], p[name]):.3e} "
              f"{cs.rel_norm(p[name], f[name]):.3e} "
              f"{cs.rel_norm(k[name], f[name]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
