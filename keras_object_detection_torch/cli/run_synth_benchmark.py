"""The end-to-end learning run: train a 20-class detector on a few thousand
generated images (``tools/make_synthetic_dataset.py``) and record its val
mAP (counterpart of the repository's ``tools/run_synth_benchmark.py``,
which trains the JAX package). It is the evidence, beyond short parity
runs, that the whole pipeline learns: input, augmentation, the train step,
validation, checkpoints and decode / NMS / mAP, over hundreds of epochs.

Usage:
  python tools/make_synthetic_dataset.py --out synth --train 2000 --val 200 \\
      --seed 1
  python -m keras_object_detection_torch.cli.run_synth_benchmark \\
      --data synth --workdir synth_run --epochs 300 --plateau 0.5,15,1e-4 \\
      --ema 0.999 --map-start 150 --map-every 50 --device-cache \\
      --save-cooldown 10 --pallas-loss

  # a tiny run on the CPU
  python -m keras_object_detection_torch.cli.run_synth_benchmark \\
      --data synth --workdir tiny_run --backbone darknet_micro \\
      --image-size 56 --batch-size 4 --epochs 2 --device cpu

Writes ``<workdir>/results.json`` with the JAX tool's keys: the final val
loss and mAP, the peak of the logged mAP curve and its epoch, the
steady-state epoch time and images/s, and the best checkpoint's val loss
and mAP (the best checkpoint, by val loss, is under ``<workdir>/ckpt``).
``--resume`` continues from the newest checkpoint for another ``--epochs``.
``--pallas-loss`` trains with the fused loss kernels; the BatchNorm
statistics kernels are ``ModelConfig.bn_mode="fused"``, which has no flag,
as in the JAX tool. Runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Tuple


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", required=True, help="dir with train/ and val/")
    p.add_argument("--workdir", required=True)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--grid", type=int, default=7,
                   help="GridConfig.grid S: the backbone's coarsest feature "
                        "size at --image-size (13 for darknet53 at 416, 7 "
                        "for darknet24 at 448)")
    p.add_argument("--backbone", default="darknet_tiny")
    p.add_argument("--head", default="conv",
                   choices=("conv", "anchor", "fpn"),
                   help="anchor = the YOLOv2 family (core/anchors.py); fpn = "
                        "the YOLOv3 multi-scale family (core/fpn.py); both "
                        "need --anchors")
    p.add_argument("--fpn-scales", type=int, default=2,
                   help="for --head fpn: prediction scales (grids S, 2S, "
                        "...); the anchor count must divide evenly")
    p.add_argument("--passthrough", action="store_true",
                   help="for --head anchor: YOLOv2's passthrough (reorg) "
                        "connection from the 2x-resolution backbone tap")
    p.add_argument("--anchors", default="kmeans:5",
                   help="for --head anchor / fpn: 'W,H;W,H;...' image-ratio "
                        "priors, or 'kmeans:K' to fit K priors to the train "
                        "labels with IoU k-means (cli/kmeans_anchors.py)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--decode-size", type=int, default=None,
                   help="decode train images at this size (above "
                        "--image-size) so the crop never upsamples, e.g. 501 "
                        "for 448 (DataConfig.train_decode_size)")
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "cosine_restarts", "piecewise_warmup"],
                   help="LR schedule kind (train/schedules.py); base_lr=--lr")
    p.add_argument("--t-max", type=int, default=50,
                   help="cosine_restarts: first cycle length (epochs)")
    p.add_argument("--t-mult", type=int, default=2,
                   help="cosine_restarts: cycle-length multiplier a restart")
    p.add_argument("--decay", type=float, default=1.0,
                   help="cosine_restarts: eta_max decay a cycle")
    p.add_argument("--eta-min", type=float, default=0.0,
                   help="cosine_restarts: floor LR")
    p.add_argument("--warmup-epochs", type=int, default=75,
                   help="piecewise_warmup: linear ramp length")
    p.add_argument("--mid-epochs", type=int, default=105)
    p.add_argument("--warmup-target", type=float, default=0.01)
    p.add_argument("--mid-lr", type=float, default=1e-3)
    p.add_argument("--final-lr", type=float, default=1e-4)
    p.add_argument("--plateau", default="0.5,15,1e-5",
                   help="reduce-on-plateau 'factor,patience,min_lr' ('' = off)")
    p.add_argument("--ema", type=float, default=None,
                   help="EMA decay of the evaluated weights (e.g. 0.999; "
                        "default off)")
    p.add_argument("--device-cache", action="store_true",
                   help="keep the whole dataset on the device and gather "
                        "batches there")
    p.add_argument("--save-cooldown", type=int, default=0,
                   help="min epochs between best-checkpoint saves")
    p.add_argument("--activation", default="relu",
                   choices=("relu", "leaky_relu"),
                   help="leaky_relu = the paper's LeakyReLU(0.1)")
    p.add_argument("--box-loss", default="mse",
                   choices=("mse", "diou", "ciou", "alpha_iou"),
                   help="diou = Distance-IoU box regression")
    p.add_argument("--mosaic", type=float, default=0.0,
                   help="mosaic augmentation probability per image")
    p.add_argument("--mixup", type=float, default=0.0,
                   help="detection mixup probability per image")
    p.add_argument("--multiscale", default="",
                   help="comma-separated multiscale training sizes")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation microbatches a step")
    p.add_argument("--ignore-threshold", type=float, default=None,
                   help="anchor / fpn: darknet's no-object ignore IoU "
                        "(TrainConfig.ignore_threshold; v2 0.6, v3 0.5)")
    p.add_argument("--obj-target", default="one", choices=("one", "iou"),
                   help="anchor / fpn: assigned-slot confidence target "
                        "(TrainConfig.obj_target; iou = darknet's live IoU)")
    p.add_argument("--pallas-loss", action="store_true",
                   help="train with the fused loss kernels "
                        "(TrainConfig.use_pallas_loss=True)")
    p.add_argument("--map-start", type=int, default=0,
                   help="epoch after which the periodic mAP starts (0 = "
                        "only once, at the end)")
    p.add_argument("--map-every", type=int, default=50)
    p.add_argument("--max-boxes", type=int, default=8,
                   help="per-image ground-truth padding (raise it for the "
                        "--hard dataset's crowded images)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="train steps whose rows and draws go to the device "
                        "in one copy (TrainConfig.steps_per_dispatch; -1 = "
                        "the whole epoch; needs --device-cache)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in the workdir "
                        "(the LR schedule continues at its epoch)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def parse_plateau(text: str) -> Optional[Tuple[float, int, float]]:
    """``'factor,patience,min_lr'`` -> ``Trainer.fit``'s
    ``reduce_on_plateau``; '' -> None."""
    if not text:
        return None
    f_, p_, m_ = text.split(",")
    return float(f_), int(p_), float(m_)


def fit_anchors(train_dir: str, k: int, seed: int):
    """``(anchors, mean best IoU)``: ``k`` priors fitted to the labels
    under ``train_dir`` by IoU k-means (YOLOv2's dimension clusters), as
    tuples of floats sorted by area."""
    from keras_object_detection_torch.cli.kmeans_anchors import (kmeans_iou,
                                                                 label_sizes)

    fitted, avg_iou = kmeans_iou(label_sizes(train_dir), k, seed=seed)
    return tuple((float(w), float(h)) for w, h in fitted), avg_iou


def build_config(args):
    """The run's ``Config``: the flags on the tool's fixed recipe (adam,
    every no-object confidence trained, images cached in memory, serving
    threshold 0.25, padded val images masked), checkpoints and logs under
    ``--workdir``. ``--anchors kmeans:K`` fits the priors here."""
    from keras_object_detection_torch.config import (Config, DataConfig,
                                                     EvalConfig, GridConfig,
                                                     ModelConfig,
                                                     ScheduleConfig,
                                                     TrainConfig)

    anchors = ()
    if args.head in ("anchor", "fpn"):
        if args.anchors.startswith("kmeans:"):
            anchors, avg_iou = fit_anchors(
                os.path.join(args.data, "train"),
                int(args.anchors.split(":")[1]), args.seed)
            print(f"fitted anchors (avg best-IoU {avg_iou:.4f}):", anchors)
        else:
            anchors = tuple(tuple(float(v) for v in a.split(","))
                            for a in args.anchors.split(";"))
    return Config(
        grid=GridConfig(grid=args.grid, num_classes=args.num_classes,
                        anchors=anchors),
        model=ModelConfig(backbone=args.backbone, head=args.head,
                          image_size=args.image_size,
                          activation=args.activation,
                          passthrough=args.passthrough,
                          fpn_scales=args.fpn_scales),
        data=DataConfig(
            train_dir=os.path.join(args.data, "train"),
            val_dir=os.path.join(args.data, "val"),
            batch_size=args.batch_size,
            max_boxes_per_image=args.max_boxes,
            cache_in_memory=True, device_cache=args.device_cache,
            train_decode_size=args.decode_size,
            mosaic_prob=args.mosaic, mixup_prob=args.mixup),
        train=TrainConfig(
            epochs=args.epochs, optimizer="adam",
            schedule=ScheduleConfig(
                kind=args.schedule, base_lr=args.lr,
                t_max=args.t_max, t_mult=args.t_mult, decay=args.decay,
                eta_min=args.eta_min,
                warmup_epochs=args.warmup_epochs, mid_epochs=args.mid_epochs,
                warmup_target=args.warmup_target, mid_lr=args.mid_lr,
                final_lr=args.final_lr),
            noobj_mode="all",
            box_loss_mode=args.box_loss,
            ignore_threshold=args.ignore_threshold,
            obj_target=args.obj_target,
            checkpoint_dir=os.path.join(args.workdir, "ckpt"),
            log_dir=os.path.join(args.workdir, "logs"),
            map_eval_start_epoch=(args.map_start or args.epochs + 1),
            map_eval_every=args.map_every,
            ema_decay=args.ema,
            save_cooldown_epochs=args.save_cooldown,
            use_pallas_loss=args.pallas_loss,
            multiscale_sizes=(tuple(int(x) for x in args.multiscale.split(","))
                              if args.multiscale else ()),
            grad_accum_steps=args.grad_accum,
            steps_per_dispatch=args.steps_per_dispatch,
            seed=args.seed),
        eval=EvalConfig(conf_threshold=0.25, mask_padded_images=True),
    )


def summarize_log(log_path: str, num_train: int) -> dict:
    """The mAP curve's peak and its epoch (``val_mAP_peak``,
    ``val_mAP_peak_epoch``), and over the last 60 epochs without a mAP the
    median epoch wall (``steady_state_epoch_s_p50``), the images/s it gives
    and the median train / val / save seconds; {} for a missing log."""
    out = {}
    peak, peak_epoch, epoch_times, decomp = None, None, [], []
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "val_mAP" in rec and (peak is None or rec["val_mAP"] > peak):
                    peak, peak_epoch = rec["val_mAP"], rec["step"]
                elif "epoch_time_s" in rec:
                    # epochs without a mAP: the train phase and the whole
                    # epoch (validation, save and bookkeeping included)
                    epoch_times.append(rec.get("wall_s", rec["epoch_time_s"]))
                    decomp.append((rec["epoch_time_s"], rec.get("val_s", 0.0),
                                   rec.get("save_s", 0.0)))
    if peak is not None:
        out["val_mAP_peak"] = round(float(peak), 5)
        out["val_mAP_peak_epoch"] = int(peak_epoch)
    steady = sorted(epoch_times[-60:])
    if steady:
        p50 = steady[len(steady) // 2]
        out["steady_state_epoch_s_p50"] = round(p50, 3)
        out["steady_state_images_per_s"] = round(num_train / p50, 1)
        tail = decomp[-60:]
        med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
        out["epoch_decomposition_p50_s"] = {
            "train": round(med([d[0] for d in tail]), 3),
            "val": round(med([d[1] for d in tail]), 3),
            "save": round(med([d[2] for d in tail]), 3),
        }
    return out


def run(cfg, args) -> dict:
    """Train ``cfg`` (resuming with ``--resume``), evaluate the final and
    the best checkpoint's state on the val set, and write
    ``<workdir>/results.json``; returns its dict. The datasets, the
    trainer and the report's sizes all read ``cfg``; ``args`` gives only
    what ``cfg`` does not hold: the workdir, ``--resume``, ``--plateau``,
    ``--device`` and the report's echo of ``--multiscale``."""
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.train import loop

    d, m, t = cfg.data, cfg.model, cfg.train
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(t.checkpoint_dir, exist_ok=True)
    with open(os.path.join(t.checkpoint_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    ms_max = max(t.multiscale_sizes or (0,))
    train_ds = YoloDataset(d.train_dir,
                           d.train_input_size(max(m.image_size, ms_max)),
                           d.batch_size, max_boxes=d.max_boxes_per_image,
                           shuffle=True, seed=t.seed,
                           cache_in_memory=d.cache_in_memory)
    val_ds = YoloDataset(d.val_dir, m.image_size, d.batch_size,
                         max_boxes=d.max_boxes_per_image,
                         cache_in_memory=d.cache_in_memory)

    trainer = loop.Trainer(cfg, device=args.device, use_tensorboard=False)
    print(f"device: {trainer.device}; train {train_ds.num_examples} "
          f"/ val {val_ds.num_examples} images")
    state = start_epoch = None
    if args.resume:
        latest = trainer.ckpt.latest_step
        if latest is None:
            print("no checkpoint to resume from; starting fresh")
        else:
            state = trainer.ckpt.restore(trainer.init_state(), step=latest)
            start_epoch = trainer.ckpt.latest_epoch + 1
            print(f"resumed from epoch {start_epoch} "
                  f"(optimizer step {state.step})")
    t0 = time.time()
    state = trainer.fit(train_ds, val_ds, verbose=True,
                        reduce_on_plateau=parse_plateau(args.plateau),
                        state=state, start_epoch=start_epoch)
    train_wall = time.time() - t0

    results = {k: float(v) for k, v in trainer.evaluate(state, val_ds).items()}
    # quote the best checkpoint's mAP beside the curve's peak: final-epoch
    # numbers of runs that end in different schedule phases do not compare
    results.update(summarize_log(os.path.join(t.log_dir, "train.jsonl"),
                                 train_ds.num_examples))

    # the checkpoint a deployment would serve: the best by val loss
    best_step = trainer.ckpt.best_step
    if best_step is not None:
        best_state = trainer.ckpt.restore(state, step=best_step)
        best_res = trainer.evaluate(best_state, val_ds)
        results["best_ckpt_epoch"] = int(best_step)
        results["best_ckpt_val_loss"] = float(best_res["val_loss"])
        results["best_ckpt_val_mAP"] = float(best_res["val_mAP"])
    s = t.schedule
    results.update(
        train_wall_s=round(train_wall, 1),
        epochs=t.epochs,
        train_images=train_ds.num_examples,
        val_images=val_ds.num_examples,
        num_classes=cfg.grid.num_classes,
        backbone=m.backbone,
        head=m.head,
        passthrough=m.passthrough,
        fpn_scales=(m.fpn_scales if m.head == "fpn" else None),
        anchors=[list(a) for a in cfg.grid.anchors],
        image_size=m.image_size,
        batch_size=d.batch_size,
        images_per_s_train=round(
            t.epochs * train_ds.num_examples / train_wall, 1),
        schedule=s.kind,
        activation=m.activation,
        box_loss=t.box_loss_mode,
        ignore_threshold=t.ignore_threshold,
        obj_target=t.obj_target,
        mosaic_prob=d.mosaic_prob,
        mixup_prob=d.mixup_prob,
        multiscale=args.multiscale,
        grad_accum=t.grad_accum_steps,
        schedule_params={
            "base_lr": s.base_lr, "t_max": s.t_max, "t_mult": s.t_mult,
            "decay": s.decay, "eta_min": s.eta_min}
        if s.kind == "cosine_restarts" else {"base_lr": s.base_lr},
        plateau=args.plateau,
    )
    trainer.close()
    with open(os.path.join(args.workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("RESULTS", json.dumps(results))
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(build_config(args), args)


if __name__ == "__main__":
    main()
