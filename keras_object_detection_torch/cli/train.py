"""Train a detector (counterpart of the repository's ``train.py``).

Examples:
  # the CPU-runnable tiny model on a small YOLO-format directory
  python -m keras_object_detection_torch.cli.train --data-dir data/ \\
      --preset tiny --epochs 5 --device cpu

  # the flagship: Darknet-24 at 448 on VOC, on the GPU
  python -m keras_object_detection_torch.cli.train --train-dir voc/train \\
      --val-dir voc/val --test-dir voc/test --preset voc --epochs 1000

  # the reference's transfer recipe: VGG16 from ImageNet weights, frozen
  python -m keras_object_detection_torch.cli.train --data-dir voc/ \\
      --backbone vgg16 --pretrained-backbone vgg16_notop.h5 --freeze-backbone

  # a YOLOv2-style anchor head (anchors from cli.kmeans_anchors); the
  # passthrough connection has no flag, as in the JAX package: set
  # ModelConfig.passthrough in Python (cli.evaluate reads it back from the
  # checkpoint's config.json)
  python -m keras_object_detection_torch.cli.train --data-dir voc/ \\
      --backbone darknet19 --head anchor --image-size 416 \\
      --anchors "0.1017,0.1332;0.2456,0.3084;0.3889,0.6230" \\
      --ignore-threshold 0.6 --obj-target iou

  # YOLOv3: Darknet-53 + the 3-scale FPN head at 416, the paper's 9 priors
  # (--anchors with 9 priors, from cli.kmeans_anchors --k 9, refits them)
  python -m keras_object_detection_torch.cli.train --data-dir voc/ \\
      --preset yolov3

  # data parallelism over 4 GPUs: 4 local ranks (NCCL), a global batch of
  # 64, 16 a rank; or under torchrun (--nproc-per-node 4) as it is
  python -m keras_object_detection_torch.cli.train --data-dir voc/ \\
      --preset voc --data-parallel 4
  # 2 ranks on the CPU (gloo)
  python -m keras_object_detection_torch.cli.train --data-dir data/ \\
      --preset tiny --batch-size 4 --data-parallel 2 --device cpu

  # a torch.profiler trace of the first epoch (a Chrome trace a rank)
  python -m keras_object_detection_torch.cli.train --data-dir data/ \\
      --preset tiny --epochs 2 --device cpu --profile-dir prof/

Writes ``config.json`` beside the checkpoints (``cli.evaluate`` reads it),
resumes from the latest checkpoint with ``--resume``, and evaluates the best
checkpoint on ``--test-dir`` after the fit. With ``--data-parallel N``
every rank trains on its row block of each global batch; rank 0 writes the
config, logs and checkpoints. Tensor parallelism has no flag, as in the JAX
CLI: the mesh's model axis is ``config.mesh.model_parallel`` (1 in every
preset), and ``--data-parallel N`` starts N times that many ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", help="one directory for train, val and test")
    p.add_argument("--train-dir")
    p.add_argument("--val-dir")
    p.add_argument("--test-dir")
    p.add_argument("--preset", choices=["tiny", "voc", "yolov3"], default="voc",
                   help="tiny (CPU-runnable), voc (the 448 Darknet-24 "
                        "flagship), yolov3 (416 Darknet-53 + the 3-scale FPN "
                        "head)")
    p.add_argument("--backbone",
                   choices=["darknet24", "darknet19", "darknet53",
                            "darknet_tiny", "darknet_micro", "vgg16",
                            "mobilenetv2"])
    p.add_argument("--head", choices=["conv", "gap_dense", "flatten_dense",
                                      "anchor", "fpn"])
    p.add_argument("--anchors", metavar="W,H;W,H;...",
                   help="anchor priors in image ratios for --head anchor "
                        "or fpn (fit with python -m "
                        "keras_object_detection_torch.cli.kmeans_anchors; fpn "
                        "needs a multiple of its scale count, split by area)")
    p.add_argument("--image-size", type=int)
    p.add_argument("--num-classes", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--epochs", type=int)
    p.add_argument("--optimizer",
                   choices=["adam", "nadam", "sgd", "adamw", "sgdw"])
    p.add_argument("--weight-decay", type=float,
                   help="decoupled weight decay for adamw/sgdw")
    p.add_argument("--schedule",
                   choices=["constant", "piecewise_warmup", "cosine_restarts"])
    p.add_argument("--lr", type=float)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"])
    p.add_argument("--pretrained-backbone", metavar="PATH",
                   help="backbone weights loaded at init: a Keras .h5, "
                        ".weights.h5 or .keras file (vgg16, mobilenetv2; "
                        "read with h5py) or a darknet .weights / .conv.NN "
                        "file (darknet backbones)")
    p.add_argument("--freeze-backbone", action="store_true",
                   help="train with the backbone frozen (eval mode, no "
                        "gradient)")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="ranks of data parallelism: N > 1 starts N local "
                        "processes (one a GPU; gloo with --device cpu) unless "
                        "a torchrun world is up; -1 takes that world, or one "
                        "process")
    p.add_argument("--early-stop-patience", type=int)
    p.add_argument("--cache-in-memory", action="store_true",
                   help="keep decoded uint8 images in host RAM across epochs")
    p.add_argument("--cache-dir",
                   help="decode-ahead disk cache directory (raw uint8 memmap)")
    p.add_argument("--device-cache", action="store_true",
                   help="keep the whole dataset on the device and gather "
                        "batches there")
    p.add_argument("--device-cache-layout", choices=["replicated", "sharded"])
    p.add_argument("--train-decode-size", type=int,
                   help="decode train images at this size (above "
                        "--image-size); the crop samples down to it")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--profile-dir",
                   help="capture a torch.profiler trace of the first epoch")
    p.add_argument("--multiscale", metavar="S1,S2,...",
                   help="multi-scale training: comma-separated input sizes "
                        "drawn per epoch (each a multiple of the backbone "
                        "stride); evaluation stays at --image-size")
    p.add_argument("--multiscale-every", type=int,
                   help="re-draw the multiscale size every N epochs")
    p.add_argument("--letterbox", action="store_true",
                   help="aspect-preserving resize with gray padding")
    p.add_argument("--mosaic", type=float, metavar="PROB",
                   help="mosaic augmentation probability per image "
                        "(four images composed into quadrants; 0 disables)")
    p.add_argument("--mixup", type=float, metavar="PROB",
                   help="detection mixup probability per image (blend with "
                        "a partner, keep the box union; 0 disables)")
    p.add_argument("--grad-accum", type=int, metavar="N",
                   help="split each batch into N microbatches (summed "
                        "gradients, one update)")
    p.add_argument("--ignore-threshold", type=float, metavar="IOU",
                   help="anchor/fpn heads: exempt unassigned slots whose "
                        "decoded prediction overlaps any GT above this IoU "
                        "from the no-object loss (darknet v2 uses 0.6)")
    p.add_argument("--obj-target", choices=["one", "iou"],
                   help="anchor/fpn heads: assigned-slot confidence target "
                        "(iou = darknet's live-IoU objectness)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to train on the CPU)")
    return p.parse_args(argv)


def build_config(args):
    """The preset with the flags applied (the JAX CLI's ``build_config``)."""
    from keras_object_detection_torch import config as cfglib

    cfg = {"tiny": cfglib.tiny_cpu_config, "voc": cfglib.voc_full_config,
           "yolov3": cfglib.yolov3_config}[args.preset]()

    def over(obj, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(obj, **kw) if kw else obj

    train_dir = args.train_dir or args.data_dir
    if not train_dir:
        raise SystemExit("error: --data-dir or --train-dir is required")
    val_dir = args.val_dir or args.data_dir or train_dir
    test_dir = args.test_dir or ""
    sched = over(cfg.train.schedule, kind=args.schedule, base_lr=args.lr)
    return dataclasses.replace(
        cfg,
        grid=over(cfg.grid, num_classes=args.num_classes,
                  anchors=(tuple(tuple(float(v) for v in a.split(","))
                                 for a in args.anchors.split(";"))
                           if args.anchors else None)),
        model=over(cfg.model, backbone=args.backbone, head=args.head,
                   image_size=args.image_size, compute_dtype=args.compute_dtype,
                   pretrained_backbone=args.pretrained_backbone,
                   freeze_backbone=args.freeze_backbone or None),
        data=over(cfg.data, train_dir=train_dir, val_dir=val_dir,
                  test_dir=test_dir, batch_size=args.batch_size,
                  cache_in_memory=args.cache_in_memory or None,
                  cache_dir=args.cache_dir,
                  device_cache=args.device_cache or None,
                  device_cache_layout=args.device_cache_layout,
                  train_decode_size=args.train_decode_size,
                  letterbox=args.letterbox or None,
                  mosaic_prob=args.mosaic, mixup_prob=args.mixup),
        train=over(cfg.train, epochs=args.epochs, optimizer=args.optimizer,
                   schedule=sched, checkpoint_dir=args.checkpoint_dir,
                   log_dir=args.log_dir, seed=args.seed,
                   grad_accum_steps=args.grad_accum,
                   multiscale_sizes=(tuple(int(v) for v in
                                           args.multiscale.split(","))
                                     if args.multiscale else None),
                   multiscale_every=args.multiscale_every,
                   weight_decay=args.weight_decay,
                   ignore_threshold=args.ignore_threshold,
                   obj_target=args.obj_target),
        mesh=over(cfg.mesh, data_parallel=args.data_parallel),
    )


def main(argv=None) -> None:
    import sys

    args = parse_args(argv)
    cfg = build_config(args)

    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.parallel import distributed
    from keras_object_detection_torch.train import Trainer
    from keras_object_detection_torch.train.loop import check_batch_divides

    if args.data_parallel > 1 and not distributed.in_launched_world():
        check_batch_divides(cfg, args.data_parallel)
        rc = distributed.launch_local(
            "keras_object_detection_torch.cli.train",
            sys.argv[1:] if argv is None else list(argv),
            args.data_parallel * cfg.mesh.model_parallel)
        if rc:
            raise SystemExit(f"error: a data-parallel rank exited with {rc}")
        return
    distributed.maybe_initialize(
        backend="gloo" if args.device.startswith("cpu") else None)
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()  # raises on an unported model first
    if trainer.is_main:
        os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
        with open(os.path.join(cfg.train.checkpoint_dir, "config.json"),
                  "w") as f:
            f.write(cfg.to_json())

    d = cfg.data
    cache = (lambda split: os.path.join(d.cache_dir, split)
             if d.cache_dir else None)
    # multiscale trains some epochs above image_size: decode at the largest
    # training resolution so that no epoch upsamples
    ms_max = max(cfg.train.multiscale_sizes or (0,))
    train_ds = YoloDataset(
        d.train_dir, d.train_input_size(max(cfg.model.image_size, ms_max)),
        d.batch_size,
        max_boxes=d.max_boxes_per_image, shuffle=d.shuffle,
        drop_remainder=d.drop_remainder, num_workers=d.num_workers,
        seed=cfg.train.seed, cache_in_memory=d.cache_in_memory,
        cache_dir=cache("train"), letterbox=d.letterbox)
    val_ds = YoloDataset(
        d.val_dir, cfg.model.image_size, d.batch_size,
        max_boxes=d.max_boxes_per_image, num_workers=d.num_workers,
        cache_dir=cache("val"), letterbox=d.letterbox)

    start_epoch = None
    if args.resume:
        latest = trainer.ckpt.latest_step
        if latest is None:
            if trainer.is_main:
                print("no checkpoint to resume from; starting fresh")
        else:
            state = trainer.ckpt.restore(state, step=latest)
            # the checkpoint axis is the epoch: the schedule continues at
            # the next one whatever the batch or dataset size
            start_epoch = trainer.ckpt.latest_epoch + 1
            if trainer.is_main:
                print(f"resumed from epoch {start_epoch} (optimizer step "
                  f"{state.step})")
    if args.profile_dir:
        from keras_object_detection_torch.utils.profiling import trace

        with trace(args.profile_dir):
            state = trainer.fit(train_ds, val_ds, epochs=1, state=state,
                                start_epoch=start_epoch)
        remaining = cfg.train.epochs - 1
        if remaining > 0:
            # the epoch axis continues explicitly: inferring it from the
            # optimizer step breaks where the batch or dataset size changed
            state = trainer.fit(train_ds, val_ds, epochs=remaining,
                                state=state,
                                early_stop_patience=args.early_stop_patience,
                                start_epoch=(start_epoch or 0) + 1)
    else:
        state = trainer.fit(train_ds, val_ds, state=state,
                            early_stop_patience=args.early_stop_patience,
                            start_epoch=start_epoch)

    if d.test_dir:
        best = trainer.ckpt.restore(state)
        test_ds = YoloDataset(d.test_dir, cfg.model.image_size, d.batch_size,
                              max_boxes=d.max_boxes_per_image,
                              letterbox=d.letterbox)
        results = trainer.evaluate(best, test_ds)
        if trainer.is_main:
            print("test results:", results)
    trainer.close()


if __name__ == "__main__":
    main()
