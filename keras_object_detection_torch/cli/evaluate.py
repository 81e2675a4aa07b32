"""Evaluate or serve a trained detector (counterpart of the repository's
``evaluate.py``).

Examples:
  # dataset loss and mAP of the best checkpoint
  python -m keras_object_detection_torch.cli.evaluate \\
      --checkpoint-dir checkpoints --data-dir voc/test --coco-map

  # detections of one image, with serving latency, int8 serving
  # calibrated on 64 images of the test set
  python -m keras_object_detection_torch.cli.evaluate \\
      --checkpoint-dir checkpoints --image data/test.jpg \\
      --serving int8 --calib-images 64 --data-dir voc/test

  # dataset loss and mAP over a mesh of 2 GPUs (one process, a replica
  # of the weights on each, a shard of each batch)
  python -m keras_object_detection_torch.cli.evaluate \\
      --checkpoint-dir checkpoints --data-dir voc/test --data-parallel 2

  # tag one image (or with --image-dir and --tag-dir every image) with its
  # detections; --grid-overlay adds the S x S lattice and box centres
  python -m keras_object_detection_torch.cli.evaluate \\
      --checkpoint-dir checkpoints --image data/test.jpg \\
      --names data/test.names --output tagged.jpg

Reads ``config.json`` from the checkpoint directory (written by
``cli.train``). Runs on ``--device`` (default cuda). Tagged images are drawn
with cv2 (``utils/viz.py``) in the frame the model saw (letterboxed where
the config letterboxes), as the JAX CLI draws them.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--data-dir", help="YOLO-format directory: loss and mAP")
    p.add_argument("--image", help="one image: its detections and latency")
    p.add_argument("--image-dir",
                   help="every *.jpg of a directory (no labels needed): "
                        "detections to --detections-json")
    p.add_argument("--detections-json", default="detections.json")
    p.add_argument("--tag-dir",
                   help="with --image-dir and --names: write tagged copies "
                        "of every image here")
    p.add_argument("--names", help="class-names file: tagged images, "
                                    "per-class AP and PR curve labels")
    p.add_argument("--output", default="tagged.jpg",
                   help="the tagged --image (with --names)")
    p.add_argument("--grid-overlay", action="store_true",
                   help="tagged images also show the S x S lattice and the "
                        "boxes' centres")
    p.add_argument("--latency-runs", type=int, default=5)
    p.add_argument("--cache-dir", help="decode-ahead disk cache for --data-dir")
    p.add_argument("--coco-map", action="store_true",
                   help="also mAP@[.50:.95] and each COCO threshold")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="evaluate --data-dir over a mesh of this many "
                        "devices (-1: every GPU; on --device cpu, replicas "
                        "on the CPU): each batch cut into one shard a device")
    p.add_argument("--pr-json", metavar="PATH",
                   help="with --data-dir: per-class precision/recall curves")
    p.add_argument("--error-analysis", action="store_true",
                   help="with --data-dir: TIDE-style breakdown of every "
                        "detection (tp/duplicate/classification/localization/"
                        "both/background + missed GTs, per class)")
    p.add_argument("--per-class-ap", action="store_true",
                   help="also print each class's AP")
    p.add_argument("--use-ema", action="store_true",
                   help="serve the EMA weights (the checkpoint must have them)")
    p.add_argument("--nms-mode", choices=("hard", "soft_gaussian",
                                          "soft_linear", "fast"),
                   help="EvalConfig.nms_mode for serving: hard (greedy), "
                        "soft_* (confidence decay), fast (matrix NMS)")
    p.add_argument("--soft-nms-sigma", type=float,
                   help="gaussian soft NMS's decay (EvalConfig.soft_nms_sigma)")
    p.add_argument("--avg-ckpts", type=int, metavar="K", default=0,
                   help="serve the average of the newest K checkpoints")
    p.add_argument("--tta", choices=("none", "hflip"),
                   help="hflip: forward the mirror too, NMS over the union")
    p.add_argument("--serving", choices=("float", "int8", "auto"),
                   default="float",
                   help="float, int8 (BN folded, s8 x s8 -> s32 convs) or "
                        "auto (time both at batch 1, serve the faster)")
    p.add_argument("--calib-images", type=int, default=0, metavar="N",
                   help="for --serving int8/auto with --data-dir: static "
                        "activation scales calibrated on N dataset images")
    p.add_argument("--qat-steps", type=int, default=0, metavar="STEPS",
                   help="with --calib-images: QAT steps before freezing to "
                        "int8")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def eval_mesh(args):
    """The device mesh of ``--data-parallel`` (None for 1): the first N
    GPUs (-1: all), or N replicas on the CPU where ``--device cpu`` asks
    for it; JAX's mesh-size error where there are fewer GPUs, and the
    GPU-by-default error where there is none."""
    if args.data_parallel == 1:
        return None
    import torch

    from keras_object_detection_torch.parallel.mesh import (create_mesh,
                                                            local_devices)

    if torch.device(args.device).type == "cpu":
        devs = [torch.device("cpu")] * max(args.data_parallel, 1)
    else:
        devs = local_devices()
        if args.data_parallel != -1:
            devs = devs[:args.data_parallel]
    return create_mesh(data_parallel=args.data_parallel, devices=devs)


def calibration_images(ds, n: int):
    """The first ``n`` images of ``ds`` as one u8 array, without the zero
    frames that pad its last batch (black frames would skew the
    calibration)."""
    import numpy as np

    stack = []
    for bi, (images, _, _) in enumerate(ds.epoch()):
        real = min(len(images), ds.num_examples - bi * ds.batch_size)
        stack.extend(images[:real])
        if len(stack) >= n:
            break
    return np.stack(stack[:n])


def serving_model(args, cfg, state_dict):
    """``(model, info)`` of ``--serving``, with ``--calib-images`` and
    ``--qat-steps`` (JAX's CLI's rules and errors)."""
    from keras_object_detection_torch.eval import InferenceModel

    if args.serving == "float":
        if args.calib_images or args.qat_steps:
            raise SystemExit("error: --calib-images/--qat-steps configure "
                             "int8 serving; add --serving int8 (or auto)")
        return InferenceModel(cfg, state_dict, device=args.device), None
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.export import select_serving_model

    calib = None
    if args.calib_images:
        if not args.data_dir:
            raise SystemExit("error: --calib-images needs --data-dir")
        calib = calibration_images(YoloDataset(
            args.data_dir, cfg.model.image_size,
            batch_size=min(args.calib_images, 32),
            max_boxes=cfg.data.max_boxes_per_image,
            letterbox=cfg.data.letterbox), args.calib_images)
        print(f"int8 calibration set: {len(calib)} images")
    elif args.qat_steps:
        raise SystemExit("error: --qat-steps needs --calib-images")
    return select_serving_model(cfg, state_dict, mode=args.serving,
                                calib_images=calib, device=args.device,
                                qat_steps=args.qat_steps)


def _labels(path):
    with open(path) as f:
        return [x.strip() for x in f]


def _report(kept, path, cfg):
    """Detections as JSON rows; ``box_cxcywh`` in ratios of the original
    image (the letterbox placement undone)."""
    import numpy as np

    from keras_object_detection_torch.data.reader import (
        read_rgb, unletterbox_detections)

    kept = kept.cpu().numpy()
    if cfg.data.letterbox and len(kept):
        h, w = read_rgb(path).shape[:2]
        kept = unletterbox_detections(kept, h, w, cfg.model.image_size)
    return [{"class": int(b[0]), "confidence": round(float(b[1]), 4),
             "box_cxcywh": [round(float(v), 5) for v in b[2:6]]}
            for b in np.asarray(kept)]


def _tag(args, img, kept, path: str) -> None:
    """Write ``img`` tagged with the detections ``kept`` (JAX CLI's
    ``get_tagged_img`` / ``get_grid_tagged_img``) to ``path``."""
    from keras_object_detection_torch.utils.viz import (get_grid_tagged_img,
                                                        get_tagged_img,
                                                        write_image)

    draw = get_grid_tagged_img if args.grid_overlay else get_tagged_img
    write_image(path, draw(img.copy(), kept.cpu().numpy(), args.names))


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np

    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.data.reader import load_example
    from keras_object_detection_torch.eval import Evaluator, load_serving_state

    cfg_path = os.path.join(args.checkpoint_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"error: {cfg_path} not found (written by cli.train)")
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    overrides = {k: v for k, v in (("nms_mode", args.nms_mode),
                                   ("soft_nms_sigma", args.soft_nms_sigma),
                                   ("tta", args.tta)) if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, **overrides))
    try:
        state, state_dict, info = load_serving_state(
            cfg, args.checkpoint_dir, avg_ckpts=args.avg_ckpts,
            use_ema=args.use_ema, device=args.device)
    except ValueError as exc:
        raise SystemExit(f"error: {exc}")
    print(f"restored checkpoint: {info}")
    size, max_boxes = cfg.model.image_size, cfg.data.max_boxes_per_image

    model, serving = serving_model(args, cfg, state_dict)
    if serving is not None:
        print(f"serving path: {serving}")
    if args.image:
        img = load_example(args.image, size, max_boxes,
                           letterbox=cfg.data.letterbox)[0]
        lat = model.benchmark_latency(img[None], runs=args.latency_runs)
        print(f"forward+decode+NMS: p50 {lat['p50_ms']:.2f} ms (min "
              f"{lat['min_ms']:.2f}, mean {lat['mean_ms']:.2f}, batch 1, "
              f"{args.device})")
        staged = model.benchmark_latency(img[None], runs=args.latency_runs,
                                         staged=True)
        print(f"staged model->decode->NMS: p50 {staged['p50_ms']:.2f} ms "
              f"(each stage synchronised)")
        kept = model.predict_single(img)
        dets = _report(kept, args.image, cfg)
        print(json.dumps({"image": os.path.basename(args.image),
                          "latency_ms": lat, "detections": dets}))
        if args.names:
            _tag(args, img, kept, args.output)
            print(f"wrote {args.output}")

    if args.image_dir:
        paths = sorted(glob.glob(os.path.join(args.image_dir, "*.jpg")))
        if not paths:
            raise SystemExit(f"error: no *.jpg under {args.image_dir}")
        if args.tag_dir:
            os.makedirs(args.tag_dir, exist_ok=True)
        bs = cfg.data.batch_size
        detections = {}
        for start in range(0, len(paths), bs):
            chunk = paths[start:start + bs]
            imgs = np.stack([load_example(p, size, max_boxes,
                                          letterbox=cfg.data.letterbox)[0]
                             for p in chunk])
            boxes, valid = model.predict(imgs)
            for i, path in enumerate(chunk):
                detections[os.path.basename(path)] = _report(
                    boxes[i][valid[i]], path, cfg)
                if args.tag_dir and args.names:
                    _tag(args, imgs[i], boxes[i][valid[i]], os.path.join(
                        args.tag_dir, os.path.basename(path)))
        with open(args.detections_json, "w") as f:
            json.dump(detections, f, indent=1)
        n_det = sum(len(v) for v in detections.values())
        print(f"wrote {args.detections_json}: {n_det} detections over "
              f"{len(paths)} images")

    if args.data_dir:
        ds = YoloDataset(args.data_dir, size, cfg.data.batch_size,
                         max_boxes=max_boxes, cache_dir=args.cache_dir,
                         letterbox=cfg.data.letterbox)
        # --use-ema decides here, as on the single-image path
        mesh = eval_mesh(args)
        evaluator = Evaluator(cfg, use_ema=args.use_ema,
                              device=None if mesh else args.device, mesh=mesh)
        results = evaluator.evaluate(state, ds, coco_map=args.coco_map)
        print("evaluation:", {k: round(float(v), 5) for k, v in results.items()})
        names = _labels(args.names) if args.names else None
        if args.per_class_ap:
            print("per-class AP@%.2f:" % cfg.eval.map_iou_threshold)
            for c, ap in enumerate(evaluator.map_metric.result_per_class()):
                label = names[c] if names and c < len(names) else str(c)
                print(f"  {label:>16s}  {ap:.4f}")
        if args.error_analysis:
            from keras_object_detection_torch.ops.error_analysis import \
                format_error_table

            print(format_error_table(
                evaluator.map_metric.result_error_analysis(), names))
        if args.pr_json:
            curves = evaluator.map_metric.result_pr_curves()
            if names:
                curves = {names[c] if c < len(names) else str(c): v
                          for c, v in curves.items()}
            with open(args.pr_json, "w") as f:
                json.dump(curves, f, indent=1)
            print(f"wrote per-class PR curves to {args.pr_json}")


if __name__ == "__main__":
    main()
