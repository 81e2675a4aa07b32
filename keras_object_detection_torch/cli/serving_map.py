"""The mAP of what is SERVED, end to end on a labelled directory
(counterpart of the repository's ``tools/serving_map.py``, which serves
through the JAX package).

Training's and ``Evaluator``'s mAP reproduce the reference metric (hard
NMS, NMS on the ground truth too). This scores ``predict`` of a serving
configuration instead: ``--tta hflip``, ``--nms-mode soft_*`` / ``fast``,
``--avg-ckpts K``, ``--use-ema``, ``--conf-threshold``, ``--serving int8``
(with ``--calib-images``, ``--bias-correct``, ``--qat-steps``). Ground
truths are matched as they are (no NMS on them).

Usage:
  python -m keras_object_detection_torch.cli.serving_map \\
      --checkpoint-dir ckpt --data val/ --tta hflip --avg-ckpts 3

Prints one JSON line: ``serving_mAP``, ``images``, ``map_iou``, ``serving``,
``tta``, ``nms_mode``, ``conf_threshold``, ``max_candidates``,
``avg_ckpts``, ``use_ema``; with ``--serving int8`` also ``calib_images``,
``bias_correct``, ``qat_steps``; with ``--latency`` for each batch b
``fused_p50_ms_b{b}``, ``fused_min_ms_b{b}`` and ``fused_device_ms_b{b}``
(32 calls issued back to back, one synchronise: the per-call time without
the host's wait). Runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--data", required=True, help="YOLO-format labeled dir")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-boxes", type=int, default=32)
    p.add_argument("--tta", choices=("none", "hflip"), default=None)
    p.add_argument("--nms-mode",
                   choices=("hard", "soft_gaussian", "soft_linear", "fast"),
                   default=None)
    p.add_argument("--conf-threshold", type=float, default=None)
    p.add_argument("--map-iou", type=float, default=0.5)
    p.add_argument("--avg-ckpts", type=int, default=0)
    p.add_argument("--use-ema", action="store_true")
    p.add_argument("--serving", choices=("float", "int8"), default="float",
                   help="score the float InferenceModel (default) or the "
                        "int8 serving path (export/int8_serving.py)")
    p.add_argument("--calib-images", type=int, default=0, metavar="N",
                   help="for --serving int8: static activation scales "
                        "calibrated on N images from --data")
    p.add_argument("--bias-correct", action="store_true",
                   help="for --serving int8 with --calib-images: also fold "
                        "the mean per-channel quantization error into biases")
    p.add_argument("--qat-steps", type=int, default=0,
                   help="for --serving int8 with --calib-images: QAT "
                        "steps before freezing")
    p.add_argument("--latency", nargs="?", const="", default=None,
                   metavar="BATCHES",
                   help="also time serving on the same model; bare flag = "
                        "batch 1 and --batch-size, or a comma list")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from keras_object_detection_torch.cli.evaluate import calibration_images
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import (InferenceModel,
                                                   load_serving_state)
    from keras_object_detection_torch.ops.map import mean_average_precision

    with open(os.path.join(args.checkpoint_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    ev = cfg.eval
    if args.tta:
        ev = dataclasses.replace(ev, tta=args.tta)
    if args.nms_mode:
        ev = dataclasses.replace(ev, nms_mode=args.nms_mode)
    if args.conf_threshold is not None:
        ev = dataclasses.replace(ev, conf_threshold=args.conf_threshold)
    cfg = dataclasses.replace(cfg, eval=ev)

    _, state_dict, _ = load_serving_state(
        cfg, args.checkpoint_dir, avg_ckpts=args.avg_ckpts,
        use_ema=args.use_ema, device=args.device)
    ds = YoloDataset(args.data, cfg.model.image_size, args.batch_size,
                     max_boxes=args.max_boxes, shuffle=False,
                     drop_remainder=False, letterbox=cfg.data.letterbox)
    if args.serving == "int8":
        from keras_object_detection_torch.export import Int8InferenceModel

        calib = None
        if args.calib_images:
            calib = calibration_images(ds, args.calib_images)
        elif args.bias_correct or args.qat_steps:
            raise SystemExit("error: --bias-correct/--qat-steps need "
                             "--calib-images")
        model = Int8InferenceModel(
            cfg, state_dict, calib_images=calib,
            bias_correct=args.bias_correct, qat_steps=args.qat_steps,
            device=args.device)
    else:
        model = InferenceModel(cfg, state_dict, device=args.device)
    tb, tv, pb, pv = [], [], [], []
    seen = 0
    for images, boxes, valid in ds.epoch():
        dets, det_valid = model.predict(images)
        real = min(ds.num_examples - seen, images.shape[0])
        seen += real
        # ground truth rows [cls, conf, cx, cy, w, h] from the dataset's
        # [cx, cy, w, h, cls]; the padding images masked out entirely
        gt = np.concatenate(
            [boxes[..., 4:5], np.ones_like(boxes[..., :1]), boxes[..., :4]],
            axis=-1)
        row_ok = np.arange(images.shape[0]) < real
        tb.append(torch.from_numpy(gt))
        tv.append(torch.from_numpy(valid & row_ok[:, None]))
        pb.append(dets.cpu())
        pv.append(det_valid.cpu() & torch.from_numpy(row_ok)[:, None])

    value = float(mean_average_precision(
        torch.cat(tb), torch.cat(tv), torch.cat(pb), torch.cat(pv),
        cfg.grid.num_classes, args.map_iou))
    out = {
        "serving_mAP": round(value, 4),
        "images": ds.num_examples,
        "map_iou": args.map_iou,
        "serving": args.serving,
        "tta": cfg.eval.tta,
        "nms_mode": cfg.eval.nms_mode,
        "conf_threshold": cfg.eval.conf_threshold,
        "max_candidates": cfg.eval.max_candidates,
        "avg_ckpts": args.avg_ckpts,
        "use_ema": bool(args.use_ema),
    }
    if args.serving == "int8":
        out["calib_images"] = int(args.calib_images)
        out["bias_correct"] = bool(args.bias_correct)
        out["qat_steps"] = int(args.qat_steps)
    if args.latency is not None:
        size = cfg.model.image_size
        lat_batches = ([int(x) for x in args.latency.split(",")]
                       if args.latency else [1, args.batch_size])
        for b in lat_batches:
            probe = np.zeros((b, size, size, 3), np.uint8)
            lat = model.benchmark_latency(probe, runs=10, pipeline_k=32)
            out[f"fused_p50_ms_b{b}"] = round(lat["p50_ms"], 3)
            out[f"fused_min_ms_b{b}"] = round(lat["min_ms"], 3)
            out[f"fused_device_ms_b{b}"] = round(
                lat["pipelined_per_call_ms"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
