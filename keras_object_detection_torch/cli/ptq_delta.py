"""The int8 post-training-quantization mAP delta of a trained checkpoint
(counterpart of the repository's ``tools/ptq_delta.py``, which measures the
JAX package).

Each arm is scored against the float baseline on the same validation set:
- weight-only int8 (``export/quantize.py``): per-channel symmetric int8
  weights, dequantized for the forward;
- with ``--int8-serving``, true int8 serving (``export/int8_serving.py``:
  BN folded, s8 x s8 -> s32 convs), and with ``--calibrate N`` also static
  activation scales calibrated on N validation images, dynamic scales
  with bias correction, static with bias correction, and with ``--qat
  STEPS`` after a QAT fine-tune;
- the LiteRT full-int8 arm is skipped, as JAX's ``--skip-litert`` skips
  it: no torch -> LiteRT converter is installed (``export/litert.py``).

Usage:
  python -m keras_object_detection_torch.cli.ptq_delta --workdir run/ \\
      --data val/ --int8-serving --calibrate 32 --qat 20

``--workdir`` holds ``ckpt/`` (with ``config.json``). Writes
``<workdir>/ptq_delta.json`` and prints ``RESULTS`` and the JSON, with JAX's
keys (``jax_int8_*`` are the weight-only arm's, named as JAX names them).
Runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True,
                   help="run dir containing ckpt/ (with config.json)")
    p.add_argument("--data", required=True, help="validation YOLO-format dir")
    p.add_argument("--skip-litert", action="store_true",
                   help="skip the LiteRT arm (always skipped: no torch -> "
                        "LiteRT converter is installed)")
    p.add_argument("--int8-serving", action="store_true",
                   help="also evaluate the true int8 serving path")
    p.add_argument("--int8-float-tail", type=int, default=0,
                   help="keep the LAST N folded convs in f32")
    p.add_argument("--calibrate", type=int, default=0,
                   help="for --int8-serving: ALSO evaluate with static "
                        "activation scales calibrated on this many "
                        "validation images, and the bias-corrected arms")
    p.add_argument("--qat", type=int, default=0, metavar="STEPS",
                   help="with --calibrate: ALSO evaluate after a QAT "
                        "fine-tune of this many steps")
    p.add_argument("--qat-lr", type=float, default=1e-5)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    args = p.parse_args(argv)
    if args.qat and not args.calibrate:
        p.error("--qat needs --calibrate N (the QAT arm fine-tunes on the "
                "calibration images)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from keras_object_detection_torch.cli.evaluate import calibration_images
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.core.grid import encode_grid
    from keras_object_detection_torch.data import YoloDataset
    from keras_object_detection_torch.eval import (Evaluator,
                                                   load_serving_state)
    from keras_object_detection_torch.export import Int8InferenceModel
    from keras_object_detection_torch.export.quantize import (
        dequantize_params, quantize_params, quantized_size_bytes)
    from keras_object_detection_torch.ops.map import MeanAveragePrecision

    ckpt_dir = os.path.join(args.workdir, "ckpt")
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    state, state_dict, info = load_serving_state(cfg, ckpt_dir,
                                                 device=args.device)
    print(f"restored checkpoint: {info}")
    # quantize what is served: with EMA evaluation, the EMA weights, so
    # that the float and int8 arms compare the same weights
    if (cfg.train.ema_decay is not None and cfg.train.eval_with_ema
            and state.ema is not None):
        print("serving params: EMA")
        state.model.load_state_dict({**state_dict, **state.ema})
        state_dict = dict(state.model.state_dict())

    g, e = cfg.grid, cfg.eval
    ds = YoloDataset(args.data, cfg.model.image_size, cfg.data.batch_size,
                     max_boxes=cfg.data.max_boxes_per_image)
    evaluator = Evaluator(cfg, use_ema=False, device=args.device)

    # --- float baseline ---------------------------------------------------
    float_eval = evaluator.evaluate(state, ds)
    print(f"float:     mAP {float_eval['mAP']:.4f}")

    # --- weight-only int8 -------------------------------------------------
    names = {n for n, _ in state.model.named_parameters()}
    qparams = quantize_params({k: v for k, v in state_dict.items()
                               if k in names})
    qbytes, fbytes = quantized_size_bytes(qparams)
    state.model.load_state_dict({**state_dict,
                                 **dequantize_params(qparams)})
    int8_eval = evaluator.evaluate(state, ds)
    state.model.load_state_dict(state_dict)
    print(f"weight-only int8:  mAP {int8_eval['mAP']:.4f} "
          f"(weights {qbytes / 1e6:.1f} MB vs {fbytes / 1e6:.1f} MB f32)")

    # --- true int8 serving ------------------------------------------------
    int8_serving_results = {}
    if args.int8_serving:
        def eval_int8(calib_images=None, **int8_kw):
            im = Int8InferenceModel(cfg, state_dict,
                                    float_tail=args.int8_float_tail,
                                    calib_images=calib_images,
                                    device=args.device, **int8_kw)
            metric = MeanAveragePrecision(
                g.num_classes, g.num_boxes, g.grid,
                iou_threshold=e.iou_threshold,
                conf_threshold=e.conf_threshold,
                map_iou_threshold=e.map_iou_threshold)
            for bi, (images, boxes, valid) in enumerate(ds.epoch()):
                # the zero images that pad the last batch are not scored
                real = min(len(images), ds.num_examples - bi * ds.batch_size)
                boxes = torch.from_numpy(boxes[:real]).to(im.device)
                valid = torch.from_numpy(valid[:real]).to(im.device)
                y_true = encode_grid(boxes, valid, g.num_classes,
                                     g.num_boxes, g.grid)
                metric.update_state(y_true, im.predict_raw(images[:real]))
            return metric.result(), im.memory_footprint()

        serving_map, fp = eval_int8()
        print(f"int8 serving: mAP {serving_map:.4f} "
              f"(weights {fp['quantized_bytes'] / 1e6:.1f} MB vs "
              f"{fp['float_bytes'] / 1e6:.1f} MB f32)")
        int8_serving_results = {
            "int8_serving_mAP": float(serving_map),
            "int8_serving_delta": float(serving_map - float_eval["mAP"]),
            "int8_serving_weight_mb": fp["quantized_bytes"] / 1e6,
            "int8_serving_float_tail": args.int8_float_tail,
        }
        if args.calibrate:
            calib = calibration_images(ds, args.calibrate)
            cal_map, _ = eval_int8(calib_images=calib)
            print(f"int8 serving (static calib on {len(calib)}): "
                  f"mAP {cal_map:.4f}")
            bc_dyn_map, _ = eval_int8(calib_images=calib, bias_correct=True,
                                      act_quant="dynamic")
            print(f"int8 serving (dynamic + bias-correct): "
                  f"mAP {bc_dyn_map:.4f}")
            bc_map, _ = eval_int8(calib_images=calib, bias_correct=True)
            print(f"int8 serving (static calib + bias-correct): "
                  f"mAP {bc_map:.4f}")
            int8_serving_results.update(
                int8_calibrated_mAP=float(cal_map),
                int8_calibrated_delta=float(cal_map - float_eval["mAP"]),
                int8_bias_corrected_dynamic_mAP=float(bc_dyn_map),
                int8_bias_corrected_dynamic_delta=float(
                    bc_dyn_map - float_eval["mAP"]),
                int8_bias_corrected_mAP=float(bc_map),
                int8_bias_corrected_delta=float(bc_map - float_eval["mAP"]),
                int8_calibration_images=int(len(calib)),
            )
            if args.qat:
                qat_map, _ = eval_int8(calib_images=calib,
                                       qat_steps=args.qat,
                                       qat_lr=args.qat_lr)
                print(f"int8 serving (static calib + QAT {args.qat} "
                      f"steps): mAP {qat_map:.4f}")
                int8_serving_results.update(
                    int8_qat_mAP=float(qat_map),
                    int8_qat_delta=float(qat_map - float_eval["mAP"]),
                    int8_qat_steps=int(args.qat),
                )

    results = {
        "float_mAP": float(float_eval["mAP"]),
        **int8_serving_results,
        "float_loss": float(float_eval["loss"]),
        "jax_int8_mAP": float(int8_eval["mAP"]),
        "jax_int8_delta": float(int8_eval["mAP"] - float_eval["mAP"]),
        "jax_int8_weight_mb": qbytes / 1e6,
        "float_weight_mb": fbytes / 1e6,
        "val_images": ds.num_examples,
    }
    # --- LiteRT full-int8 PTQ: not available (module docstring) -------------
    print("litert int8: skipped (no torch -> LiteRT converter is installed; "
          "export/litert.py)")
    with open(os.path.join(args.workdir, "ptq_delta.json"), "w") as f:
        json.dump(results, f, indent=2)
    print("RESULTS", json.dumps(results))
    return results


if __name__ == "__main__":
    main()
