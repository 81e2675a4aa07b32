"""Export a trained detector (counterpart of the repository's
``convert_to_litert.py``): checkpoint -> a ``torch.export`` program
(``.pt2``) of the float32 serving function.

Examples:
  python -m keras_object_detection_torch.cli.export \\
      --checkpoint-dir checkpoints --output model.pt2 --format program
  # time the exported program (batch 1, on --device)
  python -m keras_object_detection_torch.cli.export \\
      --checkpoint-dir checkpoints --output model.pt2 --format program --bench

``--format tflite`` (the JAX CLI's default, with ``--int8`` and
``--calib-dir``) raises ``NotImplementedError``: no torch -> LiteRT
converter is installed (``export/litert.py``). Reads ``config.json`` from
the checkpoint directory (written by ``cli.train``) and exports the best
checkpoint. Runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--format", choices=["tflite", "program"], default="tflite",
                   help="tflite (LiteRT: not available to the port) or "
                        "program (torch.export, .pt2)")
    p.add_argument("--int8", action="store_true",
                   help="full-int8 PTQ with a representative dataset "
                        "(tflite only)")
    p.add_argument("--calib-dir",
                   help="YOLO-format dir for int8 calibration images "
                        "(tflite only)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--bench", action="store_true",
                   help="time the exported program's forward")
    p.add_argument("--bench-runs", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to export on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import time

    import numpy as np
    import torch

    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.eval import load_serving_state
    from keras_object_detection_torch.export.litert import (export_program,
                                                            export_tflite,
                                                            load_program)

    cfg_path = os.path.join(args.checkpoint_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise SystemExit(f"error: {cfg_path} not found (written by cli.train)")
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    if args.format == "tflite":  # the gap, before any checkpoint is read
        export_tflite(cfg, {}, args.output, quantize_int8=args.int8,
                      batch_size=args.batch_size)
    state, state_dict, info = load_serving_state(cfg, args.checkpoint_dir,
                                                 device=args.device)
    print(f"restored checkpoint {info}")
    blob = export_program(cfg, state_dict, args.output,
                          batch_size=args.batch_size, device=args.device)
    print(f"wrote {args.output} ({len(blob)} bytes)")
    if args.bench:
        serve = load_program(args.output)
        size = cfg.model.image_size
        dev = torch.device(args.device)
        x = torch.from_numpy(np.random.RandomState(0).rand(
            args.batch_size, size, size, 3).astype(np.float32)).to(dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        with torch.no_grad():
            serve(x)  # warm-up
            sync()
            times = []
            for _ in range(args.bench_runs):
                t0 = time.perf_counter()
                serve(x)
                sync()
                times.append((time.perf_counter() - t0) * 1000)
        times.sort()
        print(f"exported program: p50 {times[len(times) // 2]:.2f} ms (min "
              f"{times[0]:.2f}, batch {args.batch_size}, {args.device})")


if __name__ == "__main__":
    main()
