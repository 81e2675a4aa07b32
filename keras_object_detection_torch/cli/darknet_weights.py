"""Export a trained checkpoint's backbone as an original darknet
``.weights`` file (``models/darknet_import.py``), or inspect a weights file
(counterpart of the repository's ``tools/darknet_weights.py``).

The import direction needs no command: ``cli.train --pretrained-backbone
darknet53.conv.74`` (or ``ModelConfig.pretrained_backbone``) loads a darknet
file into any darknet backbone.

Usage:
  python -m keras_object_detection_torch.cli.darknet_weights export \\
      --checkpoint run/ckpt --out backbone.weights [--num-convs 74] [--ema]
  python -m keras_object_detection_torch.cli.darknet_weights inspect \\
      --weights darknet53.conv.74 [--backbone darknet53]

``export`` reads ``config.json`` and the best checkpoint of ``--checkpoint``
on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import os
import struct


def cmd_export(args) -> dict:
    from keras_object_detection_torch.config import Config
    from keras_object_detection_torch.eval import load_serving_state
    from keras_object_detection_torch.models.darknet_import import \
        save_darknet_backbone

    with open(os.path.join(args.checkpoint, "config.json")) as f:
        cfg = Config.from_json(f.read())
    state, state_dict, info = load_serving_state(
        cfg, args.checkpoint, use_ema=args.ema, device=args.device)
    out = save_darknet_backbone(state_dict, args.out,
                                num_convs=args.num_convs, seen=int(state.step))
    print(f"wrote {args.out}: {out['saved_convs']} convs, "
          f"{out['bytes']} bytes (from {info})")
    return out


def backbone_convs(architecture):
    """``(kernel, in, out)`` of each conv of an architecture table, in the
    order ``DarknetBackbone`` builds (and darknet stores) them."""
    cin = 3
    for e in architecture:
        if isinstance(e, str):
            continue
        if len(e) == 4 and all(isinstance(v, int) for v in e):
            yield e[0], cin, e[1]
            cin = e[1]
        elif e[0] == "R":
            for _ in range(e[2]):
                yield 1, cin, e[1] // 2
                yield 3, e[1] // 2, e[1]
        else:
            for _ in range(e[2]):
                yield e[0][0], cin, e[0][1]
                yield e[1][0], e[0][1], e[1][1]
                cin = e[1][1]


def cmd_inspect(args) -> None:
    with open(args.weights, "rb") as f:
        buf = f.read()
    major, minor, revision = struct.unpack_from("<3i", buf, 0)
    if major * 10 + minor >= 2:
        (seen,) = struct.unpack_from("<q", buf, 12)
        body = len(buf) - 20
    else:
        (seen,) = struct.unpack_from("<i", buf, 12)
        body = len(buf) - 16
    print(f"version {major}.{minor}.{revision}, seen {seen}, "
          f"{body // 4} float32 values ({body} payload bytes)")
    if not args.backbone:
        return
    from keras_object_detection_torch.models.darknet import ARCHITECTURES

    # each conv's floats: beta, gamma, mean, var and the kernel
    total = 0
    for i, (k, cin, cout) in enumerate(
            backbone_convs(ARCHITECTURES[args.backbone])):
        total += 4 * cout + k * k * cin * cout
        mark = " <-- file ends here" if total * 4 == body else ""
        print(f"  conv {i}: {k}x{k} {cin}->{cout} "
              f"(cum {total * 4} bytes){mark}")
    print(f"{args.backbone} full backbone = {total * 4} bytes; "
          f"file payload = {body} bytes "
          f"({'match' if total * 4 == body else 'prefix/partial'})")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("export", help="checkpoint backbone -> .weights")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--num-convs", type=int, default=None,
                   help="write only the first N convs (.conv.NN style)")
    e.add_argument("--ema", action="store_true",
                   help="export the EMA weights")
    e.add_argument("--device", default="cuda",
                   help="torch device the checkpoint is read onto (default "
                        "cuda; cpu to run on the CPU)")
    e.set_defaults(fn=cmd_export)
    i = sub.add_parser("inspect", help="print the header / layout of a file")
    i.add_argument("--weights", required=True)
    i.add_argument("--backbone", default=None,
                   help="map the byte count onto an architecture table "
                        "(darknet19, darknet53, ...)")
    i.set_defaults(fn=cmd_inspect)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
