"""The dataset's visual self-test (counterpart of the repository's
``tools/visualize_dataset.py``, itself the reference's ``dataset.py``
``__main__``, non-interactive): encode each image's labels to the S x S
grid, decode them and run NMS (the NMS kernel on a CUDA device, its plain
version on the CPU), and write the tagged and grid-tagged images. What
comes back is the labels the grid holds, so the images show the label
encoder at work.

Usage:
  python -m keras_object_detection_torch.cli.visualize_dataset \\
      --data-dir data/ --names data/test.names --out-dir viz/ [--augment]

``--augment`` runs the train-time augmentation first, with draws from a
generator seeded with the image's index. Runs on ``--device`` (default
cuda).
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, NamedTuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--names", required=True)
    p.add_argument("--out-dir", default="viz_out")
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--letterbox", action="store_true",
                   help="decode with the aspect-preserving letterbox path "
                        "(to match a letterbox-trained config)")
    p.add_argument("--augment", action="store_true",
                   help="run the train-time augmentation first")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


class RoundTrip(NamedTuple):
    """One image: its path, the RGB u8 image and ``(max_boxes, 5)`` labels
    with their mask (after augmentation, with ``--augment``), and the rows
    NMS kept, ``(K, 6) [class, conf, cx, cy, w, h]``."""

    path: str
    image: np.ndarray
    boxes: np.ndarray
    valid: np.ndarray
    kept: np.ndarray


def round_trips(args) -> Iterator[RoundTrip]:
    """encode -> decode -> NMS for each of the first ``--limit`` images."""
    import torch

    from keras_object_detection_torch.core.grid import decode_grid, encode_grid
    from keras_object_detection_torch.data.augment import (
        augment_batch, sample_augment_draws)
    from keras_object_detection_torch.data.reader import (list_examples,
                                                          load_example)
    from keras_object_detection_torch.ops.cuda_nms import \
        auto_batched_non_max_suppression

    dev = torch.device(args.device)
    for n, path in enumerate(list_examples(args.data_dir)[: args.limit]):
        img, boxes, valid = load_example(path, args.image_size, 64,
                                         letterbox=args.letterbox)
        tboxes = torch.from_numpy(boxes[None]).to(dev)
        tvalid = torch.from_numpy(valid[None]).to(dev)
        if args.augment:
            draws = sample_augment_draws(
                1, torch.Generator().manual_seed(n)).to(dev)
            aimg, tboxes, tvalid = augment_batch(
                torch.from_numpy(img[None]).to(dev), tboxes, tvalid, draws)
            img = (aimg[0].cpu().numpy() * 255).astype(np.uint8)
        grid = encode_grid(tboxes, tvalid, args.num_classes)
        rows, keep = auto_batched_non_max_suppression(
            decode_grid(grid, args.num_classes))
        yield RoundTrip(path, img, tboxes[0].cpu().numpy(),
                        tvalid[0].cpu().numpy(),
                        rows[0][keep[0]].cpu().numpy())


def main(argv=None) -> list:
    """Write ``<stem>_tagged.jpg`` and ``<stem>_grid.jpg`` for each image;
    returns the ``RoundTrip`` list."""
    from keras_object_detection_torch.utils.viz import (get_grid_tagged_img,
                                                        get_tagged_img,
                                                        write_image)

    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    done = []
    for rt in round_trips(args):
        base = os.path.splitext(os.path.basename(rt.path))[0]
        write_image(os.path.join(args.out_dir, f"{base}_tagged.jpg"),
                    get_tagged_img(rt.image.copy(), rt.kept, args.names))
        write_image(os.path.join(args.out_dir, f"{base}_grid.jpg"),
                    get_grid_tagged_img(rt.image.copy(), rt.kept, args.names))
        print(f"{base}: {len(rt.kept)} boxes round-tripped")
        done.append(rt)
    print(f"wrote {2 * len(done)} images to {args.out_dir}")
    return done


if __name__ == "__main__":
    main()
