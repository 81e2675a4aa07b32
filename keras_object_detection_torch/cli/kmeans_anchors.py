"""Fit anchor priors to a labelled dataset with IoU k-means, YOLOv2's
"dimension clusters" (counterpart of the repository's
``tools/kmeans_anchors.py``, which reads labels through the JAX package).
The distance is 1 - IoU of box sizes with the centres aligned, the metric
the anchor assignment uses (``core/anchors.py`` ``_shape_iou``).

Usage:
  python -m keras_object_detection_torch.cli.kmeans_anchors --data train/ --k 5

Prints one JSON line: the anchors sorted by area, the mean best IoU
(``avg_iou``), the box count, k, and the train flags to paste:
  --head anchor --anchors "0.08,0.11;..."
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def shape_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """``(N, 2) x (K, 2) -> (N, K)`` IoU with the centres aligned."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] \
        + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_iou(wh: np.ndarray, k: int, iters: int = 100, seed: int = 0):
    """k-means under 1 - IoU with median centroids (darknet's convention),
    seeded by a random box and then, greedily, the box least like its
    nearest centroid. Returns ``(centroids sorted by area, mean best
    IoU)``."""
    rng = np.random.RandomState(seed)
    centroids = wh[rng.choice(len(wh), 1)]
    while len(centroids) < k:
        best = np.max(shape_iou(wh, centroids), axis=1)
        centroids = np.concatenate([centroids, wh[[np.argmin(best)]]])
    assign = None
    for _ in range(iters):
        new_assign = np.argmax(shape_iou(wh, centroids), axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                centroids[j] = np.median(members, axis=0)
    avg_iou = float(np.max(shape_iou(wh, centroids), axis=1).mean())
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], avg_iou


def label_sizes(data_dir: str) -> np.ndarray:
    """``(N, 2)`` widths and heights of every labelled box under
    ``data_dir`` (YOLO format, the port's reader)."""
    from keras_object_detection_torch.data.reader import (list_examples,
                                                          read_yolo_labels)

    whs = []
    for path in list_examples(data_dir):
        rows = read_yolo_labels(os.path.splitext(path)[0] + ".txt")
        if len(rows):
            whs.append(rows[:, 2:4])
    if not whs:
        raise SystemExit(f"error: no labeled boxes under {data_dir}")
    return np.concatenate(whs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", required=True, help="YOLO-format labelled dir")
    p.add_argument("--k", type=int, default=5,
                   help="number of anchors (YOLOv2 uses 5)")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    wh = label_sizes(args.data)
    if len(wh) < args.k:
        raise SystemExit(f"error: {len(wh)} boxes < k={args.k}")
    anchors, avg_iou = kmeans_iou(wh, args.k, args.iters, args.seed)
    flag = ";".join(f"{w:.4f},{h:.4f}" for w, h in anchors)
    print(json.dumps({
        "anchors": [[round(float(w), 4), round(float(h), 4)]
                    for w, h in anchors],
        "avg_iou": round(avg_iou, 4),
        "boxes": int(len(wh)),
        "k": args.k,
        "train_flag": f'--head anchor --anchors "{flag}"',
    }))


if __name__ == "__main__":
    main()
