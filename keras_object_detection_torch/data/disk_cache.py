"""Decode-ahead disk cache: decoded uint8 images and labels in flat memmaps
(counterpart of ``keras_object_detection_tpu/data/disk_cache.py``, with the
same layout and validity key, so a cache built by either package opens in
the other).

Layout under ``cache_dir``:
  meta.json    - {version, image_size, letterbox, max_boxes, count, paths,
                  mtimes}: the validity key, written last
  images.u8    - (N, S, S, 3) uint8
  boxes.f32    - (N, M, 5) float32
  valid.u8     - (N, M) uint8 (bool)
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Tuple

import numpy as np

from keras_object_detection_torch.data.reader import load_example

META_NAME = "meta.json"


def meta_for(paths: List[str], image_size: int, max_boxes: int,
             letterbox: bool = False) -> dict:
    """The validity key of a cache of ``paths``: the files' names and
    modification times, the decode size, the box budget, the letterbox."""
    return {
        "version": 1,
        "image_size": image_size,
        "letterbox": letterbox,
        "max_boxes": max_boxes,
        "count": len(paths),
        "paths": [os.path.basename(p) for p in paths],
        "mtimes": [os.path.getmtime(p) for p in paths],
    }


class DiskCache:
    """Memmapped view of a built cache, index-aligned with its paths."""

    def __init__(self, cache_dir: str, count: int, image_size: int,
                 max_boxes: int):
        s, m = image_size, max_boxes
        self.images = np.memmap(os.path.join(cache_dir, "images.u8"),
                                np.uint8, "r", shape=(count, s, s, 3))
        self.boxes = np.memmap(os.path.join(cache_dir, "boxes.f32"),
                               np.float32, "r", shape=(count, m, 5))
        self.valid = np.memmap(os.path.join(cache_dir, "valid.u8"),
                               np.uint8, "r", shape=(count, m))

    def load(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.asarray(self.images[i]), np.asarray(self.boxes[i]),
                np.asarray(self.valid[i]).astype(bool))


def write(cache_dir: str, paths: List[str], image_size: int, max_boxes: int,
          examples: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
          letterbox: bool = False) -> DiskCache:
    """Write a cache of ``paths`` from ``examples``, one ``(image, boxes,
    valid)`` per path in order, and open it. ``meta.json`` goes last, so a
    write cut short never validates."""
    want = meta_for(paths, image_size, max_boxes, letterbox)
    os.makedirs(cache_dir, exist_ok=True)
    meta_path = os.path.join(cache_dir, META_NAME)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    s, m, n = image_size, max_boxes, len(paths)
    images = np.memmap(os.path.join(cache_dir, "images.u8"), np.uint8, "w+",
                       shape=(n, s, s, 3))
    boxes = np.memmap(os.path.join(cache_dir, "boxes.f32"), np.float32, "w+",
                      shape=(n, m, 5))
    valid = np.memmap(os.path.join(cache_dir, "valid.u8"), np.uint8, "w+",
                      shape=(n, m))
    count = 0
    for i, (img, bx, vl) in enumerate(examples):
        images[i], boxes[i], valid[i] = img, bx, np.asarray(vl, np.uint8)
        count += 1
    if count != n:
        raise ValueError(f"{count} examples for {n} paths")
    images.flush(), boxes.flush(), valid.flush()
    del images, boxes, valid
    with open(meta_path, "w") as f:
        json.dump(want, f)
    return DiskCache(cache_dir, n, image_size, max_boxes)


def open_or_build(paths: List[str], image_size: int, max_boxes: int,
                  cache_dir: str, letterbox: bool = False) -> DiskCache:
    """A valid ``DiskCache`` of ``paths``, (re)built by decoding each file
    when the cache is absent or stale (another size, box budget, file set or
    modification time)."""
    want = meta_for(paths, image_size, max_boxes, letterbox)
    meta_path = os.path.join(cache_dir, META_NAME)
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                have = json.load(f)
        except (ValueError, OSError):
            have = None
        if have == want:
            return DiskCache(cache_dir, len(paths), image_size, max_boxes)
    return write(cache_dir, paths, image_size, max_boxes,
                 (load_example(p, image_size, max_boxes, letterbox=letterbox)
                  for p in paths), letterbox)
