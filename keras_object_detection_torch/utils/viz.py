"""Tagged images (counterpart of ``keras_object_detection_tpu/utils/viz.py``,
itself the reference's ``get_tagged_img`` / ``get_grid_tagged_img``): green
rectangles and "class, conf" labels; the grid variant adds the S x S
lattice and red centre dots. Drawn with cv2 (imported at the first call),
as the JAX package draws where cv2 is installed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _load_names(names_path: str) -> Sequence[str]:
    with open(names_path, "r") as f:
        return [x.strip() for x in f.readlines()]


def get_tagged_img(img: np.ndarray, boxes, names_path: str) -> np.ndarray:
    """Draw NMS rows ``(N, 6) [cls, conf, cx, cy, w, h]`` (a numpy array or
    a tensor) on an RGB uint8 image."""
    import cv2

    img = np.ascontiguousarray(img)
    height, width = img.shape[0], img.shape[1]
    names = _load_names(names_path)
    for box in np.asarray(boxes):
        cls, conf, x, y, w, h = box[:6]
        xmin = int((x - w / 2) * width)
        ymin = int((y - h / 2) * height)
        xmax = int((x + w / 2) * width)
        ymax = int((y + h / 2) * height)
        label = f"{names[int(cls)]:s}, {conf:.2f}"
        img = cv2.rectangle(img, (xmin, ymin), (xmax, ymax), color=(0, 255, 0))
        img = cv2.putText(img, label, (xmin, ymin + 20),
                          fontFace=cv2.FONT_HERSHEY_PLAIN, fontScale=1,
                          color=(0, 255, 0))
    return img


def get_grid_tagged_img(img: np.ndarray, boxes, names_path: str,
                        grid: int = 7) -> np.ndarray:
    """The tagged image plus the S x S cell lattice and the boxes' centre
    dots (the lattice spaced by the image's size)."""
    import cv2

    img = get_tagged_img(img, boxes, names_path)
    height, width = img.shape[0], img.shape[1]
    for box in np.asarray(boxes):
        cx, cy = int(box[2] * width), int(box[3] * height)
        img = cv2.circle(img, (cx, cy), radius=2, color=(0, 0, 255))
    for idx in range(grid - 1):
        a = int(width * ((idx + 1) / float(grid)))
        b = int(height * ((idx + 1) / float(grid)))
        img = cv2.line(img, (a, 0), (a, height), color=(255, 0, 255))
        img = cv2.line(img, (0, b), (width, b), color=(255, 0, 255))
    return img


def write_image(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 image (cv2 takes BGR)."""
    import cv2

    cv2.imwrite(path, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
