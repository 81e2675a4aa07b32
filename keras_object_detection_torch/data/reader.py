"""Host-side reading of a YOLO-format directory (counterpart of
``keras_object_detection_tpu/data/reader.py``): a directory of ``*.jpg``
files, each with a sibling ``*.txt`` of ``class_id cx cy w h`` rows in image
ratios. The host only decodes JPEGs and parses labels into padded arrays;
augmentation and grid encoding run on the device.

Decoding follows the JAX package's order: cv2 (whose resize the reference
uses) unless ``KOT_NATIVE=1`` selects the C++ loader (``data/native.py``);
without cv2, the C++ loader. With neither, ``load_example`` raises and names
what is missing. The letterbox path always decodes with cv2.
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from keras_object_detection_torch.data import native


def _cv2():
    """cv2, or None when it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    cv2.setNumThreads(0)
    return cv2


def _need_cv2(what: str):
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError(f"{what} needs cv2 (opencv-python), which does not "
                           "import here")
    return cv2


def list_examples(data_dir: str) -> List[str]:
    """Sorted ``*.jpg`` paths in ``data_dir``."""
    return sorted(glob.glob(os.path.join(data_dir, "*.jpg")))


def read_yolo_labels(label_path: str) -> np.ndarray:
    """Parse a YOLO txt into ``(N, 5)`` rows of ``[cx, cy, w, h, class_id]``."""
    rows = []
    with open(label_path, "r") as f:
        for line in f.read().splitlines():
            if not line.strip():
                continue
            class_id, cx, cy, w, h = map(float, line.split(" "))
            rows.append([cx, cy, w, h, class_id])
    if not rows:
        return np.zeros((0, 5), np.float32)
    return np.asarray(rows, np.float32)


LETTERBOX_PAD = 114  # the conventional detection gray fill


def letterbox_geometry(h: int, w: int, image_size: int):
    """``(new_h, new_w, pad_y, pad_x)`` of an (h, w) image placed, aspect
    kept, centred in an ``image_size`` square (left/top pads floor)."""
    scale = image_size / max(h, w)
    nh = max(1, round(h * scale))
    nw = max(1, round(w * scale))
    return nh, nw, (image_size - nh) // 2, (image_size - nw) // 2


def letterbox_image(img: np.ndarray, image_size: int) -> np.ndarray:
    """Aspect-preserving resize and centred gray padding to a square."""
    cv2 = _need_cv2("letterbox_image")
    nh, nw, py, px = letterbox_geometry(img.shape[0], img.shape[1], image_size)
    out = np.full((image_size, image_size, 3), LETTERBOX_PAD, np.uint8)
    out[py:py + nh, px:px + nw] = cv2.resize(img, (nw, nh))
    return out


def letterbox_boxes(boxes: np.ndarray, h: int, w: int,
                    image_size: int) -> np.ndarray:
    """``(N, 5) [cx, cy, w, h, cls]`` boxes in ratios of the original (h, w)
    image -> ratios of the letterboxed square."""
    nh, nw, py, px = letterbox_geometry(h, w, image_size)
    out = boxes.copy()
    out[:, 0] = (boxes[:, 0] * nw + px) / image_size
    out[:, 1] = (boxes[:, 1] * nh + py) / image_size
    out[:, 2] = boxes[:, 2] * nw / image_size
    out[:, 3] = boxes[:, 3] * nh / image_size
    return out


def unletterbox_detections(dets: np.ndarray, h: int, w: int,
                           image_size: int) -> np.ndarray:
    """``(N, 6) [cls, conf, cx, cy, w, h]`` detections in letterboxed ratios
    -> ratios of the original (h, w) image."""
    nh, nw, py, px = letterbox_geometry(h, w, image_size)
    out = dets.copy()
    out[:, 2] = (dets[:, 2] * image_size - px) / nw
    out[:, 3] = (dets[:, 3] * image_size - py) / nh
    out[:, 4] = dets[:, 4] * image_size / nw
    out[:, 5] = dets[:, 5] * image_size / nh
    return out


def read_rgb(img_path: str) -> np.ndarray:
    """The whole image, RGB uint8 ``(H, W, 3)``, decoded by cv2."""
    cv2 = _need_cv2("decoding at the original size")
    img = cv2.imread(img_path)
    if img is None:
        raise IOError(f"cv2 could not decode {img_path!r}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def decode_resized(img_path: str, image_size: int) -> np.ndarray:
    """One JPEG decoded and resized (square, bilinear) to ``image_size``,
    by the decoder the JAX package would pick."""
    cv2 = _cv2()
    use_native = os.environ.get("KOT_NATIVE", "0") == "1" or cv2 is None
    if use_native and native.available():
        return native.decode_resize_file(img_path, image_size, image_size)
    if cv2 is None:
        raise RuntimeError(
            f"no JPEG decoder for {img_path!r}: cv2 does not import and the "
            f"native loader is unavailable ({native.unavailable_reason()})")
    return cv2.resize(read_rgb(img_path), (image_size, image_size))


def load_example(img_path: str, image_size: int, max_boxes: int,
                 letterbox: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode one jpg and its labels to fixed shapes: ``(image_u8 (S, S, 3)
    RGB, boxes (max_boxes, 5), valid (max_boxes,))``. The default resize is
    the reference's square bilinear one (it distorts aspect);
    ``letterbox=True`` keeps the aspect with gray padding and remaps the
    boxes."""
    if letterbox:
        img = read_rgb(img_path)
        h, w = img.shape[:2]
        img = letterbox_image(img, image_size)
    else:
        img = decode_resized(img_path, image_size)
    raw = read_yolo_labels(os.path.splitext(img_path)[0] + ".txt")
    if letterbox and len(raw):
        raw = letterbox_boxes(raw, h, w, image_size)
    n = min(len(raw), max_boxes)
    boxes = np.zeros((max_boxes, 5), np.float32)
    valid = np.zeros((max_boxes,), bool)
    boxes[:n] = raw[:n]
    valid[:n] = True
    return img.astype(np.uint8), boxes, valid
