"""ctypes binding to the repository's C++ JPEG loader, ``native/kot_loader.cpp``
(counterpart of ``keras_object_detection_tpu/data/native.py``): libjpeg
decode with a fused bilinear resize, one file or a batch on its thread pool.

The tracked ``native/libkot_loader.so`` is loaded when it loads (it links
the system's ``libjpeg.so.62``). Otherwise the source is built once with
``g++`` into ``build/native/`` (listed in ``.gitignore``); ``native/`` is
never written. When neither works, ``available()`` is False and
``unavailable_reason()`` says why; ``data.reader`` then decodes with cv2 or
raises, naming both.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "kot_loader.cpp"
TRACKED = ROOT / "native" / "libkot_loader.so"
BUILT = ROOT / "build" / "native" / "libkot_loader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why the loader is unavailable, once known


def _build() -> pathlib.Path:
    BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = BUILT.with_suffix(".tmp")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared", str(SOURCE),
                    "-o", str(tmp), "-ljpeg", "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    tmp.replace(BUILT)
    return BUILT


def _open() -> ctypes.CDLL:
    errors = []
    for path in (TRACKED, BUILT):
        if path.exists():
            try:
                return ctypes.CDLL(str(path))
            except OSError as exc:
                errors.append(f"{path}: {exc}")
    try:
        return ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError) as exc:
        errors.append(f"building {SOURCE}: {exc}")
    raise OSError("; ".join(errors))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = _open()
        except OSError as exc:
            _reason = str(exc)
            return None
        lib.kot_decode_resize_file.restype = ctypes.c_int
        lib.kot_decode_resize_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.kot_load_batch.restype = ctypes.c_int
        lib.kot_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """None when the loader loads, else what failed."""
    _load()
    return _reason


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_reason}")
    return lib


def decode_resize_file(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Decode and resize one JPEG to ``(out_h, out_w, 3)`` RGB uint8."""
    lib = _lib_or_raise()
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.kot_decode_resize_file(
        path.encode(), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path!r}")
    return out


def load_batch(paths: List[str], out_h: int, out_w: int,
               n_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch of JPEG files in parallel on the C++ thread pool:
    ``(images (N, out_h, out_w, 3) uint8, ok (N,) bool)``."""
    lib = _lib_or_raise()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.kot_load_batch(
        names, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    return out, status == 0
