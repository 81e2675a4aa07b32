"""Batched class-aware NMS on the GPU: the wrapper of the hand-written
Hopper kernel ``ops/csrc/nms.cu`` (which replaces
``keras_object_detection_tpu/ops/pallas_nms.py:_nms_kernel``) and the
serving path's router ``auto_batched_non_max_suppression``.

The kernel's output is bit-equal to ``ops.nms.batched_non_max_suppression``
on the same CUDA input (see the note in the source). ``LAUNCHES`` counts the
kernel launches, so a run can show that its NMS went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from keras_object_detection_torch.ops.nms import (batched_non_max_suppression,
                                                  top_k_candidates)

# Largest candidate count per image the kernel takes (its shared-memory
# bitmask is N * N / 8 bytes: 128 KB at 1024).
MAX_N = 1024

LAUNCHES = 0


@functools.cache
def _library() -> ctypes.CDLL:
    from keras_object_detection_torch.ops._build import load_library

    lib = load_library("nms")
    lib.kot_nms.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_float,
                            ctypes.c_float, ctypes.c_void_p]
    lib.kot_nms.restype = ctypes.c_int
    for fn in (lib.kot_nms_cluster_size, lib.kot_nms_threads,
               lib.kot_nms_smem_bytes):
        fn.argtypes = [ctypes.c_int]
    lib.kot_nms_error_string.argtypes = [ctypes.c_int]
    lib.kot_nms_error_string.restype = ctypes.c_char_p
    if lib.kot_nms_max_n() != MAX_N:
        raise RuntimeError(f"nms.cu caps N at {lib.kot_nms_max_n()}, "
                           f"cuda_nms.MAX_N is {MAX_N}")
    return lib


def kernel_shape(n: int) -> dict:
    """The kernel's launch for ``n`` rows an image: CTAs per image (one
    thread-block cluster), threads and dynamic shared-memory bytes per CTA."""
    lib = _library()
    return {"cluster": lib.kot_nms_cluster_size(n),
            "threads": lib.kot_nms_threads(n),
            "smem_bytes": lib.kot_nms_smem_bytes(n)}


def cuda_batched_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: ``(B, N, 6)`` contiguous float32 CUDA rows ->
    ``((B, N, 6), (B, N) bool)``, launched on the current stream."""
    global LAUNCHES
    if not boxes.is_cuda:
        raise ValueError(f"the NMS kernel takes a CUDA tensor, got {boxes.device}")
    if boxes.dtype != torch.float32:
        raise ValueError(f"the NMS kernel takes float32, got {boxes.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 6:
        raise ValueError(f"the NMS kernel takes (B, N, 6), got {tuple(boxes.shape)}")
    if not boxes.is_contiguous():
        raise ValueError("the NMS kernel takes a contiguous tensor")
    b, n, _ = boxes.shape
    if n > MAX_N:
        raise ValueError(f"N={n} exceeds the NMS kernel's cap of {MAX_N}; "
                         f"set EvalConfig.max_candidates <= {MAX_N}")
    out_rows = torch.empty_like(boxes)
    out_valid = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b == 0 or n == 0:
        return out_rows, out_valid
    lib = _library()
    args = (boxes.data_ptr(), out_rows.data_ptr(), out_valid.data_ptr(), b, n,
            float(iou_threshold), float(conf_threshold))
    # the raw stream handle: torch.cuda.current_stream() builds an object
    index = boxes.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = lib.kot_nms(*args, stream)
    else:
        with torch.cuda.device(boxes.device):
            err = lib.kot_nms(*args, stream)
    if err:
        raise RuntimeError("NMS kernel launch failed: "
                           + lib.kot_nms_error_string(err).decode())
    LAUNCHES += 1
    return out_rows, out_valid


def auto_batched_non_max_suppression(
    boxes: torch.Tensor,
    iou_threshold: float = 0.5,
    conf_threshold: float = 0.4,
    max_candidates: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving path's NMS (counterpart of ``pallas_nms.py``'s router):
    with ``max_candidates`` set, cut oversized candidate sets to the top-K
    by confidence; then a CUDA tensor goes to the kernel and a CPU tensor to
    the plain version. There is no fallback: the kernel raises on what it
    does not take, such as N above ``MAX_N``."""
    if max_candidates and boxes.shape[1] > max_candidates:
        boxes = top_k_candidates(boxes, int(max_candidates))
    if boxes.is_cuda:
        return cuda_batched_non_max_suppression(boxes, iou_threshold,
                                                conf_threshold)
    if boxes.device.type == "cpu":
        return batched_non_max_suppression(boxes, iou_threshold, conf_threshold)
    raise ValueError(f"no NMS for device {boxes.device}")
