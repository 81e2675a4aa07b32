"""The serving path (counterpart of
``keras_object_detection_tpu/eval/evaluator.py`` ``InferenceModel``):
uint8 NHWC images -> /255 -> ``YoloV1`` -> ``decode_grid`` ->
``auto_batched_non_max_suppression``, which on the GPU is the hand-written
NMS kernel.

Soft/fast NMS, the staged latency variant (ROADMAP 1.13) and mesh serving
(ROADMAP 1.15) are not ported yet and raise.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.core.grid import decode_grid
from keras_object_detection_torch.data.augment import preprocess_eval_batch
from keras_object_detection_torch.models.yolo import build_model
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression

Images = Union[np.ndarray, torch.Tensor]


class InferenceModel:
    """Forward + decode (+ NMS) serving.

    ``device=None`` means ``"cuda"`` and raises when no GPU is present; only
    an explicit ``device="cpu"`` serves on the CPU (with the plain NMS).
    Results are tensors on ``device``: ``predict_raw`` the ``(B, S, S,
    C + 5B)`` grids, ``predict_decoded`` the ``(B, N, 6)`` candidates
    (N = S*S, or 2*S*S with ``tta="hflip"``), ``predict`` the NMS rows and
    survivor mask.
    """

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        e = config.eval
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet "
                                      "(ROADMAP 1.15)")
        if e.nms_mode != "hard":
            raise NotImplementedError(f"nms_mode {e.nms_mode!r} is not ported "
                                      "yet (ROADMAP 1.13)")
        if e.tta not in ("none", "hflip"):
            raise ValueError(f"unknown EvalConfig.tta {e.tta!r} "
                             "(expected 'none' or 'hflip')")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InferenceModel serves on the GPU by default and "
                               "none is available; pass device='cpu' to serve "
                               "on the CPU")
        self.config = config
        model = build_model(config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last)

    def _images(self, images_u8: Images) -> torch.Tensor:
        return torch.as_tensor(images_u8).to(self.device)

    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        return self.model(preprocess_eval_batch(images_u8))

    def _decode(self, grid: torch.Tensor) -> torch.Tensor:
        g = self.config.grid
        return decode_grid(grid, g.num_classes, g.num_boxes, g.grid)

    @torch.inference_mode()
    def predict_raw(self, images_u8: Images) -> torch.Tensor:
        return self._forward(self._images(images_u8))

    @torch.inference_mode()
    def predict_decoded(self, images_u8: Images) -> torch.Tensor:
        x = self._images(images_u8)
        boxes = self._decode(self._forward(x))
        if self.config.eval.tta == "hflip":
            # the mirror's detections, un-flipped (cx -> 1 - cx), join the
            # candidates: NMS merges 2*S*S rows
            fb = self._decode(self._forward(x.flip(2)))
            fb[..., 2] = 1.0 - fb[..., 2]
            boxes = torch.cat([boxes, fb], dim=1)
        return boxes

    @torch.inference_mode()
    def predict(self, images_u8: Images) -> Tuple[torch.Tensor, torch.Tensor]:
        e = self.config.eval
        return auto_batched_non_max_suppression(
            self.predict_decoded(images_u8), e.iou_threshold,
            e.conf_threshold, e.max_candidates)

    def predict_single(self, image_u8: Images) -> torch.Tensor:
        """One image -> ``(num_kept, 6)`` rows, the reference's NMS output."""
        boxes, valid = self.predict(torch.as_tensor(image_u8)[None])
        return boxes[0][valid[0]]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark_latency(self, images_u8: Images, runs: int = 5,
                          staged: bool = False,
                          pipeline_k: int = 0) -> Dict[str, float]:
        """Timed ``predict`` calls on device-resident images: p50 / min /
        mean milliseconds, each call ended by a device synchronise.
        ``pipeline_k > 0`` adds ``pipelined_per_call_ms``: K calls issued
        back to back, one synchronise."""
        if staged:
            raise NotImplementedError("staged latency is not ported yet "
                                      "(ROADMAP 1.13)")
        x = self._images(images_u8)
        self.predict(x)  # warm-up: kernel build, cuDNN plans
        self._sync()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            self.predict(x)
            self._sync()
            times.append((time.perf_counter() - t0) * 1000)
        times.sort()
        out = {"p50_ms": times[len(times) // 2], "min_ms": times[0],
               "mean_ms": sum(times) / len(times), "batch": int(x.shape[0])}
        if pipeline_k:
            t0 = time.perf_counter()
            for _ in range(pipeline_k):
                self.predict(x)
            self._sync()
            out["pipelined_per_call_ms"] = (
                (time.perf_counter() - t0) * 1000 / pipeline_k)
        return out
