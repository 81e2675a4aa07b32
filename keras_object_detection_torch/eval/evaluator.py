"""Serving and evaluation (counterpart of
``keras_object_detection_tpu/eval/evaluator.py`` ``InferenceModel``,
``load_serving_state`` and ``Evaluator``).

``InferenceModel``: uint8 NHWC images -> /255 -> ``YoloV1`` ->
``decode_grid`` (the anchor head: ``decode_anchor_grid``; the FPN head:
``decode_fpn_grids`` over its per-scale grids) -> ``serving_nms``: with
``EvalConfig.nms_mode="hard"`` ``auto_batched_non_max_suppression``, which
cuts candidate sets above ``EvalConfig.max_candidates`` to the top-K and on
the GPU is the hand-written NMS kernel; with ``"fast"``, ``"soft_gaussian"``
or ``"soft_linear"`` the top-K cut, then fast or soft NMS in plain torch.
``Evaluator``: dataset loss and mAP through the eval step
(``train/loop.py``). ``load_serving_state``: the checkpoint a caller serves.

``ServingModel`` is what the float, weight-only int8 and true int8 serving
models (``export/``) share: the decode, TTA, NMS, ``predict*`` and
``benchmark_latency``, and mesh serving (JAX's ``_serving_jit`` over a
mesh, a ``shard_map`` whose batch splits over the data axis and whose
model axis replicates it): with a device ``parallel.Mesh`` one process
keeps a whole replica of the weights on the first device of each data row
(``Mesh.data_devices``: the model axis's other positions would compute the
same rows), each runs the whole forward -> decode -> cut -> NMS on its
contiguous shard of the batch, and the outputs are concatenated in batch
order on the first device. ``Evaluator(mesh=)`` evaluates so too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from keras_object_detection_torch.config import Config, EvalConfig
from keras_object_detection_torch.core.anchors import decode_anchor_grid
from keras_object_detection_torch.core.fpn import decode_fpn_grids
from keras_object_detection_torch.core.grid import decode_grid
from keras_object_detection_torch.data.augment import preprocess_eval_batch
from keras_object_detection_torch.data.pipeline import YoloDataset
from keras_object_detection_torch.models.yolo import build_model
from keras_object_detection_torch.ops.cuda_nms import \
    auto_batched_non_max_suppression
from keras_object_detection_torch.ops.nms import (
    batched_fast_non_max_suppression, batched_soft_non_max_suppression,
    top_k_candidates)
from keras_object_detection_torch.parallel.mesh import map_shards, replicate
from keras_object_detection_torch.train.checkpoint import (CheckpointManager,
                                                           average_checkpoints)
from keras_object_detection_torch.train.loop import (TrainState, _device,
                                                     _map_metric,
                                                     create_train_state,
                                                     make_eval_step,
                                                     run_dataset_eval)

Images = Union[np.ndarray, torch.Tensor]


def serving_nms(boxes: torch.Tensor, e: EvalConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NMS of ``e.nms_mode``: ``"hard"`` through
    ``auto_batched_non_max_suppression`` (the kernel on a CUDA tensor);
    otherwise the top-K cut to ``max_candidates``, then fast NMS, or soft
    NMS with ``soft_nms_sigma`` and the method after ``"soft_"``."""
    if e.nms_mode == "hard":
        return auto_batched_non_max_suppression(
            boxes, e.iou_threshold, e.conf_threshold, e.max_candidates)
    if e.max_candidates and boxes.shape[1] > e.max_candidates:
        boxes = top_k_candidates(boxes, e.max_candidates)
    if e.nms_mode == "fast":
        return batched_fast_non_max_suppression(boxes, e.iou_threshold,
                                                e.conf_threshold)
    return batched_soft_non_max_suppression(
        boxes, e.iou_threshold, e.conf_threshold, e.soft_nms_sigma,
        e.nms_mode.removeprefix("soft_"))


def _unflip(boxes: torch.Tensor) -> torch.Tensor:
    """The mirror's detections in the image's frame: ``cx -> 1 - cx``."""
    boxes[..., 2] = 1.0 - boxes[..., 2]
    return boxes


class ServingModel:
    """Decode (+ TTA) + NMS over a subclass's ``_forward(images_u8)``, which
    maps device-resident uint8 NHWC images to the ``(B, S, S, depth)`` grid
    (the FPN head: a tuple of them, coarse -> fine). Subclasses set
    ``config`` and ``device``.

    Results are tensors on ``device``: ``predict_raw`` the grids,
    ``predict_decoded`` the ``(B, N, 6)`` candidates (N = S*S, S*S*B_anchors
    for the anchor head, the sum over the scales of S_s²*B_s for the FPN
    head, twice that with ``tta="hflip"``), ``predict`` the NMS rows and
    survivor mask (``serving_nms``: N cut to ``max_candidates`` first where
    it is larger). With a mesh (``_shard_over``) each call's batch must
    divide by the data axis and is served shard by shard by the replicas,
    one a device."""

    config: Config
    device: torch.device
    mesh = None
    _replicas: Tuple["ServingModel", ...] = ()

    def _shard_over(self, mesh) -> None:
        """Serve over ``mesh``'s data rows: a replica of this model on each
        row's first device (``parallel.mesh.replicate``; the first is this
        model)."""
        if mesh is not None:
            self._replicas = tuple(replicate(self, mesh.data_devices,
                                             self.device, "device"))
            self.mesh = mesh

    def _served(self, method: str, images_u8: Images):
        """``method`` on the whole batch, or on a mesh each replica's on its
        shard of it, the outputs concatenated in batch order on
        ``device``."""
        if self.mesh is None:
            return getattr(self, method)(images_u8)
        x = torch.as_tensor(images_u8)
        da, dp = self.mesh.data_axis, self.mesh.data_parallel
        if x.shape[0] % dp:
            raise ValueError(
                f"serving batch {x.shape[0]} must divide by the mesh data "
                f"axis {da}={dp} (pad the batch or drop the mesh)")
        return map_shards(lambda rep, xs: getattr(rep, method)(xs),
                          self._replicas, self.device, x)

    def _forward(self, images_u8: torch.Tensor):
        raise NotImplementedError

    def _images(self, images_u8: Images) -> torch.Tensor:
        return torch.as_tensor(images_u8).to(self.device)

    def _decode(self, grid) -> torch.Tensor:
        g = self.config.grid
        if self.config.model.head == "fpn":
            return decode_fpn_grids(grid, g.num_classes, g.anchors, g.grid,
                                    self.config.model.fpn_scales)
        if self.config.model.head == "anchor":
            return decode_anchor_grid(grid, g.num_classes, g.anchors, g.grid)
        return decode_grid(grid, g.num_classes, g.num_boxes, g.grid)

    def _nms(self, boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return serving_nms(boxes, self.config.eval)

    @property
    def _tta(self) -> str:
        return self.config.eval.tta

    @torch.inference_mode()
    def predict_raw(self, images_u8: Images):
        return self._served("_predict_raw", images_u8)

    def _predict_raw(self, images_u8: Images):
        return self._forward(self._images(images_u8))

    @torch.inference_mode()
    def predict_decoded(self, images_u8: Images) -> torch.Tensor:
        return self._served("_predict_decoded", images_u8)

    def _predict_decoded(self, images_u8: Images) -> torch.Tensor:
        x = self._images(images_u8)
        boxes = self._decode(self._forward(x))
        if self._tta == "hflip":
            # the mirror's detections, un-flipped, join the candidates: NMS
            # merges 2*S*S rows
            fb = _unflip(self._decode(self._forward(x.flip(2))))
            boxes = torch.cat([boxes, fb], dim=1)
        return boxes

    @torch.inference_mode()
    def predict(self, images_u8: Images) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._served("_predict", images_u8)

    def _predict(self, images_u8: Images) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._nms(self._predict_decoded(images_u8))

    def predict_single(self, image_u8: Images) -> torch.Tensor:
        """One image -> ``(num_kept, 6)`` rows, the reference's NMS output."""
        boxes, valid = self.predict(torch.as_tensor(image_u8)[None])
        return boxes[0][valid[0]]

    def _sync(self) -> None:
        for dev in {self.device, *(r.device for r in self._replicas)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @torch.inference_mode()
    def _staged(self, x: torch.Tensor):
        """``predict`` as stages, each one's result complete on the device
        before the next is issued: forward, decode, (with ``tta="hflip"``
        the mirror's forward, its decode, the un-flip and the
        concatenation,) NMS."""
        stages = [lambda _: self._forward(x), self._decode]
        if self._tta == "hflip":
            stages += [lambda d: (d, self._forward(x.flip(2))),
                       lambda t: (t[0], self._decode(t[1])),
                       lambda t: (t[0], _unflip(t[1])),
                       lambda t: torch.cat(t, dim=1)]
        out = None
        for stage in stages + [self._nms]:
            out = stage(out)
            self._sync()
        return out

    def benchmark_latency(self, images_u8: Images, runs: int = 5,
                          staged: bool = False,
                          pipeline_k: int = 0) -> Dict[str, float]:
        """Timed serving calls on device-resident images: p50 / min / mean
        milliseconds, each call ended by a device synchronise.
        ``staged=False`` times ``predict``; ``staged=True`` times the same
        work as separate stages with a synchronise after each (``_staged``:
        the reference's model, then separate post-processing). In eager
        PyTorch every stage is its own launches either way, so the
        difference is the stages' barriers. ``pipeline_k > 0`` adds
        ``pipelined_per_call_ms``: K calls issued back to back, one
        synchronise. On a mesh ``staged`` raises, as in JAX: it is a
        single-device diagnostic."""
        if staged and self.mesh is not None:
            raise ValueError("staged latency benchmarking is a single-device "
                             "diagnostic; construct the model with mesh=None")
        x = self._images(images_u8)
        run: Callable = self._staged if staged else self.predict
        run(x)  # warm-up: kernel build, cuDNN plans
        self._sync()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            run(x)
            self._sync()
            times.append((time.perf_counter() - t0) * 1000)
        times.sort()
        out = {"p50_ms": times[len(times) // 2], "min_ms": times[0],
               "mean_ms": sum(times) / len(times), "batch": int(x.shape[0])}
        if pipeline_k:
            t0 = time.perf_counter()
            for _ in range(pipeline_k):
                run(x)
            self._sync()
            out["pipelined_per_call_ms"] = (
                (time.perf_counter() - t0) * 1000 / pipeline_k)
        return out


def check_serving_config(e: EvalConfig, mesh) -> None:
    """Raise on what no serving model takes: a process mesh (serving is one
    process driving a device mesh) or an unknown TTA."""
    if mesh is not None:
        if mesh.group is not None:
            raise ValueError("serving runs one process over a device mesh "
                             "(create_mesh(devices=...)), not a process "
                             "group")
    if e.tta not in ("none", "hflip"):
        raise ValueError(f"unknown EvalConfig.tta {e.tta!r} "
                         "(expected 'none' or 'hflip')")


def serving_device(device, mesh):
    """``device``, or where it is None the first device of ``mesh``."""
    if device is None and mesh is not None:
        return mesh.devices[0]
    return device


class InferenceModel(ServingModel):
    """Forward + decode (+ NMS) serving of a float ``state_dict``.

    ``device=None`` means ``"cuda"`` and raises when no GPU is present; only
    an explicit ``device="cpu"`` serves on the CPU (with the plain NMS).
    ``mesh``: a device ``parallel.Mesh``; the model serves over its devices
    (``ServingModel``) and ``device`` defaults to the first of them."""

    def __init__(self, config: Config, state_dict: Mapping[str, torch.Tensor],
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        check_serving_config(config.eval, mesh)
        self.device = _device(serving_device(device, mesh), "serving")
        self.config = config
        model = build_model(config)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self._shard_over(mesh)

    def _forward(self, images_u8: torch.Tensor):
        g, head = self.config.grid, self.config.model.head
        y = self.model(preprocess_eval_batch(images_u8))
        if head == "fpn":
            return y
        return y.reshape(-1, g.grid, g.grid, g.head_depth(head))  # flat heads


def load_serving_state(config: Config, checkpoint_dir: str,
                       avg_ckpts: int = 0, use_ema: bool = False,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Tuple[TrainState, Dict[str, torch.Tensor], str]:
    """``(state, state_dict, description)`` of the checkpoint to serve: the
    best one, or with ``avg_ckpts = K`` the average of the newest K
    (``average_checkpoints``). ``state_dict`` is the model's, with the EMA
    weights in place of the parameters when ``use_ema`` (a checkpoint
    without an EMA raises)."""
    # the checkpoint replaces every weight: no pretrained file is read
    template = create_train_state(dataclasses.replace(
        config, model=dataclasses.replace(config.model,
                                          pretrained_backbone="")),
        device=device)
    ckpt = CheckpointManager(checkpoint_dir)
    try:
        if avg_ckpts:
            state = average_checkpoints(ckpt, template, last_k=avg_ckpts)
            info = (f"average of the newest {avg_ckpts} checkpoints "
                    f"{ckpt.all_steps[-avg_ckpts:]}")
        else:
            state = ckpt.restore(template)
            info = (f"step={state.step} (best={ckpt.best_step}, "
                    f"latest={ckpt.latest_step})")
    finally:
        ckpt.close()
    state_dict = dict(state.model.state_dict())
    if use_ema:
        if state.ema is None:
            raise ValueError("checkpoint has no EMA params "
                             "(train with TrainConfig.ema_decay)")
        state_dict.update(state.ema)
        info += ", EMA"
    return state, state_dict, info


class Evaluator:
    """Dataset loss and mAP of a ``TrainState`` (the reference's post-fit
    test loop), on ``cuda`` unless ``device`` says otherwise.

    ``use_ema``: None follows the config (``ema_decay`` and
    ``eval_with_ema``), True or False overrides it (the CLI's
    ``--use-ema``).

    ``mesh``: a device ``parallel.Mesh``, as JAX's ``Evaluator(mesh=)``:
    the batch size must divide by its data axis; each batch is cut into one
    contiguous shard a data row, each evaluated by a replica of the state on
    the row's first device (a model axis replicates the rows), the shards'
    losses summed and their grids concatenated in batch order on
    ``device`` (default: the mesh's first) for the mAP."""

    def __init__(self, config: Config, use_ema: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None, mesh=None):
        self.config = config
        if mesh is not None:
            check_serving_config(config.eval, mesh)
            dp = mesh.data_parallel
            if config.data.batch_size % dp:
                raise ValueError(
                    f"eval batch size {config.data.batch_size} must divide "
                    f"by the data-parallel mesh size {dp}")
        self.mesh = mesh
        self.device = _device(serving_device(device, mesh), "evaluation")
        self._eval_step = make_eval_step(config, use_ema=use_ema)
        self.map_metric = _map_metric(config)

    def _mesh_step(self, state: TrainState):
        """The eval step over the mesh: a replica of ``state``'s model and
        EMA a data row (``parallel.mesh.replicate``), each on its shard; the
        shards' losses summed, their grids joined on ``device``."""
        replicas = replicate(dataclasses.replace(state, opt=None),
                             self.mesh.data_devices, self.device)

        def shard(rep, images, boxes, valid, weight):
            loss, y_true, y_pred = self._eval_step(rep, images, boxes, valid,
                                                   weight)
            return loss.reshape(1), y_true, y_pred

        def step(_state, images, boxes, valid, weight=None):
            loss, y_true, y_pred = map_shards(shard, replicas, self.device,
                                              images, boxes, valid, weight)
            return loss.sum(), y_true, y_pred

        return step

    def evaluate(self, state: TrainState, ds: YoloDataset,
                 with_map: bool = True,
                 coco_map: bool = False) -> Dict[str, float]:
        """``{"loss", "mAP", "eval_time_s", "images_per_s"}``; ``coco_map``
        adds the COCO sweep (``mAP@0.50`` ... ``mAP@[.50:.95]``) from the
        same accumulated box sets. ``state`` must be on the evaluator's
        device."""
        t0 = time.perf_counter()
        where = next(state.model.parameters()).device
        if where != self.device:
            raise ValueError(f"the state is on {where}, the evaluator on "
                             f"{self.device}")
        step = self._eval_step if self.mesh is None else self._mesh_step(state)
        loss, map_val = run_dataset_eval(
            self.config, step, self.map_metric, state, ds,
            with_map=with_map or coco_map)
        out = {"loss": loss}
        if with_map:
            out["mAP"] = map_val
        if coco_map:
            out.update(self.map_metric.result_multi())
        out["eval_time_s"] = time.perf_counter() - t0
        out["images_per_s"] = ds.num_examples / max(out["eval_time_s"], 1e-9)
        return out
