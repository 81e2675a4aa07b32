"""Training (counterpart of ``keras_object_detection_tpu/train/loop.py`` for
the v1 heads, the YOLOv2 anchor head and the YOLOv3 FPN head): the train
step, the eval step and the ``Trainer``.

    state = create_train_state(cfg, generator, device)
    step = make_train_step(cfg)
    state, metrics = step(state, images_u8, boxes, valid, seed)

One step: the draws -> ``mosaic_batch`` and ``mixup_batch`` where the
config switches them on -> ``augment_batch`` -> ``encode_grid`` (the anchor
head: ``encode_anchor_grid``; the FPN head: ``encode_fpn_grids``, a grid a
scale) -> forward with training-mode BatchNorm (and the flatten_dense head's
dropout, its mask drawn from the step's own generator) -> the v1 loss (the
anchor head: ``yolo_v2_loss_terms``, the FPN head: ``yolo_v3_loss_terms``,
with the augmented boxes for their ignore mask) -> backward ->
the optimizer update, the BN running statistics (updated in the forward) and
the parameter EMA. ``TrainConfig.use_pallas_loss`` selects the fused loss
with its kernels, ``ModelConfig.bn_mode="fused"`` the BN-statistics kernels.
With ``ModelConfig.freeze_backbone`` the backbone runs in eval mode without
gradient and the optimizer sees zero gradients for it.

Unlike the JAX step, which returns a new state, this one updates the model,
the optimizer moments and the EMA in place (no second copy of ~4x the
parameters) and returns the same ``state``. The step puts the model in
training mode, the eval step in eval mode. ``create_train_state``,
``Trainer`` and the steps run on ``cuda`` unless the caller passes
``device="cpu"``.

``Trainer.fit`` is the training run: epochs of steps over a ``YoloDataset``
(or the same data held on the device), validation loss and mAP, the
reference's mAP policy, best-by-val-loss checkpoints, plateau LR scaling,
early stopping and resume; multiscale training (a resolution drawn per
epoch, ``multiscale_grid``) and ``steps_per_dispatch`` (``_train_batches``).

Data parallelism (a ``parallel.Mesh`` over a process group, one process a
device) keeps JAX's semantics, one program over the global batch: each rank
steps on its row block, the BatchNorm statistics are the global batch's
(``models.layers.data_group``), the draws are the global batch's with each
rank taking its rows, mosaic and mixup see the gathered global batch, the
gradients and metrics are summed over the ranks (every loss is a sum, so no
averaging), evaluation gathers the predictions in global row order, and rank
0 alone writes the logs and checkpoints.

Tensor parallelism (a mesh with a model axis, ``parallel/tensor.py``)
places the large kernels' output features on the model axis as JAX's
``state_sharding`` does (``Trainer.init_state``). The collectives of the
step above then run over the **data group** (the ranks of one model
index), the gradients of sharded and replicated parameters alike; the
column-parallel layers gather over the model group; the replicated 1-D
parameters of sharded channels sum their slices' gradients over the model
group (``tensor.reduce_partial_grads``); the loss runs on the gathered
head output on every model rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from keras_object_detection_torch.config import Config, check_ported
from keras_object_detection_torch.core.anchors import encode_anchor_grid
from keras_object_detection_torch.core.fpn import encode_fpn_grids
from keras_object_detection_torch.core.grid import encode_grid
from keras_object_detection_torch.data.augment import (
    AugmentDraws, MixupDraws, MosaicDraws, augment_batch, mixup_batch,
    mosaic_batch, preprocess_eval_batch, sample_augment_draws,
    sample_mixup_draws, sample_mosaic_draws)
from keras_object_detection_torch.data.pipeline import (DeviceCachedDataset,
                                                        YoloDataset)
from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
from keras_object_detection_torch.losses.yolov2 import yolo_v2_loss_terms
from keras_object_detection_torch.losses.yolov3 import yolo_v3_loss_terms
from keras_object_detection_torch.models.layers import data_group
from keras_object_detection_torch.models.yolo import (YoloV1,
                                                     backbone_feature_size,
                                                     build_model)
from keras_object_detection_torch.ops.map import (COCO_IOU_THRESHOLDS,
                                                  MeanAveragePrecision)
from keras_object_detection_torch.ops.yolo_loss import fused_yolo_v1_loss
from keras_object_detection_torch.parallel import distributed, tensor
from keras_object_detection_torch.parallel.mesh import create_mesh, shard_rows
from keras_object_detection_torch.train import optim
from keras_object_detection_torch.train.checkpoint import CheckpointManager
from keras_object_detection_torch.train.metrics_logger import MetricLogger
from keras_object_detection_torch.train.schedules import epoch_schedule


@dataclasses.dataclass
class TrainState:
    """The model (on its device, in training mode; its buffers hold the BN
    running statistics), the optimizer state, the step count and the EMA of
    the parameters (``None`` without ``TrainConfig.ema_decay``)."""

    model: YoloV1
    opt: optim.OptState
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def _device(device, what: str = "training") -> torch.device:
    """``device``, by default ``cuda``, which must then exist: no quiet
    fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} runs on the GPU by default and none "
                               "is available; pass device='cpu' to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def create_train_state(config: Config,
                       generator: Optional[torch.Generator] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """The model of ``config`` with weights drawn from ``generator``
    (default: seeded with ``config.train.seed``), the backbone's replaced by
    ``config.model.pretrained_backbone``'s when that names a file, moved to
    ``device`` (default ``cuda``) in ``channels_last`` memory, and its
    optimizer at ``config.train.schedule.base_lr``."""
    check_ported(config, training=True)
    dev = _device(device)
    model = build_model(config, generator)
    if config.model.pretrained_backbone:
        from keras_object_detection_torch.models.pretrained import (
            load_pretrained_backbone)

        model.load_state_dict(load_pretrained_backbone(
            model.state_dict(), config.model.backbone,
            config.model.pretrained_backbone))
    model = model.to(dev, memory_format=torch.channels_last).train()
    params = list(model.parameters())
    opt = optim.init_opt_state(config.train.optimizer, params,
                               config.train.schedule.base_lr,
                               config.train.weight_decay)
    ema = None
    if config.train.ema_decay is not None:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, opt, 0, ema)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Swap the learning rate without rebuilding the step."""
    optim.set_learning_rate(state.opt, lr)
    return state


def step_generator(seed: int, step: int,
                   micro: Optional[int] = None) -> torch.Generator:
    """The CPU generator of one step's (or microbatch's) augmentation
    draws: ``seed`` folded with the step (and the microbatch index), as the
    JAX step folds ``state.step`` into its key."""
    words = [seed, step] + ([] if micro is None else [micro])
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _stream(seed: int, step: int, micro: Optional[int],
            arm: int) -> torch.Generator:
    """A CPU generator of one step's (or microbatch's) draws of one arm: 1
    the dropout masks, 2 the mosaic, 3 the mixup. Each arm is a stream of
    its own, apart from ``step_generator``'s, so switching one on or off
    leaves every other arm's draws as they were."""
    words = [seed, step, 0 if micro is None else micro + 1, arm]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def dropout_generator(seed: int, step: int,
                      micro: Optional[int] = None) -> torch.Generator:
    """The CPU generator of one step's (or microbatch's) dropout masks, a
    stream apart from the augmentation draws' (JAX's ``dkey`` beside
    ``akey``)."""
    return _stream(seed, step, micro, 1)


def stage(tensors: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """CPU ``tensors`` on ``device``; on a GPU in one host-to-device copy,
    their bytes packed at 16-byte offsets into one pinned buffer (PyTorch's
    pinned-memory allocator reuses it only after the copy has ended)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [t.to(device) for t in tensors]
    sizes = [t.numel() * t.element_size() for t in tensors]
    offsets = np.concatenate([[0], np.cumsum([-(-n // 16) * 16 for n in sizes])])
    host = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=True)
    for t, o, n in zip(tensors, offsets, sizes):
        host[o:o + n] = t.contiguous().reshape(-1).view(torch.uint8)
    dev = host.to(device, non_blocking=True)
    return [dev[o:o + n].view(t.dtype).reshape(t.shape)
            for t, o, n in zip(tensors, offsets, sizes)]


@dataclasses.dataclass
class StepDraws:
    """Every random number of one (micro)batch of a train step: the colour
    and crop draws, the mosaic's and the mixup's (None where they are off)
    and the flatten_dense head's dropout keep mask (None for other
    heads)."""

    augment: AugmentDraws
    mosaic: Optional[MosaicDraws] = None
    mixup: Optional[MixupDraws] = None
    keep: Optional[torch.Tensor] = None

    def _parts(self):
        return [p for p in (self.augment, self.mosaic, self.mixup)
                if p is not None]

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor, in the order ``replaced`` takes them."""
        out = [getattr(p, f.name) for p in self._parts()
               for f in dataclasses.fields(p)
               if isinstance(getattr(p, f.name), torch.Tensor)]
        return out + ([] if self.keep is None else [self.keep])

    def replaced(self, tensors: Iterator[torch.Tensor]) -> "StepDraws":
        """These draws with their tensors taken in turn from ``tensors``."""

        def part(p):
            if p is None:
                return None
            return dataclasses.replace(p, **{
                f.name: next(tensors) for f in dataclasses.fields(p)
                if isinstance(getattr(p, f.name), torch.Tensor)})

        return StepDraws(part(self.augment), part(self.mosaic),
                         part(self.mixup),
                         None if self.keep is None else next(tensors))

    def rows(self, block: slice) -> "StepDraws":
        """The per-image draws of the rows ``block`` of the batch: the
        colour and crop draws and the dropout mask; the mosaic's and the
        mixup's stay whole (they run on the whole batch)."""
        augment = dataclasses.replace(self.augment, **{
            f.name: getattr(self.augment, f.name)[block]
            for f in dataclasses.fields(self.augment)
            if isinstance(getattr(self.augment, f.name), torch.Tensor)})
        return dataclasses.replace(
            self, augment=augment,
            keep=None if self.keep is None else self.keep[block])

    def to(self, device) -> "StepDraws":
        """On ``device``, in one copy (``stage``)."""
        tensors = self.tensors()
        if all(t.device == device for t in tensors):
            return self
        return self.replaced(iter(stage(tensors, device)))


def sample_step_draws(config: Config, model: YoloV1, batch: int, seed: int,
                      step: int) -> List[StepDraws]:
    """One train step's draws on the CPU, one ``StepDraws`` per microbatch
    of ``batch / grad_accum_steps`` images: the colour and crop draws from
    ``step_generator``, the mosaic's (``mosaic_prob > 0``), the mixup's
    (``mixup_prob > 0``) and the dropout mask each from its own stream
    (``_stream``)."""
    d = config.data
    accum = max(config.train.grad_accum_steps or 1, 1)
    n = batch // accum
    out = []
    for i in range(accum):
        micro = i if accum > 1 else None
        out.append(StepDraws(
            sample_augment_draws(n, step_generator(seed, step, micro),
                                 tuple(d.color_jitter), tuple(d.crop_scale),
                                 tuple(d.crop_ratio)),
            sample_mosaic_draws(n, _stream(seed, step, micro, 2),
                                tuple(d.mosaic_center_range))
            if d.mosaic_prob > 0 else None,
            sample_mixup_draws(n, _stream(seed, step, micro, 3),
                               d.mixup_alpha)
            if d.mixup_prob > 0 else None,
            model.draw_dropout(n, dropout_generator(seed, step, micro))))
    return out


def multiscale_grid(config: Config, size: int) -> int:
    """The target grid S of a multiscale training resolution ``size``: the
    conv head's true output grid there (its stride ``max(feat // grid,
    1)``, SAME), with the backbone's feature side measured from the module
    (``backbone_feature_size``); a GAP dense head always emits the
    configured grid; the FPN head's coarsest grid is the backbone's feature
    side, ``size`` over the pixel stride. Raises ``ValueError`` where
    ``size`` is not a multiple of the backbone's pixel stride or leaves no
    features, and for the FPN head where ``image_size`` is not a multiple of
    it either (each tap must be exactly twice the scale before it)."""
    if config.model.head == "gap_dense":
        return config.grid.grid
    backbone, canon = config.model.backbone, config.model.image_size
    feat0 = backbone_feature_size(backbone, canon)
    if feat0 <= 0:
        raise ValueError(
            f"backbone emits no spatial features at image_size {canon}")
    if config.model.head == "fpn":
        if canon % feat0:
            raise ValueError(
                f"image_size {canon} is not an exact multiple of the "
                f"{backbone} stride (feat {feat0}) — fpn multiscale needs "
                "exact-stride geometry")
        stride_px = canon // feat0
        if size % stride_px:
            raise ValueError(
                f"multiscale size {size} must be a multiple of the backbone "
                f"pixel stride {stride_px}")
        return size // stride_px
    if canon % feat0 == 0:
        stride_px = canon // feat0
        if size % stride_px:
            raise ValueError(
                f"multiscale size {size} must be a multiple of the backbone "
                f"pixel stride {stride_px}")
    feat = backbone_feature_size(backbone, size)
    if feat <= 0:
        raise ValueError(f"multiscale size {size} is too small for the "
                         f"{backbone} backbone")
    head_stride = max(feat // config.grid.grid, 1)
    return -(-feat // head_stride)  # ceil (SAME conv)


def validate_multiscale(config: Config) -> None:
    """Refuse multiscale sizes for a head whose parameter shapes depend on
    the resolution (flatten_dense), or that ``multiscale_grid`` refuses."""
    if not config.train.multiscale_sizes:
        return
    if config.model.head == "flatten_dense":
        raise ValueError(
            "multiscale_sizes requires a resolution-agnostic head: 'conv' or "
            "'gap_dense' (flatten_dense Dense kernels have "
            "resolution-dependent shapes)")
    for size in config.train.multiscale_sizes:
        multiscale_grid(config, size)


def make_train_step(config: Config, image_size: Optional[int] = None,
                    grid: Optional[int] = None, group=None):
    """Build ``step(state, images_u8, boxes, valid, seed, draws=None)``.

    ``images_u8`` is ``(B, H, W, 3)`` uint8, ``boxes`` ``(B, N, 5)``
    ``[cx, cy, w, h, class]`` and ``valid`` ``(B, N)``; they are moved to
    the model's device. ``seed`` (an int >= 0) with ``state.step`` seeds the
    draws (``sample_step_draws``); ``draws`` (one ``StepDraws``, or one
    ``AugmentDraws`` whose dropout mask then comes from the seed, per
    microbatch) replaces them, so a test can feed the JAX step's own.

    With ``DataConfig.mosaic_prob`` and ``mixup_prob`` the batch goes
    through ``mosaic_batch`` (at its own resolution, before the crop) and
    ``mixup_batch`` first, as in JAX; the box budget grows to 4N and then
    2x. ``image_size`` and ``grid`` set the crop's output resolution and the
    target grid of a multiscale step (default: the config's).

    With ``grad_accum_steps = k`` the batch is cut into k strided
    microbatches (rows ``i::k``), their gradients and loss terms summed, and
    the BN running statistics updated by each in turn. Returns the state and
    the metrics: ``{"total"}`` on the fused-loss path, the five loss terms
    on the plain one, as 0-dim tensors on the device.

    ``group``: the process group of data parallelism, W ranks. The step
    then takes this rank's row block of a global batch of W times its rows
    and computes JAX's step over that global batch: ``draws`` (or the
    seed's) are the global batch's and the rank takes its rows of each
    (of each microbatch: microbatch i is rows ``i::k`` of every block, the
    global microbatch's rows in this rank's block, in order); mosaic and
    mixup run on the gathered global (micro)batch; BatchNorm takes the
    global statistics; the gradients (after the microbatches, in one flat
    all-reduce, frozen parameters skipped) and the metrics are summed over
    the ranks. One rank, or no group, adds no collective. With tensor
    parallelism ``group`` is the mesh's data group, and a model placed on
    the model axis (``parallel.tensor.shard_state``) first sums its partial
    gradients over the model group."""
    check_ported(config, training=True)
    g, d, t = config.grid, config.data, config.train
    accum = max(t.grad_accum_steps or 1, 1)
    out_size = config.model.image_size if image_size is None else image_size
    out_grid = g.grid if grid is None else grid
    anchor_head = config.model.head == "anchor"
    fpn_head = config.model.head == "fpn"
    if t.use_pallas_loss and t.box_loss_mode != "mse":
        raise ValueError(
            "use_pallas_loss implements only the reference MSE box terms; "
            f"box_loss_mode={t.box_loss_mode!r} requires the plain loss "
            "(use_pallas_loss=False)")

    def encode(boxes, valid):
        if fpn_head:
            return encode_fpn_grids(boxes, valid, g.num_classes, g.anchors,
                                    out_grid, config.model.fpn_scales)
        if anchor_head:
            return encode_anchor_grid(boxes, valid, g.num_classes, g.anchors,
                                      out_grid)
        return encode_grid(boxes, valid, g.num_classes, g.num_boxes, out_grid)

    def loss_terms(y_true, y_pred, boxes, valid) -> Dict[str, torch.Tensor]:
        if fpn_head:
            return yolo_v3_loss_terms(
                y_true, y_pred, g.num_classes, g.anchors,
                config.model.fpn_scales, t.lambda_coord, t.lambda_noobj,
                ignore_threshold=t.ignore_threshold, gt_boxes=boxes,
                gt_valid=valid, obj_target=t.obj_target)
        if anchor_head:
            return yolo_v2_loss_terms(
                y_true, y_pred, g.num_classes, g.anchors, t.lambda_coord,
                t.lambda_noobj, ignore_threshold=t.ignore_threshold,
                gt_boxes=boxes, gt_valid=valid, obj_target=t.obj_target)
        if t.use_pallas_loss:
            return {"total": fused_yolo_v1_loss(
                y_true, y_pred, g.num_classes, g.num_boxes, t.lambda_coord,
                t.lambda_noobj, t.noobj_mode)}
        return yolo_v1_loss_terms(y_true, y_pred, g.num_classes, g.num_boxes,
                                  t.lambda_coord, t.lambda_noobj, t.noobj_mode,
                                  t.box_loss_mode)

    world, rank = distributed.world_size(group), distributed.rank_of(group)

    def backward_on(model, images_u8, boxes, valid, draws: StepDraws):
        own = slice(rank * images_u8.shape[0], (rank + 1) * images_u8.shape[0])
        mixing = d.mosaic_prob > 0 or d.mixup_prob > 0
        if mixing and world > 1:
            # partners come from the whole (micro)batch: gather it
            images_u8, boxes, valid = (distributed.all_gather_rows(t, group)
                                       for t in (images_u8, boxes, valid))
        if d.mosaic_prob > 0:
            images_u8, boxes, valid = mosaic_batch(
                images_u8, boxes, valid, draws.mosaic, d.mosaic_prob)
        if d.mixup_prob > 0:
            images_u8, boxes, valid = mixup_batch(
                images_u8, boxes, valid, draws.mixup, d.mixup_prob)
        if mixing and world > 1:
            images_u8, boxes, valid = images_u8[own], boxes[own], valid[own]
        if world > 1:
            draws = draws.rows(own)
        images, aboxes, avalid = augment_batch(
            images_u8, boxes, valid, draws.augment, hflip_prob=d.hflip_prob,
            color_strengths=tuple(d.color_jitter),
            crop_ratio=tuple(d.crop_ratio), min_visibility=d.min_visibility,
            out_size=out_size)
        y_true = encode(aboxes, avalid)
        y_pred = model(images, draws.keep)
        if not fpn_head:
            y_pred = y_pred.reshape(y_true.shape)  # flat heads too
        terms = loss_terms(y_true, y_pred, aboxes, avalid)
        terms["total"].backward()
        return {k: v.detach() for k, v in terms.items()}

    def step(state: TrainState, images_u8, boxes, valid, seed: int,
             draws=None):
        model = state.model
        params = list(model.parameters())
        # a frozen backbone takes no gradient; the optimizer sees zeros, as
        # JAX's stop_gradient gives them
        frozen = ({id(p) for p in model.backbone.parameters()}
                  if model.freeze_backbone else set())
        dev = params[0].device
        images_u8 = torch.as_tensor(images_u8).to(dev)
        boxes = torch.as_tensor(boxes).to(dev, torch.float32)
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        b = images_u8.shape[0] * world  # the global batch
        if b % (accum * world):
            raise ValueError(f"grad_accum_steps={accum} must divide the batch "
                             f"size {b // world}")
        if draws is None:
            draws = sample_step_draws(config, model, b, seed, state.step)
        elif isinstance(draws, (AugmentDraws, StepDraws)):
            draws = [draws]
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")
        draws = [x if isinstance(x, StepDraws) else StepDraws(
            x, keep=model.draw_dropout(b // accum, dropout_generator(
                seed, state.step, i if accum > 1 else None)))
            for i, x in enumerate(draws)]
        if any((d.mosaic_prob > 0 and x.mosaic is None)
               or (d.mixup_prob > 0 and x.mixup is None) for x in draws):
            raise ValueError("the draws lack the mosaic's or the mixup's, "
                             "which the config switches on")

        model.train()
        for p in params:
            p.grad = None
        metrics: Dict[str, torch.Tensor] = {}
        with data_group(model, group):
            for i in range(accum):
                rows = slice(i, None, accum)
                terms = backward_on(model, images_u8[rows], boxes[rows],
                                    valid[rows], draws[i].to(dev))
                metrics = {k: metrics[k] + v if k in metrics else v
                           for k, v in terms.items()}
        tensor.reduce_partial_grads(model)
        if world > 1:
            # every loss is a sum over the batch: sum, never average
            distributed.all_reduce_flat_(
                [p.grad for p in params if p.grad is not None], group)
            keys = sorted(metrics)
            summed = distributed.all_reduce_(
                torch.stack([metrics[k] for k in keys]), group)
            metrics = dict(zip(keys, summed.unbind()))
        optim.apply_updates(state.opt, params, [
            torch.zeros_like(p) if p.grad is None and id(p) in frozen else p.grad
            for p in params])
        if state.ema is not None:
            decay = t.ema_decay
            with torch.no_grad():
                for n, p in model.named_parameters():
                    e = state.ema[n]
                    e.copy_(decay * e + (1.0 - decay) * p)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(config: Config, use_ema: Optional[bool] = None):
    """Build ``eval_step(state, images_u8, boxes, valid, image_weight=None)
    -> (loss, y_true, y_pred)``: u8 / 255 -> ``encode_grid`` -> the forward
    in eval mode -> the plain v1 loss (a sum, as in training), with
    ``image_weight`` an optional ``(batch,)`` 0/1 weight of each image. The
    anchor head encodes with ``encode_anchor_grid`` and takes
    ``yolo_v2_loss_terms`` with the batch's boxes for its ignore mask; the
    FPN head ``encode_fpn_grids`` and ``yolo_v3_loss_terms``, and its
    ``y_true`` and ``y_pred`` are tuples of a grid a scale.

    ``use_ema``: None follows the config (``ema_decay`` set and
    ``eval_with_ema``); True or False overrides it. The EMA weights are
    evaluated in place of the parameters through
    ``torch.func.functional_call``, with the model's own BN statistics,
    without copying them into the model."""
    g, t = config.grid, config.train
    ema_on = use_ema if use_ema is not None else (
        t.ema_decay is not None and t.eval_with_ema)
    anchor_head = config.model.head == "anchor"
    fpn_head = config.model.head == "fpn"

    @torch.no_grad()
    def eval_step(state: TrainState, images_u8, boxes, valid,
                  image_weight=None):
        model = state.model
        dev = next(model.parameters()).device
        images = preprocess_eval_batch(torch.as_tensor(images_u8).to(dev))
        boxes = torch.as_tensor(boxes).to(dev, torch.float32)
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        if fpn_head:
            y_true = encode_fpn_grids(boxes, valid, g.num_classes, g.anchors,
                                      g.grid, config.model.fpn_scales)
        elif anchor_head:
            y_true = encode_anchor_grid(boxes, valid, g.num_classes,
                                        g.anchors, g.grid)
        else:
            y_true = encode_grid(boxes, valid, g.num_classes, g.num_boxes,
                                 g.grid)
        model.eval()
        if ema_on and state.ema is not None:
            y_pred = torch.func.functional_call(
                model, (state.ema, dict(model.named_buffers())), (images,))
        else:
            y_pred = model(images)
        if image_weight is not None:
            image_weight = torch.as_tensor(image_weight).to(dev)
        if fpn_head:
            terms = yolo_v3_loss_terms(
                y_true, y_pred, g.num_classes, g.anchors,
                config.model.fpn_scales, t.lambda_coord, t.lambda_noobj,
                sample_weight=image_weight,
                ignore_threshold=t.ignore_threshold, gt_boxes=boxes,
                gt_valid=valid, obj_target=t.obj_target)
            return terms["total"], y_true, y_pred
        y_pred = y_pred.reshape(y_true.shape)  # flat heads too
        if anchor_head:
            terms = yolo_v2_loss_terms(
                y_true, y_pred, g.num_classes, g.anchors, t.lambda_coord,
                t.lambda_noobj, sample_weight=image_weight,
                ignore_threshold=t.ignore_threshold, gt_boxes=boxes,
                gt_valid=valid, obj_target=t.obj_target)
            return terms["total"], y_true, y_pred
        terms = yolo_v1_loss_terms(
            y_true, y_pred, g.num_classes, g.num_boxes, t.lambda_coord,
            t.lambda_noobj, t.noobj_mode, t.box_loss_mode,
            sample_weight=image_weight)
        return terms["total"], y_true, y_pred

    return eval_step


EvalOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def run_dataset_eval(config: Config, eval_step, map_metric, state: TrainState,
                     ds: YoloDataset, with_map: bool = True, stash=None,
                     group=None):
    """One eval pass over ``ds`` on the state's device: ``(loss, mAP or
    None)``. With ``eval.mask_padded_images`` the zero images that pad the
    last batch weigh 0 in the loss and are dropped from the mAP (see
    ``_accumulate_eval``). ``group``: the process group of data
    parallelism; each rank evaluates its row block of each batch, the loss
    is summed over the ranks and the mAP sees the global batch (see
    ``_accumulate_eval``)."""
    mask = config.eval.mask_padded_images
    dev = next(state.model.parameters()).device
    world, rank = distributed.world_size(group), distributed.rank_of(group)
    block = (None if world == 1 else
             shard_rows(ds.batch_size, world)[rank])

    def stepped() -> Iterable[EvalOut]:
        for i, (images, boxes, valid) in enumerate(
                ds.prefetched(dev, block=block)):
            weight = None
            if mask:
                n_real = min(ds.batch_size, ds.num_examples - i * ds.batch_size)
                weight = torch.arange(ds.batch_size, device=dev) < n_real
                if block is not None:
                    weight = weight[block]
            yield (*eval_step(state, images, boxes, valid, weight), weight)

    return _accumulate_eval(mask, ds.batch_size, ds.num_examples, stepped(),
                            with_map, map_metric, stash, group)


def _gathered(t, group):
    """A rank's rows (a tensor, a per-scale tuple of them or None) of a
    batch, gathered into the global batch in row order."""
    if t is None or distributed.world_size(group) == 1:
        return t
    if isinstance(t, tuple):
        return tuple(distributed.all_gather_rows(x, group) for x in t)
    return distributed.all_gather_rows(t, group)


def _accumulate_eval(mask: bool, batch_size: int, num_examples: int,
                     stepped: Iterable[EvalOut], with_map: bool, map_metric,
                     stash=None, group=None):
    """The loss summed on the device and read back once after the loop;
    the mAP updates (or, with ``stash`` and no mAP, the ``(y_true, y_pred,
    weight)`` of each batch kept for a later mAP without another forward).

    Masked, the loss is ``sum * batch_size / n_evaluated``: the unmasked
    mean of batch sums whenever the batch divides the set, and the exact
    unpadded value when it does not; ``n_evaluated`` counts only the images
    of batches that ran (a dropped remainder does not).

    Over a ``group`` of ranks, ``stepped`` yields each rank's rows: the
    loss sum is summed over the ranks once after the loop, and the grids
    and weights are gathered into the global batch in row order before the
    mAP sees them (greedy matching follows that order on ties), so every
    rank holds the global loss and mAP."""
    total, batches = None, 0
    if with_map:
        map_metric.reset_states()
    for loss, y_true, y_pred, weight in stepped:
        total = loss if total is None else total + loss
        batches += 1
        if with_map or stash is not None:
            y_true, y_pred, weight = (_gathered(t, group)
                                      for t in (y_true, y_pred, weight))
        if with_map:
            map_metric.update_state(y_true, y_pred, image_valid=weight)
        elif stash is not None:
            stash.append((y_true, y_pred, weight))
    if not batches:
        return 0.0, (map_metric.result() if with_map else None)
    if distributed.world_size(group) > 1:
        total = distributed.all_reduce_(total.reshape(1).clone(), group)[0]
    if mask:
        n_evaluated = min(num_examples, batches * batch_size)
        loss_out = float(total) * batch_size / max(n_evaluated, 1)
    else:
        loss_out = float(total) / batches
    return loss_out, (map_metric.result() if with_map else None)


def _map_metric(config: Config) -> MeanAveragePrecision:
    g, e, head = config.grid, config.eval, config.model.head
    return MeanAveragePrecision(
        g.num_classes, g.num_boxes, g.grid, iou_threshold=e.iou_threshold,
        conf_threshold=e.conf_threshold,
        map_iou_threshold=e.map_iou_threshold,
        anchors=g.anchors if head in ("anchor", "fpn") else (),
        fpn_scales=config.model.fpn_scales if head == "fpn" else 0,
        max_candidates=e.max_candidates)


def check_batch_divides(config: Config, dp: int) -> None:
    """JAX's ``Trainer`` checks: the batch divides by the data axis, and by
    ``grad_accum_steps`` times it (strided microbatches stay balanced)."""
    batch = config.data.batch_size
    if batch % dp != 0:
        raise ValueError(f"batch_size {batch} must be divisible by the "
                         f"data-parallel mesh size {dp}")
    accum = max(config.train.grad_accum_steps or 1, 1)
    if batch % (accum * dp) != 0:
        raise ValueError(
            f"batch_size {batch} must be divisible by grad_accum_steps * "
            f"data_parallel = {accum}*{dp} so strided microbatches stay "
            "shard-balanced")


class Trainer:
    """The training run (the reference's ``model.fit`` with its callbacks):
    ``fit`` for epochs, ``evaluate`` on a test set, on ``cuda`` unless
    ``device`` says otherwise.

    ``mesh``: a ``parallel.Mesh``; by default ``create_mesh`` of
    ``config.mesh`` (its ``data_parallel`` and ``model_parallel``), over
    the process group's ranks once one is started
    (``parallel.distributed.maybe_initialize``), else over this process's
    device alone. Over a process group every rank builds the same Trainer
    and state (same seed, so the same weights) and steps on the row block
    of its data index of each global batch; the batch must divide by the
    data axis and by ``grad_accum_steps`` times it (JAX's checks). With a
    model axis ``init_state`` places the state on it (``state_sharding``'s
    rule, as JAX's ``init_state`` does); ``fit`` takes a state placed by
    ``parallel.tensor.shard_state`` at any threshold. Rank 0 alone writes
    the logs and whole-tensor checkpoints; every rank restores them."""

    def __init__(self, config: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 use_tensorboard: bool = True, mesh=None):
        check_ported(config, training=True)
        m, t = config.mesh, config.train
        self.device = _device(device)
        if mesh is None:
            mesh = create_mesh(m.data_parallel, m.model_parallel,
                               m.data_axis, m.model_axis,
                               devices=None if torch.distributed.is_initialized()
                               else [self.device])
        if mesh.group is None and mesh.data_parallel * mesh.model_parallel > 1:
            raise ValueError("training over several devices runs one process "
                             "a device: start the ranks with torchrun or "
                             "cli.train --data-parallel N")
        dp = mesh.data_parallel
        check_batch_divides(config, dp)
        validate_multiscale(config)
        self.config = config
        self.mesh = mesh
        # the step's, evaluation's and device cache's collectives: over the
        # data group; logs, checkpoints and the last barrier: the whole mesh
        self.group = mesh.data_group
        self.is_main = distributed.is_main(mesh.group)
        self._block = (None if dp == 1 else
                       shard_rows(config.data.batch_size, dp)[mesh.index])
        self._train_steps = {None: make_train_step(config, group=self.group)}
        self._eval_step = make_eval_step(config)
        self.logger = MetricLogger(t.log_dir, use_tensorboard=use_tensorboard,
                                   enabled=self.is_main)
        self.ckpt = CheckpointManager(t.checkpoint_dir, writer=self.is_main)
        self.map_metric = _map_metric(config)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """The seeded state, its large kernels (and their moments and EMA)
        placed on a model axis, as JAX's ``init_state`` does."""
        seed = self.config.train.seed if seed is None else seed
        state = create_train_state(self.config,
                                   torch.Generator().manual_seed(seed),
                                   self.device)
        return tensor.shard_state(state, self.mesh)

    def _validate(self, state: TrainState, val_ds: YoloDataset,
                  dev_val: Optional[DeviceCachedDataset], with_map: bool,
                  stash=None) -> Dict[str, float]:
        """Validation loss (and mAP) from the host loader, or from the
        device-resident set where padded rows are the zero sentinel
        (weight = ``idx < num_examples``)."""
        if dev_val is None:
            loss, map_val = run_dataset_eval(
                self.config, self._eval_step, self.map_metric, state, val_ds,
                with_map=with_map, stash=stash, group=self.group)
        else:
            mask = self.config.eval.mask_padded_images

            def stepped() -> Iterable[EvalOut]:
                for images, boxes, valid, idx in dev_val.epoch():
                    weight = idx < dev_val.num_examples if mask else None
                    yield (*self._eval_step(state, images, boxes, valid,
                                            weight), weight)

            loss, map_val = _accumulate_eval(
                mask, dev_val.batch_size, dev_val.num_examples, stepped(),
                with_map, self.map_metric, stash, self.group)
        out = {"val_loss": loss}
        if with_map:
            out["val_mAP"] = map_val
        return out

    def _map_from_stash(self, stash) -> float:
        """The mAP of the predictions a loss pass stashed: the second half
        of the single-pass validation, no new forward."""
        self.map_metric.reset_states()
        for y_true, y_pred, weight in stash:
            self.map_metric.update_state(y_true, y_pred, image_valid=weight)
        return self.map_metric.result()

    def _coco_map_logs(self) -> Dict[str, float]:
        """``EvalConfig.coco_map``'s extras from the filled accumulator:
        ``val_mAP_coco`` (mAP@[.50:.95]) and ``val_mAP@0.55`` ... (0.50 is
        ``val_mAP``)."""
        multi = self.map_metric.result_multi()
        out = {"val_mAP_coco": multi["mAP@[.50:.95]"]}
        out.update({f"val_mAP@{t:.2f}": multi[f"mAP@{t:.2f}"]
                    for t in COCO_IOU_THRESHOLDS if t > 0.5})
        return out

    def _should_eval_map(self, epoch: int, improved: bool) -> bool:
        """The reference's mAP policy: after ``map_eval_start_epoch``
        (1-based), when the monitored loss improved or every
        ``map_eval_every`` epochs."""
        t = self.config.train
        if (epoch + 1) <= t.map_eval_start_epoch:
            return False
        return improved or ((epoch + 1) % t.map_eval_every == 0)

    def _step_for(self, size: Optional[int]):
        """The train step at a multiscale ``size`` (None: the config's
        ``image_size``), built once per size."""
        if size == self.config.model.image_size:
            size = None
        if size not in self._train_steps:
            self._train_steps[size] = make_train_step(
                self.config, image_size=size,
                grid=multiscale_grid(self.config, size), group=self.group)
        return self._train_steps[size]

    def _epoch_size(self, epoch: int) -> Optional[int]:
        """The epoch's multiscale resolution, drawn from
        ``multiscale_sizes`` anew every ``multiscale_every`` epochs by a
        numpy ``RandomState`` seeded as JAX's; None when single-scale."""
        t = self.config.train
        if not t.multiscale_sizes:
            return None
        period = max(t.multiscale_every, 1)
        r = np.random.RandomState(
            ((t.seed + 7) * 1000003 + epoch // period) % (2 ** 32))
        return int(r.choice(np.asarray(t.multiscale_sizes)))

    def _train_batches(self, state: TrainState, train_ds: YoloDataset,
                       dev_train: Optional[DeviceCachedDataset], seed: int):
        """``(images, boxes, valid, draws)`` for each step of an epoch:
        from the host loader with the step's own draws (None), or from the
        device cache in chunks of ``steps_per_dispatch`` K steps (-1: the
        whole epoch; the last chunk holds the rest) whose row indices and
        draws (``sample_step_draws``, the same as the step's own) go to the
        device in one copy. The batches and draws do not depend on K, so
        neither does any step. Over a process group each rank gets its row
        block of every batch; the draws are the global batch's."""
        if dev_train is None:
            for images, boxes, valid in train_ds.prefetched(
                    self.device, block=self._block):
                yield images, boxes, valid, None
            return
        spd = self.config.train.steps_per_dispatch or 1
        rows = list(dev_train.epoch_indices())
        k = len(rows) if spd == -1 else spd
        for c in range(0, len(rows), max(k, 1)):
            chunk = rows[c:c + k]
            # read state.step here: the previous chunk's steps have run
            draws = [sample_step_draws(self.config, state.model,
                                       dev_train.batch_size, seed,
                                       state.step + i)
                     for i in range(len(chunk))]
            staged = iter(stage([torch.from_numpy(np.stack(chunk))]
                                + [t for step in draws for x in step
                                   for t in x.tensors()], self.device))
            idx_rows = next(staged)
            draws = [[x.replaced(staged) for x in step] for step in draws]
            for idx, step_draws in zip(idx_rows, draws):
                yield (*dev_train.gather(idx), step_draws)

    def fit(self, train_ds: YoloDataset, val_ds: Optional[YoloDataset] = None,
            epochs: Optional[int] = None, state: Optional[TrainState] = None,
            early_stop_patience: Optional[int] = None,
            reduce_on_plateau: Optional[Tuple[float, int, float]] = None,
            verbose: bool = True,
            start_epoch: Optional[int] = None) -> TrainState:
        """Train for ``epochs`` (default ``train.epochs``) from ``state``
        (default ``init_state()``), validating on ``val_ds`` after each.

        ``reduce_on_plateau=(factor, patience, min_lr)`` scales the
        scheduled LR by ``factor`` after each ``patience`` epochs without a
        lower val loss, floored at ``min_lr``. ``start_epoch`` is the
        resume point on the LR schedule and the checkpoint axis
        (``ckpt.latest_epoch + 1``); by default it is inferred from the
        step count, exact only for an unchanged batch and dataset size.

        Train metrics are summed on the device and read back once an epoch.
        A checkpoint is saved when the val loss beats the best saved one
        (not within ``save_cooldown_epochs`` of the last save), and the
        final state always, unless that epoch was just saved. Each epoch's
        line goes to the logger (and stdout with ``verbose``); over a
        process group, rank 0's alone, and every rank waits at the end
        until rank 0's checkpoints are on disk."""
        cfg = self.config
        epochs = cfg.train.epochs if epochs is None else epochs
        if state is None:
            state = self.init_state()
        dev_train = dev_val = None
        if cfg.data.device_cache:
            layout = cfg.data.device_cache_layout
            dev_train = DeviceCachedDataset(train_ds, self.device, layout,
                                            self.mesh)
            if val_ds is not None:
                dev_val = DeviceCachedDataset(val_ds, self.device, layout,
                                              self.mesh)
        epoch_offset = (start_epoch if start_epoch is not None
                        else state.step // max(len(train_ds), 1))
        lrs = epoch_schedule(cfg.train.schedule, epoch_offset + epochs)
        seed = cfg.train.seed + 1

        best = best_saved = float("inf")
        since_best = 0
        lr_scale = 1.0
        last_save = -(10 ** 9)  # the first improvement always saves
        last_monitor = float("inf")
        for epoch in range(epoch_offset, epoch_offset + epochs):
            lr = float(lrs[epoch]) * lr_scale
            if reduce_on_plateau is not None:
                lr = max(lr, reduce_on_plateau[2])
            set_learning_rate(state, lr)
            t0 = time.time()
            acc: Dict[str, torch.Tensor] = {}
            nb = 0
            ms_size = self._epoch_size(epoch)
            train_step = self._step_for(ms_size)
            for images, boxes, valid, draws in self._train_batches(
                    state, train_ds, dev_train, seed):
                state, metrics = train_step(state, images, boxes, valid, seed,
                                            draws)
                nb += 1
                for k, v in metrics.items():
                    acc[k] = v if k not in acc else acc[k] + v
            keys = sorted(acc)
            values = (torch.stack([acc[k] for k in keys]).tolist()
                      if keys else [])  # the epoch's one readback
            logs: Dict[str, Any] = {k: v / max(nb, 1)
                                    for k, v in zip(keys, values)}
            if ms_size is not None:
                logs["train_size"] = ms_size
            logs["lr"] = lr
            logs["epoch_time_s"] = time.time() - t0
            logs["images_per_s"] = (nb * train_ds.batch_size
                                    / max(logs["epoch_time_s"], 1e-9))

            if val_ds is not None:
                # one forward per val image: on epochs where the mAP policy
                # may fire, the loss pass stashes the grids and the mAP
                # reads the stash once the loss says whether it improved
                maybe_map = (epoch + 1) > cfg.train.map_eval_start_epoch
                stash = [] if maybe_map else None
                tv0 = time.time()
                val = self._validate(state, val_ds, dev_val, False, stash)
                val["val_s"] = time.time() - tv0
                improved = val["val_loss"] < best
                if self._should_eval_map(epoch, improved):
                    tm0 = time.time()
                    val["val_mAP"] = self._map_from_stash(stash)
                    if cfg.eval.coco_map:
                        val.update(self._coco_map_logs())
                    val["map_s"] = time.time() - tm0
                logs.update(val)
                if improved:
                    best = val["val_loss"]
                    since_best = 0
                else:
                    since_best += 1
                    if (reduce_on_plateau is not None
                            and since_best % reduce_on_plateau[1] == 0):
                        lr_scale *= reduce_on_plateau[0]
                        if verbose and self.is_main:
                            print(f"plateau: scaling LR by "
                                  f"{reduce_on_plateau[0]} -> scale "
                                  f"{lr_scale:.4g}")
                last_monitor = val["val_loss"]
                if (val["val_loss"] < best_saved and epoch - last_save
                        >= cfg.train.save_cooldown_epochs):
                    ts0 = time.time()
                    self.ckpt.save(epoch, state, {"val_loss": val["val_loss"]})
                    logs["save_s"] = time.time() - ts0
                    last_save = epoch
                    best_saved = val["val_loss"]
            else:
                last_monitor = logs.get("total", float("inf"))

            logs["wall_s"] = time.time() - t0
            self.logger.log(epoch, logs)
            if verbose and self.is_main:
                msg = " ".join(f"{k}={v:.5g}" for k, v in logs.items())
                print(f"epoch {epoch + 1}/{epoch_offset + epochs}: {msg}",
                      flush=True)
            if (early_stop_patience is not None
                    and since_best >= early_stop_patience):
                if verbose and self.is_main:
                    print(f"early stop at epoch {epoch + 1}")
                break

        # the resume point, and any improvement the cooldown deferred
        if epochs > 0 and last_save != epoch:
            self.ckpt.save(epoch, state, {"val_loss": float(last_monitor)})
        self.ckpt.wait()
        distributed.barrier(self.mesh.group)
        return state

    def evaluate(self, state: TrainState, ds: YoloDataset) -> Dict[str, float]:
        """Test-set loss and mAP (over the process group, as validation)."""
        return self._validate(state, ds, None, True)

    def close(self) -> None:
        self.ckpt.close()
        self.logger.close()
