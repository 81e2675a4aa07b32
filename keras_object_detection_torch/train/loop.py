"""The train step (counterpart of ``keras_object_detection_tpu/train/loop.py``
``TrainState``, ``create_train_state``, ``set_learning_rate`` and
``make_train_step`` for the v1 conv head):

    state = create_train_state(cfg, generator, device)
    step = make_train_step(cfg)
    state, metrics = step(state, images_u8, boxes, valid, seed)

One step: augmentation draws -> ``augment_batch`` -> ``encode_grid`` ->
forward with training-mode BatchNorm -> the v1 loss -> backward -> the
optimizer update, the BN running statistics (updated in the forward) and the
parameter EMA. ``TrainConfig.use_pallas_loss`` selects the fused loss with
its kernels, ``ModelConfig.bn_mode="fused"`` the BN-statistics kernels.

Unlike the JAX step, which returns a new state, this one updates the model,
the optimizer moments and the EMA in place (no second copy of ~4x the
parameters) and returns the same ``state``. ``create_train_state`` and the
step run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from keras_object_detection_torch.config import Config, check_ported
from keras_object_detection_torch.core.grid import encode_grid
from keras_object_detection_torch.data.augment import (AugmentDraws,
                                                       augment_batch,
                                                       sample_augment_draws)
from keras_object_detection_torch.losses.yolo import yolo_v1_loss_terms
from keras_object_detection_torch.models.yolo import YoloV1, build_model
from keras_object_detection_torch.ops.yolo_loss import fused_yolo_v1_loss
from keras_object_detection_torch.train import optim


@dataclasses.dataclass
class TrainState:
    """The model (on its device, in training mode; its buffers hold the BN
    running statistics), the optimizer state, the step count and the EMA of
    the parameters (``None`` without ``TrainConfig.ema_decay``)."""

    model: YoloV1
    opt: optim.OptState
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the GPU by default and none is "
                           "available; pass device='cpu' to train on the CPU")
    return dev


def create_train_state(config: Config,
                       generator: Optional[torch.Generator] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> TrainState:
    """The model of ``config`` with weights drawn from ``generator``
    (default: seeded with ``config.train.seed``), moved to ``device``
    (default ``cuda``) in ``channels_last`` memory, and its optimizer at
    ``config.train.schedule.base_lr``."""
    check_ported(config, training=True)
    dev = _device(device)
    model = build_model(config, generator)
    model = model.to(dev, memory_format=torch.channels_last).train()
    params = list(model.parameters())
    opt = optim.init_opt_state(config.train.optimizer, params,
                               config.train.schedule.base_lr)
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


def make_train_step(config: Config):
    """Build ``step(state, images_u8, boxes, valid, seed, draws=None)``.

    ``images_u8`` is ``(B, H, W, 3)`` uint8, ``boxes`` ``(B, N, 5)``
    ``[cx, cy, w, h, class]`` and ``valid`` ``(B, N)``; they are moved to
    the model's device. ``seed`` (an int >= 0) with ``state.step`` seeds the
    augmentation draws; ``draws`` (one ``AugmentDraws`` per microbatch)
    replaces them, so a test can feed the JAX step's own.

    With ``grad_accum_steps = k`` the batch is cut into k strided
    microbatches (rows ``i::k``), their gradients and loss terms summed, and
    the BN running statistics updated by each in turn. Returns the state and
    the metrics: ``{"total"}`` on the fused-loss path, the five loss terms
    on the plain one, as 0-dim tensors on the device."""
    check_ported(config, training=True)
    g, d, t = config.grid, config.data, config.train
    accum = max(t.grad_accum_steps or 1, 1)
    out_size = config.model.image_size

    def loss_terms(y_true, y_pred) -> Dict[str, torch.Tensor]:
        if t.use_pallas_loss:
            return {"total": fused_yolo_v1_loss(
                y_true, y_pred, g.num_classes, g.num_boxes, t.lambda_coord,
                t.lambda_noobj, t.noobj_mode)}
        return yolo_v1_loss_terms(y_true, y_pred, g.num_classes, g.num_boxes,
                                  t.lambda_coord, t.lambda_noobj, t.noobj_mode,
                                  t.box_loss_mode)

    def backward_on(model, images_u8, boxes, valid, draws):
        images, aboxes, avalid = augment_batch(
            images_u8, boxes, valid, draws, hflip_prob=d.hflip_prob,
            color_strengths=tuple(d.color_jitter),
            crop_ratio=tuple(d.crop_ratio), min_visibility=d.min_visibility,
            out_size=out_size)
        y_true = encode_grid(aboxes, avalid, g.num_classes, g.num_boxes, g.grid)
        terms = loss_terms(y_true, model(images))
        terms["total"].backward()
        return {k: v.detach() for k, v in terms.items()}

    def step(state: TrainState, images_u8, boxes, valid, seed: int,
             draws: Optional[Union[AugmentDraws, Sequence[AugmentDraws]]] = None):
        model = state.model
        params = list(model.parameters())
        dev = params[0].device
        images_u8 = torch.as_tensor(images_u8).to(dev)
        boxes = torch.as_tensor(boxes).to(dev, torch.float32)
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        b = images_u8.shape[0]
        if b % accum:
            raise ValueError(f"grad_accum_steps={accum} must divide the batch "
                             f"size {b}")
        if draws is None:
            draws = [sample_augment_draws(
                b // accum, step_generator(seed, state.step,
                                           i if accum > 1 else None),
                tuple(d.color_jitter), tuple(d.crop_scale), tuple(d.crop_ratio))
                for i in range(accum)]
        elif isinstance(draws, AugmentDraws):
            draws = [draws]
        if len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")

        model.train()
        for p in params:
            p.grad = None
        metrics: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            rows = slice(i, None, accum)
            terms = backward_on(model, images_u8[rows], boxes[rows],
                                valid[rows], draws[i].to(dev))
            metrics = {k: metrics[k] + v if k in metrics else v
                       for k, v in terms.items()}
        optim.apply_updates(state.opt, params, [p.grad for p in params])
        if state.ema is not None:
            decay = t.ema_decay
            with torch.no_grad():
                for n, p in model.named_parameters():
                    e = state.ema[n]
                    e.copy_(decay * e + (1.0 - decay) * p)
        state.step += 1
        return state, metrics

    return step
