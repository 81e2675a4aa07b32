"""Learning-rate schedules (counterpart of
``keras_object_detection_tpu/train/schedules.py``, a copy of its numpy code):
the reference's piecewise warm-up and its modified cosine annealing with warm
restarts, as per-epoch LR arrays. The train step takes the epoch's LR
through ``train.loop.set_learning_rate``.
"""

from __future__ import annotations

import math

import numpy as np

from keras_object_detection_torch.config import ScheduleConfig


def piecewise_warmup_lr(epoch: int, base: float = 0.001, peak_delta: float = 0.009,
                        warmup_epochs: int = 75, mid_epochs: int = 105,
                        mid_lr: float = 1e-3, final_lr: float = 1e-4) -> float:
    """Linear warmup then two plateaus — exact reference arithmetic
    (ref train.py:126-135): ``0.001 + 0.009 * (epoch / 75)`` for the first 75
    epochs, ``1e-3`` until 105, then ``1e-4``."""
    if 0 <= epoch < warmup_epochs:
        return base + peak_delta * (float(epoch) / float(warmup_epochs))
    if warmup_epochs <= epoch < mid_epochs:
        return mid_lr
    return final_lr


def cosine_annealing_restarts_lrs(
    num_epochs: int,
    eta_max: float,
    eta_min: float = 0.0,
    t_max: int = 10,
    t_mult: int = 2,
    decay: float = 1.0,
) -> np.ndarray:
    """Per-epoch LRs of the reference's modified cosine annealing with warm
    restarts (ref cosine_annealing.py:21-43), reproduced stateful-exactly:

    - amplitude is the *modified* ``(3 + cos(theta)) / 4`` (half-depth dips,
      ref cosine_annealing.py:35), not the standard ``(1 + cos) / 2``,
    - after each cycle the period multiplies by ``t_mult``
      (ref cosine_annealing.py:41-43),
    - ``eta_max`` decays by ``decay`` once per cycle, triggered by the
      reference's mid-cycle flag handshake (ref cosine_annealing.py:28-33).
    """
    lrs = np.zeros(num_epochs, np.float64)
    prev_epochs = 0
    cur_t_max = t_max
    cur_eta_max = eta_max
    armed = False  # the reference's `self.bool`
    for epoch in range(num_epochs):
        e = epoch - prev_epochs
        theta = math.pi * e / cur_t_max
        c = math.cos(theta)
        if round(c, 6) < 1e-7 and not armed:
            armed = True
        if round(c, 3) > 0.9999 and armed:
            cur_eta_max = cur_eta_max * decay
            armed = False
        lrs[epoch] = eta_min + (cur_eta_max - eta_min) * (3.0 + c) / 4.0
        if e != 0 and e % cur_t_max == 0:
            prev_epochs = epoch + 1
            cur_t_max *= t_mult
    return lrs


def epoch_schedule(cfg: ScheduleConfig, total_epochs: int) -> np.ndarray:
    """Materialize any configured schedule as a per-epoch LR array."""
    if cfg.kind == "constant":
        return np.full(total_epochs, cfg.base_lr)
    if cfg.kind == "piecewise_warmup":
        return np.array(
            [
                piecewise_warmup_lr(
                    e, base=cfg.base_lr,
                    peak_delta=cfg.warmup_target - cfg.base_lr,
                    warmup_epochs=cfg.warmup_epochs, mid_epochs=cfg.mid_epochs,
                    mid_lr=cfg.mid_lr, final_lr=cfg.final_lr)
                for e in range(total_epochs)
            ]
        )
    if cfg.kind == "cosine_restarts":
        return cosine_annealing_restarts_lrs(
            total_epochs, eta_max=cfg.base_lr, eta_min=cfg.eta_min,
            t_max=cfg.t_max, t_mult=cfg.t_mult, decay=cfg.decay)
    raise ValueError(f"unknown schedule kind {cfg.kind!r}")
