"""Optimizers with optax's arithmetic, written out by hand (counterpart of
``keras_object_detection_tpu/train/loop.py`` ``_make_optimizer``: ``adam``,
``nadam``, ``sgd``, ``adamw`` and ``sgdw`` under
``optax.inject_hyperparams``).

``torch.optim.NAdam`` is not ``optax.nadam``: their parameters part by about
one step after three steps. So each update repeats optax's
``scale_by_adam`` (``nesterov=True`` for nadam), ``scale(-lr)`` and
``apply_updates`` operation by operation, in float32:

- ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g*g + b2 * nu``, with
  ``b1``, ``b2``, ``eps`` and ``1 - b`` in float32 as the injected
  hyperparameters are;
- bias corrections ``1 - b**count`` in float32, with ``b**count`` the
  correctly rounded power of the float32 ``b`` (as the compiled XLA ``pow``
  of optax's jitted bias correction gives it);
- nadam: ``mu_hat = b1 * mu / bc1(count + 1) + (1 - b1) * g / bc1(count)``;
- ``u = mu_hat / (sqrt(nu_hat) + eps)``, then ``p + (-lr) * u``;
- adamw (``optax.adamw``, no mask: every parameter decays, BatchNorm
  scale and bias and conv biases too): ``u = adam's u + wd * p``, then
  ``p + (-lr) * u``;
- sgdw (``add_decayed_weights`` then ``optax.sgd(momentum=0.9)``):
  ``trace = (g + wd * p) + 0.9 * trace``, then ``p + (-lr) * trace``.

``wd`` is ``TrainConfig.weight_decay`` as a float32 hyperparameter, as
``inject_hyperparams`` holds it.

The learning rate is a float32 tensor in the state (optax's injected
hyperparameter): ``set_learning_rate`` swaps it without rebuilding anything.
Parameters are updated in place.

``apply_updates`` sends parameters on the card to the multi-tensor kernel
(``ops/optim_update.py``, K6: one launch for up to 512 tensors, no copy to
the device, no synchronisation) and parameters on the CPU to
``apply_updates_plain``, the loop written out above, which the kernel equals
bit for bit on the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from keras_object_detection_torch.config import OPTIMIZERS
from keras_object_detection_torch.ops import optim_update


def _f32(x) -> float:
    return float(np.float32(x))


# inject_hyperparams holds b1, b2 and eps as float32 arrays too, so 1 - b1
# is a float32 subtraction (0.10000002, not 0.1)
B1, B2, EPS = _f32(0.9), _f32(0.999), _f32(1e-8)
ONE_MINUS_B1 = _f32(np.float32(1.0) - np.float32(B1))
ONE_MINUS_B2 = _f32(np.float32(1.0) - np.float32(B2))
MOMENTUM = _f32(0.9)  # sgdw's trace decay


@dataclasses.dataclass
class OptState:
    """``name`` (one of ``OPTIMIZERS``), the learning rate (a 0-dim float32
    tensor on the parameters' device), optax's step ``count``, for adam,
    nadam and adamw the moments ``mu`` and ``nu``, for sgdw the momentum
    ``trace`` (one per parameter), and the float32 ``weight_decay`` of
    adamw and sgdw (0 for the others)."""

    name: str
    lr: torch.Tensor
    count: int = 0
    mu: List[torch.Tensor] = dataclasses.field(default_factory=list)
    nu: List[torch.Tensor] = dataclasses.field(default_factory=list)
    trace: List[torch.Tensor] = dataclasses.field(default_factory=list)
    weight_decay: float = 0.0


def init_opt_state(name: str, params: Sequence[torch.Tensor], lr: float,
                   weight_decay: float = 0.0) -> OptState:
    """``weight_decay`` is read by adamw and sgdw only."""
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; options: "
                         f"{', '.join(OPTIMIZERS)}")
    device = params[0].device if params else torch.device("cpu")
    state = OptState(name, torch.tensor(lr, dtype=torch.float32, device=device))
    if name in ("adamw", "sgdw"):
        state.weight_decay = _f32(weight_decay)
    if name in ("adam", "nadam", "adamw"):
        state.mu = [torch.zeros_like(p) for p in params]
        state.nu = [torch.zeros_like(p) for p in params]
    if name == "sgdw":
        state.trace = [torch.zeros_like(p) for p in params]
    return state


def set_learning_rate(state: OptState, lr: float) -> None:
    """Swap the learning rate in place (no allocation on the device)."""
    state.lr.fill_(lr)


def _bias_correction_value(decay: float, count: int) -> np.float32:
    return np.float32(1.0) - np.float32(np.float64(np.float32(decay)) ** count)


def _bias_correction(decay: float, count: int, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor on the device: a true division, as XLA does (a CPU
    # scalar divisor becomes a multiply by its reciprocal on the GPU)
    return torch.tensor(_bias_correction_value(decay, count),
                        dtype=torch.float32, device=like.device)


def bias_corrections(count: int) -> Tuple[float, float, float]:
    """``(bc1, bc2, bc1_next)`` of optax's step ``count``, the float32
    values ``_bias_correction`` puts on the device, here as host floats:
    the kernel takes them by value."""
    return (float(_bias_correction_value(B1, count)),
            float(_bias_correction_value(B2, count)),
            float(_bias_correction_value(B1, count + 1)))


def apply_updates(state: OptState, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step: update ``params`` in place from ``grads``; on
    the card in one launch of K6 for up to 512 tensors, on the CPU by
    ``apply_updates_plain``."""
    if not (params and params[0].is_cuda):
        apply_updates_plain(state, params, grads)
        return
    count = state.count + 1
    optim_update.cuda_optim_update(
        state.name, params, grads, state.mu or state.trace, state.nu, state.lr,
        (B1, ONE_MINUS_B1, B2, ONE_MINUS_B2, EPS, *bias_corrections(count),
         state.weight_decay, MOMENTUM))
    state.count = count


@torch.no_grad()
def apply_updates_plain(state: OptState, params: Sequence[torch.Tensor],
                        grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step, one torch operation at a time: the plain
    version of K6, on any device."""
    neg_lr = -state.lr
    wd = state.weight_decay
    if state.name == "sgd":
        for p, g in zip(params, grads):
            p.copy_(p + neg_lr * g)
        state.count += 1
        return
    if state.name == "sgdw":
        for p, g, tr in zip(params, grads, state.trace):
            tr.copy_((g + wd * p) + MOMENTUM * tr)
            p.copy_(p + neg_lr * tr)
        state.count += 1
        return
    count = state.count + 1
    like = params[0]
    bc1 = _bias_correction(B1, count, like)
    bc2 = _bias_correction(B2, count, like)
    bc1_next = _bias_correction(B1, count + 1, like)
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        mu.copy_(ONE_MINUS_B1 * g + B1 * mu)
        nu.copy_(ONE_MINUS_B2 * (g * g) + B2 * nu)
        if state.name == "nadam":
            mu_hat = B1 * (mu / bc1_next) + ONE_MINUS_B1 * (g / bc1)
        else:
            mu_hat = mu / bc1
        u = mu_hat / (torch.sqrt(nu / bc2) + EPS)
        if state.name == "adamw":
            u = u + wd * p
        p.copy_(p + neg_lr * u)
    state.count = count
