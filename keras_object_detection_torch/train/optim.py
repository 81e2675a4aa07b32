"""Optimizers with optax's arithmetic, written out by hand (counterpart of
``keras_object_detection_tpu/train/loop.py`` ``_make_optimizer`` for
``adam``, ``nadam`` and ``sgd`` under ``optax.inject_hyperparams``).

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
- ``u = mu_hat / (sqrt(nu_hat) + eps)``, then ``p + (-lr) * u``.

The learning rate is a float32 tensor in the state (optax's injected
hyperparameter): ``set_learning_rate`` swaps it without rebuilding anything.
Parameters are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

def _f32(x) -> float:
    return float(np.float32(x))


# inject_hyperparams holds b1, b2 and eps as float32 arrays too, so 1 - b1
# is a float32 subtraction (0.10000002, not 0.1)
B1, B2, EPS = _f32(0.9), _f32(0.999), _f32(1e-8)
ONE_MINUS_B1 = _f32(np.float32(1.0) - np.float32(B1))
ONE_MINUS_B2 = _f32(np.float32(1.0) - np.float32(B2))


@dataclasses.dataclass
class OptState:
    """``name`` (adam | nadam | sgd), the learning rate (a 0-dim float32
    tensor on the parameters' device), optax's step ``count`` and, for adam
    and nadam, the moments ``mu`` and ``nu`` (one per parameter)."""

    name: str
    lr: torch.Tensor
    count: int = 0
    mu: List[torch.Tensor] = dataclasses.field(default_factory=list)
    nu: List[torch.Tensor] = dataclasses.field(default_factory=list)


def init_opt_state(name: str, params: Sequence[torch.Tensor],
                   lr: float) -> OptState:
    if name not in ("adam", "nadam", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}; options: adam, nadam, sgd")
    device = params[0].device if params else torch.device("cpu")
    state = OptState(name, torch.tensor(lr, dtype=torch.float32, device=device))
    if name != "sgd":
        state.mu = [torch.zeros_like(p) for p in params]
        state.nu = [torch.zeros_like(p) for p in params]
    return state


def set_learning_rate(state: OptState, lr: float) -> None:
    """Swap the learning rate in place (no allocation on the device)."""
    state.lr.fill_(lr)


def _bias_correction(decay: float, count: int, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor on the device: a true division, as XLA does (a CPU
    # scalar divisor becomes a multiply by its reciprocal on the GPU)
    value = np.float32(1.0) - np.float32(np.float64(np.float32(decay)) ** count)
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply_updates(state: OptState, params: Sequence[torch.Tensor],
                  grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step: update ``params`` in place from ``grads``."""
    neg_lr = -state.lr
    if state.name == "sgd":
        for p, g in zip(params, grads):
            p.copy_(p + neg_lr * g)
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
        p.copy_(p + neg_lr * u)
    state.count = count
