"""Adam and Nadam as optax computes them (``scale_by_adam``, nesterov for
Nadam, then ``-lr``), in float32 with float32 hyperparameters."""

from __future__ import annotations

import numpy as np
import torch

B1, B2, EPS = (float(np.float32(x)) for x in (0.9, 0.999, 1e-8))
ONE_MINUS_B1 = float(np.float32(1.0) - np.float32(B1))
ONE_MINUS_B2 = float(np.float32(1.0) - np.float32(B2))


def _correction(decay: float, count: int, like: torch.Tensor):
    value = np.float32(1.0) - np.float32(np.float64(np.float32(decay)) ** count)
    return torch.tensor(value, dtype=torch.float32, device=like.device)


class Adam:
    """``mu``, ``nu`` and the step count of ``params``; ``step(grads)``
    updates the parameters in place."""

    def __init__(self, name: str, params, lr: float):
        if name not in ("adam", "nadam"):
            raise ValueError(f"the reference has no {name!r} optimizer")
        self.nesterov = name == "nadam"
        self.params = list(params)
        self.lr = torch.tensor(lr, dtype=torch.float32,
                               device=self.params[0].device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        like = self.params[0]
        bc1 = _correction(B1, self.count, like)
        bc2 = _correction(B2, self.count, like)
        bc1_next = _correction(B1, self.count + 1, like)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_(ONE_MINUS_B1 * g + B1 * mu)
            nu.copy_(ONE_MINUS_B2 * (g * g) + B2 * nu)
            mu_hat = (B1 * (mu / bc1_next) + ONE_MINUS_B1 * (g / bc1)
                      if self.nesterov else mu / bc1)
            p.copy_(p + (-self.lr) * (mu_hat / (torch.sqrt(nu / bc2) + EPS)))
