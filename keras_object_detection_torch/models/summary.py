"""Model summary (counterpart of
``keras_object_detection_tpu/models/summary.py``). The model is built on
PyTorch's ``meta`` device, so neither function draws or stores a weight."""

from __future__ import annotations

import torch

from keras_object_detection_torch.config import Config
from keras_object_detection_torch.models.yolo import build_model


def _meta_model(config: Config):
    with torch.device("meta"):
        return build_model(config)


def count_params(config: Config) -> int:
    """Total parameter count (BatchNorm running statistics excluded, as the
    JAX package counts only ``params``)."""
    return sum(p.numel() for p in _meta_model(config).parameters())


def summarize(config: Config, depth: int = 2) -> str:
    """A plain-text table of the modules down to ``depth`` levels: name,
    class, parameter count and the shapes of the module's own parameters
    (one level deeper are counted in the total)."""
    model = _meta_model(config)
    rows = [("module", "class", "params", "own parameter shapes")]
    for name, module in model.named_modules():
        level = 0 if not name else name.count(".") + 1
        if level > depth:
            continue
        own = [f"{n}{list(p.shape)}" for n, p in
               module.named_parameters(recurse=False)]
        rows.append((name or "(model)", type(module).__name__,
                     f"{sum(p.numel() for p in module.parameters()):,}",
                     " ".join(own)))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    lines = ["  ".join(r[i].ljust(widths[i]) for i in range(3)) + "  " + r[3]
             for r in rows]
    lines.append(f"total parameters: {count_params(config):,}")
    return "\n".join(line.rstrip() for line in lines)
