"""Carry weights from the JAX package's flax variables to this port.

``flax_to_torch(params, batch_stats)`` takes the two flax trees as nested
dicts of numpy arrays (e.g. ``jax.device_get(variables)``; restoring an orbax
checkpoint needs JAX and stays outside the port) and returns the port's
``state_dict``:

- conv kernels go from HWIO to OIHW,
- BatchNorm ``scale / bias / mean / var`` become ``weight / bias /
  running_mean / running_var``.

Any name, rank or module it does not recognise raises, and so does a module
with a missing leaf. Given ``model``, the result must also match that
model's keys and shapes exactly.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_TOP = {"DarknetBackbone_0": "backbone", "ConvHead_0": "head"}
# (module kind, flax leaf) -> (torch leaf, rank)
_LEAVES = {
    ("conv", "kernel"): ("weight", 4),
    ("conv", "bias"): ("bias", 1),
    ("bn", "scale"): ("weight", 1),
    ("bn", "bias"): ("bias", 1),
    ("bn", "mean"): ("running_mean", 1),
    ("bn", "var"): ("running_var", 1),
}
_COMPLETE = {"conv": {"weight", "bias"},
             "bn": {"weight", "bias", "running_mean", "running_var"}}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_path(path: Tuple[str, ...]) -> Tuple[str, str]:
    """flax module names -> (torch module path, kind)."""
    where = "/".join(path)
    if not path or path[0] not in _TOP:
        raise ValueError(f"unknown flax module {where!r}")
    top = _TOP[path[0]]
    rest = path[1:]
    if len(rest) == 2 and rest[0].startswith("ConvBlock_"):
        m = re.fullmatch(r"ConvBlock_(\d+)", rest[0])
        if m is None or (top == "head" and m.group(1) != "0"):
            raise ValueError(f"unknown flax module {where!r}")
        block = f"blocks.{m.group(1)}" if top == "backbone" else "block"
        kind = {"Conv_0": "conv", "BatchNorm_0": "bn"}.get(rest[1])
        if kind is None:
            raise ValueError(f"unknown flax module {where!r}")
        return f"{top}.{block}.{kind}", kind
    if top == "head" and rest == ("Conv_0",):
        return "head.conv", "conv"
    raise ValueError(f"unknown flax module {where!r}")


def flax_to_torch(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                  model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """flax ``params`` + ``batch_stats`` -> the port's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    kinds: Dict[str, str] = {}
    for tree, allowed in ((params, {"kernel", "bias", "scale"}),
                          (batch_stats, {"mean", "var"})):
        for path, value in _flatten(tree):
            module, kind = _module_path(path[:-1])
            leaf = path[-1]
            if leaf not in allowed or (kind, leaf) not in _LEAVES:
                raise ValueError(f"unknown flax leaf {'/'.join(path)!r}")
            name, rank = _LEAVES[(kind, leaf)]
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim != rank:
                raise ValueError(f"{'/'.join(path)!r} has shape {arr.shape}, "
                                 f"expected rank {rank}")
            if rank == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            key = f"{module}.{name}"
            if key in out:
                raise ValueError(f"two flax leaves map to {key!r}")
            out[key] = torch.from_numpy(np.array(arr, order="C"))
            kinds[module] = kind
    for module, kind in kinds.items():
        missing = {n for n in _COMPLETE[kind] if f"{module}.{n}" not in out}
        if missing:
            raise ValueError(f"{module!r} lacks {sorted(missing)}")
    if model is not None:
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in out.items()}
        if want != got:
            extra = sorted(set(got) - set(want))
            lacking = sorted(set(want) - set(got))
            shapes = sorted(k for k in set(got) & set(want) if got[k] != want[k])
            raise ValueError(f"flax tree does not match the model: keys the "
                             f"model lacks {extra}, keys missing {lacking}, "
                             f"shape mismatches {shapes}")
    return out
