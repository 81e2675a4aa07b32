"""Carry weights from the JAX package's flax variables to this port.

``flax_to_torch(params, batch_stats)`` takes the two flax trees as nested
dicts of numpy arrays (e.g. ``jax.device_get(variables)``; restoring an orbax
checkpoint needs JAX and stays outside the port) and returns the port's
``state_dict``:

- conv kernels go from HWIO to OIHW (a depthwise ``(k, k, 1, C)`` kernel to
  ``(C, 1, k, k)``); MobileNetV2's convs have no bias leaf,
- Dense kernels go from ``(in, out)`` to ``(out, in)``; the port flattens
  in NHWC order as JAX does, so a flatten_dense kernel needs no other
  permutation,
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

# top-level flax module -> (torch module, [(flax path below it, torch path,
# kind)]); the paths are regular expressions matched whole
_CONV_BLOCK = [(r"ConvBlock_(\d+)/Conv_0", r"blocks.\1.conv", "conv"),
               (r"ConvBlock_(\d+)/BatchNorm_0", r"blocks.\1.bn", "bn")]
_LAYOUT = {
    "DarknetBackbone_0": ("backbone", _CONV_BLOCK),
    "VGG16Backbone_0": ("backbone", [(r"Conv_(\d+)", r"convs.\1", "conv")]),
    "MobileNetV2Backbone_0": ("backbone", [
        (r"Conv_([01])", r"convs.\1", "conv_nobias"),
        (r"BatchNorm_([01])", r"bns.\1", "bn"),
        (r"_InvertedResidual_(\d+)/Conv_([012])", r"blocks.\1.convs.\2",
         "conv_nobias"),
        (r"_InvertedResidual_(\d+)/BatchNorm_([012])", r"blocks.\1.bns.\2",
         "bn")]),
    "ConvHead_0": ("head", [(r"ConvBlock_0/Conv_0", "block.conv", "conv"),
                            (r"ConvBlock_0/BatchNorm_0", "block.bn", "bn"),
                            (r"Conv_0", "conv", "conv")]),
    "PassthroughConvHead_0": ("head", _CONV_BLOCK + [
        (r"Conv_0", "conv", "conv")]),
    "FPNHead_0": ("head", _CONV_BLOCK + [
        (r"Conv_(\d+)", r"convs.\1", "conv")]),
    "GAPDenseHead_0": ("head", [(r"Dense_([01])", r"denses.\1", "dense"),
                                (r"BatchNorm_0", "bn", "bn")]),
    "MultiConvDenseHead_0": ("head", _CONV_BLOCK + [
        (r"Dense_(\d+)", r"denses.\1", "dense")]),
}
# (module kind, flax leaf) -> (torch leaf, rank)
_LEAVES = {
    ("conv", "kernel"): ("weight", 4),
    ("conv", "bias"): ("bias", 1),
    ("conv_nobias", "kernel"): ("weight", 4),
    ("dense", "kernel"): ("weight", 2),
    ("dense", "bias"): ("bias", 1),
    ("bn", "scale"): ("weight", 1),
    ("bn", "bias"): ("bias", 1),
    ("bn", "mean"): ("running_mean", 1),
    ("bn", "var"): ("running_var", 1),
}
_COMPLETE = {"conv": {"weight", "bias"}, "conv_nobias": {"weight"},
             "dense": {"weight", "bias"},
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
    if path and path[0] in _LAYOUT:
        top, rules = _LAYOUT[path[0]]
        rest = "/".join(path[1:])
        for pattern, name, kind in rules:
            m = re.fullmatch(pattern, rest)
            if m is not None:
                return f"{top}.{m.expand(name)}", kind
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
            elif rank == 2:
                arr = arr.T  # (in, out) -> (out, in)
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
