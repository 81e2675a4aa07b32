"""Column-parallel placement of a train state on a mesh's model axis (tensor
parallelism).

The JAX package has no counterpart module: it places the state with
``state_sharding`` (``parallel/mesh.py``) and XLA's partitioner writes the
program, all-gathering a sharded layer's output where a consumer needs it.
Here that program is written out. ``shard_state`` cuts each kernel that
``state_sharding`` shards (a ``Conv2d`` or ``Dense`` weight, dim 0 = the
output features) into this rank's shard, and its optimizer moments and EMA
copy with it. Such a layer then

- takes its whole input through ``distributed.copy_in`` (its backward sums
  the ranks' parts of the input gradient over the model group),
- computes its shard of output features, with its slice of the
  replicated bias,
- and gathers the shards over the model group
  (``distributed.gather_channels``; its backward takes this rank's slice).

A sharded ``ConvBlock`` runs its BatchNorm and activation on its channel
shard and gathers after them, so the BatchNorm statistics kernels see
``(M, C / tp)``; their sums are all-reduced over the data group only.

The 1-D parameters of the sharded channels (the conv or Dense bias, the
BatchNorm scale and bias) stay whole and replicated, as in JAX: each rank
takes its slice, so its gradient of them is zero outside that slice, and
``reduce_partial_grads`` sums them over the model group; the new running
statistics of the slice are gathered in the forward. Every rank then ends
a step with the same replicated state. ``full_tensors`` and ``cut_tensors``
map between a sharded state and whole tensors, for checkpoints that any
mesh restores.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from keras_object_detection_torch.parallel import distributed
from keras_object_detection_torch.parallel.mesh import (TP_MIN_ELEMENTS,
                                                        Mesh, state_sharding)


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnShard:
    """This rank's position ``rank`` of ``size`` on the model axis and the
    model group that joins them. Copies of a module share it (a process
    group is a handle, not a value)."""

    group: Any
    rank: int
    size: int

    def cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` along dim 0 (a view)."""
        n = t.shape[0] // self.size
        return t.narrow(0, self.rank * n, n)

    def __deepcopy__(self, memo):
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """What ``shard_state`` did to a model: the parameters cut on dim 0
    (``sharded``) and the replicated ones whose gradient each rank computes
    only on its slice (``partial``)."""

    shard: ColumnShard
    sharded: Tuple[str, ...]
    partial: Tuple[str, ...]

    def __deepcopy__(self, memo):
        return self


def placement(model: nn.Module) -> Optional[Placement]:
    """The model's ``Placement``, None where it is not sharded."""
    return getattr(model, "tensor_parallel", None)


def shard_state(state, mesh: Mesh, min_elements: int = TP_MIN_ELEMENTS):
    """``state`` (a ``train.TrainState`` of whole tensors) placed on
    ``mesh``'s model axis in place, as JAX's ``jax.device_put(state,
    state_sharding(mesh, state))``: each parameter ``state_sharding``
    shards, its moments and its EMA copy cut to this rank's shard, its
    layer made column-parallel (module docstring). A mesh without a model
    axis leaves it as it is. Returns ``state``."""
    from keras_object_detection_torch.models.layers import (Conv2d,
                                                            ConvBlock, Dense)

    if mesh.model_parallel == 1:
        return state
    if mesh.group is None:
        raise ValueError("tensor parallelism trains on a process mesh (one "
                         "process a position)")
    model = state.model
    if placement(model) is not None:
        raise ValueError("the state is already placed on a model axis")
    specs = state_sharding(mesh, dict(model.named_parameters()),
                           mesh.model_axis, min_elements)
    names = [n for n, spec in specs.items() if spec]
    shard = ColumnShard(mesh.model_group, mesh.model_index,
                        mesh.model_parallel)
    order = [n for n, _ in model.named_parameters()]
    partial = []
    for name in names:
        prefix, leaf = name.rsplit(".", 1)
        layer = model.get_submodule(prefix)
        if leaf != "weight" or not isinstance(layer, (Conv2d, Dense)) or \
                getattr(layer, "groups", 1) != 1:
            raise ValueError(f"{name}: state_sharding shards it, and it is "
                             "no column-parallel layer's weight")
        layer.weight = nn.Parameter(shard.cut(layer.weight.detach()).clone())
        layer.shard = shard
        if layer.bias is not None:
            partial.append(f"{prefix}.bias")
    for prefix, block in model.named_modules():
        if isinstance(block, ConvBlock) and block.conv.shard is not None:
            block.place(shard)
            partial += [f"{prefix}.bn.weight", f"{prefix}.bn.bias"]
    model.tensor_parallel = Placement(shard, tuple(names), tuple(partial))
    opt = state.opt
    for moments in (m for m in (opt.mu, opt.nu, opt.trace) if m):
        for name in names:
            i = order.index(name)
            moments[i] = shard.cut(moments[i]).clone()
    if state.ema is not None:
        for name in names:
            state.ema[name] = shard.cut(state.ema[name]).clone()
    return state


def reduce_partial_grads(model: nn.Module) -> None:
    """Sum the ``partial`` parameters' gradients over the model group (each
    rank's is zero outside its slice, so the sum is the whole gradient,
    exactly)."""
    pl = placement(model)
    if pl is None:
        return
    params = dict(model.named_parameters())
    distributed.all_reduce_flat_(
        [params[n].grad for n in pl.partial if params[n].grad is not None],
        pl.shard.group)


def full_tensors(model: nn.Module, named: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``named`` (parameter name -> tensor: the state dict, the EMA) with
    the sharded entries gathered whole over the model group (every rank of
    the group takes part)."""
    pl = placement(model)
    if pl is None:
        return dict(named)
    return {k: distributed.all_gather_dim(v.detach(), 0, pl.shard.group)
            if k in pl.sharded else v for k, v in named.items()}


def cut_tensors(model: nn.Module, named: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """``named`` whole tensors with the sharded entries cut to this rank's
    shard (a whole tensor restores into any mesh)."""
    pl = placement(model)
    if pl is None:
        return dict(named)
    return {k: pl.shard.cut(v) if k in pl.sharded else v
            for k, v in named.items()}

