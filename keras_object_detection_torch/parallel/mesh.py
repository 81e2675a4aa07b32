"""Device meshes (counterpart of ``keras_object_detection_tpu/parallel/mesh.py``).

JAX's parallelism is one program over a global batch: inputs sharded on the
mesh's data axis, parameters replicated or, the large kernels
(``state_sharding``), sharded on the model axis, the collectives inserted
by XLA. A ``Mesh`` here holds the same two axes and comes in two kinds:

- a **process mesh** (``group`` set): one process a position, joined by a
  ``torch.distributed`` process group and laid out row-major as JAX's
  ``mesh_utils`` lays ``(dp, tp)``: rank r sits at data ``r // tp``, model
  ``r % tp``. Training runs so, each rank on the row block of its data
  index, with the collectives of ``parallel/distributed.py`` where XLA
  would insert them: over the **data group** (the ranks of one model
  index) the gradients and the BatchNorm statistics, over the **model
  group** (the ranks of one data index) the column-parallel layers'
  gathers (``parallel/tensor.py``);
- a **device mesh** (``devices`` set, data-major): one process driving
  every device, each with a replica of the weights, as JAX's ``shard_map``
  serving does; serving and standalone evaluation run so. The batch splits
  over the data axis and the model axis replicates it: the model axis's
  positions of one data row would compute the same rows, so each row is
  served once, by the first device of its data row (``data_devices``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# Tensor-parallel threshold (JAX's): a tensor of at least this many values
# has its output-features dim sharded over the model axis. 1M values catch
# the dense-head kernels and the widest darknet conv filters (3x3x1024x1024
# = 9.4M values) and leave small filters, biases and BatchNorm vectors
# replicated.
TP_MIN_ELEMENTS = 1 << 20


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``data_parallel`` x ``model_parallel`` positions; either ``devices``
    (a device mesh, data-major) or ``group`` (a process mesh, in which this
    process is position ``index`` of the data axis and ``model_index`` of
    the model axis, with its ``data_group`` and ``model_group``; a group of
    one rank is None, which no collective touches)."""

    data_parallel: int
    model_parallel: int = 1
    devices: Tuple[torch.device, ...] = ()
    group: Any = None
    index: int = 0
    data_axis: str = "data"
    model_axis: str = "model"
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self):
        """JAX's ``mesh.shape``: axis name -> size."""
        return {self.data_axis: self.data_parallel,
                self.model_axis: self.model_parallel}

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """A device mesh's first device of each data row, in data order."""
        return self.devices[::self.model_parallel]


def local_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises where there is none (no
    quiet fall back to the CPU: a CPU mesh names its devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh takes the GPUs by default and none is "
                           "available; pass device='cpu' (a mesh: "
                           "devices=['cpu', ...]) to run on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _axis_groups(group, dp: int, tp: int):
    """``(data index, model index, data group, model group)`` of this rank
    in the row-major ``dp`` x ``tp`` layout of ``group``'s ranks. Over the
    whole world every rank creates every subgroup, the data groups then the
    model groups, as ``torch.distributed.new_group`` asks; within a
    subgroup of the world each rank creates only the two it belongs to
    (local synchronisation), so the subgroup's ranks must share their
    history of group creation."""
    members = dist.get_process_group_ranks(group)
    d, m = divmod(dist.get_rank(group), tp)
    if tp == 1:
        return d, m, group, None
    if dp == 1:
        return d, m, None, group
    datas = [[members[i * tp + j] for i in range(dp)] for j in range(tp)]
    models = [members[i * tp:(i + 1) * tp] for i in range(dp)]
    if len(members) == dist.get_world_size():
        groups = [dist.new_group(ranks) for ranks in datas + models]
        return d, m, groups[m], groups[tp + d]
    return d, m, *(dist.new_group(ranks, use_local_synchronization=True)
                   for ranks in (datas[m], models[d]))


def create_mesh(data_parallel: int = -1, model_parallel: int = 1,
                data_axis: str = "data", model_axis: str = "model",
                devices: Optional[Sequence[Union[str, torch.device]]] = None,
                group: Any = None) -> Mesh:
    """A ``(data, model)`` mesh; ``data_parallel=-1`` takes every position
    the model axis leaves.

    ``devices`` given: a device mesh over them (a device may repeat: two
    replicas on one card). Otherwise, within a process group (``group``, or
    the default one once started): a process mesh over its ranks, with its
    data and model subgroups; else a device mesh over ``local_devices()``.
    Raises JAX's ``"mesh AxB != N devices"`` where the axes do not cover
    the positions."""
    if devices is None and group is None and dist.is_initialized():
        group = dist.group.WORLD
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
    elif group is not None:
        devs = ()
    else:
        devs = tuple(local_devices())
    n = len(devs) if devices is not None or group is None else \
        dist.get_world_size(group)
    if data_parallel == -1:
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} "
                         "devices")
    if group is None:
        return Mesh(data_parallel, model_parallel, devs, None, 0, data_axis,
                    model_axis)
    index, model_index, data, model = _axis_groups(group, data_parallel,
                                                   model_parallel)
    return Mesh(data_parallel, model_parallel, devs, group, index, data_axis,
                model_axis, model_index, data, model)


def shard_rows(batch: int, dp: int, what: str = "batch") -> List[slice]:
    """The ``dp`` contiguous row blocks of a global batch, raising where
    ``dp`` does not divide it."""
    if batch % dp:
        raise ValueError(f"{what} {batch} must divide by the data-parallel "
                         f"mesh size {dp}")
    n = batch // dp
    return [slice(i * n, (i + 1) * n) for i in range(dp)]


def _moved(v, dev: torch.device):
    """``v`` with every module and tensor in it (in dicts, lists and
    tuples too) copied to ``dev``; a module of meta tensors (weights passed
    at each call) is copied as it is."""
    if isinstance(v, torch.nn.Module):
        v = copy.deepcopy(v)
        return v if any(t.is_meta for t in v.parameters()) else v.to(dev)
    if isinstance(v, torch.Tensor):
        return v.to(dev, copy=True)
    if isinstance(v, dict):
        return {k: _moved(x, dev) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_moved(x, dev) for x in v)
    return v


def replicate(obj, devices: Sequence[torch.device], home: torch.device,
              device_attr: Optional[str] = None) -> List[Any]:
    """One replica of ``obj`` (which lives on ``home``) a position of a
    device mesh's ``devices``, as JAX's replicated weights under
    ``shard_map``: the first is ``obj`` itself where ``home`` is the first
    device, every other a shallow copy whose attributes' modules and
    tensors are copied to its device (its ``device_attr`` set to it)."""
    out = []
    for i, dev in enumerate(devices):
        if i == 0 and dev == home:
            out.append(obj)
            continue
        rep = copy.copy(obj)
        rep.__dict__ = {k: _moved(v, dev) for k, v in vars(obj).items()}
        if device_attr:
            setattr(rep, device_attr, dev)
        out.append(rep)
    return out


def map_shards(fn: Callable, replicas: Sequence[Any], device: torch.device,
               *batch: Optional[torch.Tensor]):
    """``fn(replica, *shard)`` for each replica on its contiguous row block
    of every tensor of ``batch`` (``None`` passed as is), in mesh order;
    the outputs (tensors, or tuples of them) concatenated in batch order on
    ``device``."""
    rows = shard_rows(batch[0].shape[0], len(replicas))
    outs = [fn(rep, *(None if t is None else t[r] for t in batch))
            for rep, r in zip(replicas, rows)]

    def cat(parts):
        if isinstance(parts[0], tuple):
            return tuple(cat(list(p)) for p in zip(*parts))
        return torch.cat([p.to(device) for p in parts])

    return cat(outs)


def batch_sharding(mesh: Mesh, data_axis: str = "data"
                   ) -> Callable[[torch.Tensor], Any]:
    """What JAX's ``NamedSharding(mesh, P(data))`` does to a global batch:
    on a process mesh, the function that keeps the row block of this rank's
    data index (the model axis's ranks of a data row hold the same block);
    on a device mesh, the function that cuts it into one block a data row,
    each on the row's first device (``Mesh.data_devices``)."""
    del data_axis  # one data axis
    if mesh.group is not None:
        def local(x):
            return x[shard_rows(x.shape[0], mesh.data_parallel)[mesh.index]]

        return local

    def split(x):
        return [x[s].to(d) for s, d in zip(
            shard_rows(x.shape[0], mesh.data_parallel), mesh.data_devices)]

    return split


def replicated_sharding(mesh: Mesh) -> Callable[[torch.Tensor], Any]:
    """JAX's ``NamedSharding(mesh, P())``: on a process mesh every rank
    already holds its own copy (the identity); on a device mesh, a copy on
    each device."""
    if mesh.group is not None:
        return lambda x: x
    return lambda x: [x.to(d, copy=True) for d in mesh.devices]


def column_shardable(x, tp: int, min_elements: int) -> bool:
    """``state_sharding``'s rule for one leaf on a model axis of ``tp``
    positions (module docstring there)."""
    return (isinstance(x, torch.Tensor) and x.dim() >= 2
            and x.numel() >= min_elements and x.shape[0] % tp == 0)


def state_sharding(mesh: Mesh, tree, model_axis: str = "model",
                   min_elements: int = TP_MIN_ELEMENTS):
    """The placement of each tensor of ``tree`` (nested dicts, lists and
    tuples; a train state's parameters, optimizer moments or EMA) as a
    spec in JAX's ``PartitionSpec`` form: a tensor of rank 2 or more, of
    at least ``min_elements`` values, whose output-features dim divides by
    the model axis is sharded on that dim over the model axis,
    ``(model_axis, None, ...)``; every other leaf is replicated, ``()``.

    JAX's rule on JAX's shapes: its kernels are HWIO (conv) and ``(in,
    out)`` (Dense), the output features last; the port's are OIHW and
    ``(out, in)``, so the sharded dim is dim 0. The moments and EMA copies
    mirror their parameter's shape and take its placement. With
    ``model_parallel=1`` every leaf is replicated. As in JAX, tensor
    parallelism is scaffolding for this model family, not a speed feature:
    the model fits one device."""
    tp = mesh.shape[model_axis]

    def rule(x):
        if isinstance(x, dict):
            return {k: rule(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rule(v) for v in x)
        if tp > 1 and column_shardable(x, tp, min_elements):
            return (model_axis,) + (None,) * (x.dim() - 1)
        return ()

    return rule(tree)
