"""Device meshes (counterpart of ``keras_object_detection_tpu/parallel/mesh.py``).

JAX's data parallelism is one program over a global batch: inputs sharded
on the mesh's data axis, parameters replicated, the collectives inserted by
XLA. A ``Mesh`` here holds the same two axes and comes in two kinds:

- a **process mesh** (``group`` set): one process a device, joined by a
  ``torch.distributed`` process group; training runs so, each rank on its
  row block of the global batch, with the collectives of
  ``parallel/distributed.py`` where XLA would insert them;
- a **device mesh** (``devices`` set): one process driving every device
  of the data axis, each with a replica of the weights, as JAX's
  ``shard_map`` serving does; serving and standalone evaluation run so.

The model axis exists so that tensor parallelism can come later; a mesh
with ``model_parallel > 1`` raises (ROADMAP 1.15).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

TENSOR_PARALLEL = ("tensor parallelism (model_parallel > 1, state_sharding) "
                   "is not ported yet (ROADMAP 1.15)")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``data_parallel`` x ``model_parallel`` positions; either ``devices``
    (a device mesh, data-major) or ``group`` (a process mesh, in which this
    process is position ``index`` of the data axis)."""

    data_parallel: int
    model_parallel: int = 1
    devices: Tuple[torch.device, ...] = ()
    group: Any = None
    index: int = 0
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def shape(self):
        """JAX's ``mesh.shape``: axis name -> size."""
        return {self.data_axis: self.data_parallel,
                self.model_axis: self.model_parallel}


def local_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises where there is none (no
    quiet fall back to the CPU: a CPU mesh names its devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh takes the GPUs by default and none is "
                           "available; pass device='cpu' (a mesh: "
                           "devices=['cpu', ...]) to run on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def create_mesh(data_parallel: int = -1, model_parallel: int = 1,
                data_axis: str = "data", model_axis: str = "model",
                devices: Optional[Sequence[Union[str, torch.device]]] = None,
                group: Any = None) -> Mesh:
    """A ``(data, model)`` mesh; ``data_parallel=-1`` takes every position.

    ``devices`` given: a device mesh over them (a device may repeat: two
    replicas on one card). Otherwise, within a process group (``group``, or
    the default one once started): a process mesh over its ranks; else a
    device mesh over ``local_devices()``. Raises JAX's ``"mesh AxB != N
    devices"`` where the axes do not cover the positions, and
    ``NotImplementedError`` for a model axis (tensor parallelism)."""
    if model_parallel != 1:
        raise NotImplementedError(TENSOR_PARALLEL)
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
    return Mesh(data_parallel, model_parallel, devs, group,
                dist.get_rank(group) if group is not None else 0,
                data_axis, model_axis)


def check_data_parallel(mesh: Mesh) -> None:
    """Raise on a mesh with a model axis (tensor parallelism)."""
    if mesh.model_parallel != 1:
        raise NotImplementedError(TENSOR_PARALLEL)


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
    on a process mesh, the function that keeps this rank's row block; on a
    device mesh, the function that cuts it into one block a device, each on
    its device."""
    del data_axis  # one data axis
    check_data_parallel(mesh)
    if mesh.group is not None:
        def local(x):
            return x[shard_rows(x.shape[0], mesh.data_parallel)[mesh.index]]

        return local

    def split(x):
        return [x[s].to(d) for s, d in zip(
            shard_rows(x.shape[0], mesh.data_parallel), mesh.devices)]

    return split


def replicated_sharding(mesh: Mesh) -> Callable[[torch.Tensor], Any]:
    """JAX's ``NamedSharding(mesh, P())``: on a process mesh every rank
    already holds its own copy (the identity); on a device mesh, a copy on
    each device."""
    check_data_parallel(mesh)
    if mesh.group is not None:
        return lambda x: x
    return lambda x: [x.to(d, copy=True) for d in mesh.devices]


def state_sharding(mesh: Mesh, tree, model_axis: str = "model"):
    """Tensor-parallel placement of a train state: not ported yet."""
    raise NotImplementedError(TENSOR_PARALLEL)
