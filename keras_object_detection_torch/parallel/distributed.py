"""The process group and the collectives of data parallelism (counterpart of
``keras_object_detection_tpu/parallel/distributed.py``, with the
``torch.distributed`` calls the JAX package's XLA inserts from its
shardings).

One process drives one device; the processes of a run form a process group:

    from keras_object_detection_torch.parallel import distributed
    distributed.maybe_initialize()       # no-op without the environment
    rank, world = distributed.host_shard()

``maybe_initialize`` reads ``KOT_COORDINATOR``, ``KOT_NUM_PROCESSES`` and
``KOT_PROCESS_ID`` as the JAX package does, or torchrun's ``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; the backend is ``nccl`` on CUDA
and ``gloo`` on the CPU.

The helpers below take a group (``None``: no process group) and add no
collective where the group has one process, so a one-rank run is the
single-device program. ``ALL_REDUCES`` / ``ALL_REDUCE_BYTES`` count the
reductions issued and the bytes each rank contributes, ``GATHERS`` the
all-gathers.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ALL_REDUCES = 0
ALL_REDUCE_BYTES = 0
GATHERS = 0


def reset_counts() -> None:
    global ALL_REDUCES, ALL_REDUCE_BYTES, GATHERS
    ALL_REDUCES = ALL_REDUCE_BYTES = GATHERS = 0


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("KOT_PROCESS_ID",
                                                           "0")))


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Start the default process group where the arguments or the
    environment describe one; True when its world is larger than one.
    Idempotent, and a no-op (False) without a description. ``backend``
    defaults to ``nccl`` where CUDA is available, else ``gloo``; under
    ``nccl`` the process takes the card ``LOCAL_RANK`` modulo the card
    count."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator = coordinator_address or env.get("KOT_COORDINATOR")
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator is None and num_processes is None:
        return False
    world = num_processes or int(env.get("KOT_NUM_PROCESSES",
                                         env.get("WORLD_SIZE", "1")))
    rank = process_id if process_id is not None else int(
        env.get("KOT_PROCESS_ID", env.get("RANK", "0")))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    return world > 1


def in_launched_world() -> bool:
    """Whether the environment describes a process group to join
    (torchrun's, or ``KOT_NUM_PROCESSES``)."""
    return bool(os.environ.get("WORLD_SIZE")
                or os.environ.get("KOT_NUM_PROCESSES"))


def free_port() -> int:
    """A free TCP port of this host, for a local process group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(module: str, argv: Sequence[str], nprocs: int,
                 env: Optional[dict] = None) -> int:
    """Run ``python -m module *argv`` as ``nprocs`` local ranks of one
    process group (torchrun's environment: ``RANK``, ``LOCAL_RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on a free port) and
    wait for them. Where a rank fails the others are stopped, since they
    would wait in a collective for it. Returns the first nonzero exit code,
    or 0."""
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = {**os.environ, **(env or {})}
    path = os.pathsep.join(p for p in (root, base.get("PYTHONPATH")) if p)
    procs = []
    for rank in range(nprocs):
        child = dict(base, PYTHONPATH=path, RANK=str(rank),
                     LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=child))
    rc = 0
    try:
        while procs:
            for p in list(procs):
                code = p.poll()
                if code is None:
                    continue
                procs.remove(p)
                if code and not rc:
                    rc = code
                    for other in procs:
                        other.terminate()
            time.sleep(0.05)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return rc


def host_shard() -> Tuple[int, int]:
    """``(rank, world)`` of this process: ``(0, 1)`` without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def world_size(group) -> int:
    """Processes in ``group``: 1 for ``None``."""
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    """This process's rank in ``group``: 0 for ``None``."""
    return 0 if group is None else dist.get_rank(group)


def is_main(group) -> bool:
    """Whether this process writes the run's logs and checkpoints."""
    return rank_of(group) == 0


def barrier(group) -> None:
    if world_size(group) > 1:
        dist.barrier(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place; returns ``t``."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    if world_size(group) > 1:
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
        ALL_REDUCES += 1
        ALL_REDUCE_BYTES += t.numel() * t.element_size()
    return t


class AllReduceSum(torch.autograd.Function):
    """``sum`` over the group's ranks of ``t`` with a gradient: each rank's
    loss depends on the sum, so the gradient of the ranks' summed loss with
    respect to one rank's ``t`` is the sum of their gradients with respect
    to the sum, itself an all-reduce."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``AllReduceSum``: ``t`` itself where the group has one process."""
    if world_size(group) == 1:
        return t
    return AllReduceSum.apply(t, group)


def all_reduce_flat_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, through one flat buffer a
    dtype (one collective each instead of one a tensor)."""
    if world_size(group) == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        all_reduce_(flat, group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dimension 0 in
    rank order: the global batch from each rank's row block. Booleans
    travel as uint8 (NCCL has no boolean type)."""
    global GATHERS
    world = world_size(group)
    if world == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    GATHERS += 1
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def reduce_scatter_rows(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group`` and cut into ``world`` row blocks along
    dimension 0; returns this rank's block (one ``reduce_scatter_tensor``,
    gloo's too)."""
    global ALL_REDUCES, ALL_REDUCE_BYTES
    world = world_size(group)
    if world == 1:
        return t
    out = torch.empty((t.shape[0] // world,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), dist.ReduceOp.SUM,
                               group=group)
    ALL_REDUCES += 1
    ALL_REDUCE_BYTES += t.numel() * t.element_size()
    return out
