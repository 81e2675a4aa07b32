"""The optimizer update on the card (K6): ``ops/csrc/optim_update.cu``
updates many float32 parameter tensors and their moments in place in one
launch, with the arithmetic of ``train/optim.py``'s plain loop
(``apply_updates_plain``), bit for bit. It replaces no TPU kernel: the
loop's launches, 17 to 21 a tensor, cost the host far more than their
device work (the source's note has the numbers).

The tensors' pointers and lengths go to the kernel in its parameters, cut
into launches by ``optim_launch_plan``; each tensor is read as its dense
storage span, so a parameter, its gradient and its moments must be float32
on one CUDA device and share one dense layout, which
``cuda_optim_update`` checks, raising on anything else.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from keras_object_detection_torch.ops import _build

LAUNCHES = 0

# the kernel's template codes, as in optim_update.cu
OPT_CODES = {"adam": 0, "nadam": 1, "adamw": 2, "sgd": 3, "sgdw": 4}
OPT_CHUNK = 8192  # values a block, as KOT_OPT_CHUNK
OPT_MAX_TENSORS = 512  # tensors a launch, as KOT_OPT_MAX_TENSORS
# moment lists each optimizer keeps: (mu or trace, nu)
_MOMENTS = {"adam": 2, "nadam": 2, "adamw": 2, "sgd": 0, "sgdw": 1}


@dataclasses.dataclass(frozen=True)
class OptLaunch:
    """One launch of K6: ``tensors``, the indices (into the caller's list)
    of the tensors it updates, in order, and ``chunk_start``, each one's
    first block with the launch's block count last. Tensor ``tensors[i]``
    takes blocks ``chunk_start[i]`` to ``chunk_start[i + 1] - 1``; block
    ``b`` of them its values from ``(b - chunk_start[i]) * OPT_CHUNK`` up to
    the next chunk or the tensor's end."""

    tensors: Tuple[int, ...]
    chunk_start: Tuple[int, ...]


@functools.lru_cache(maxsize=64)
def optim_launch_plan(sizes: Tuple[int, ...]) -> Tuple[OptLaunch, ...]:
    """K6's launches for tensors of ``sizes`` values: the non-empty ones in
    order, at most ``OPT_MAX_TENSORS`` a launch, one block for every
    ``OPT_CHUNK`` values of each and one for its remainder. Empty tensors
    take no block, so a list of them takes no launch."""
    launches = []
    tensors, starts = [], [0]
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if len(tensors) == OPT_MAX_TENSORS:
            launches.append(OptLaunch(tuple(tensors), tuple(starts)))
            tensors, starts = [], [0]
        tensors.append(i)
        starts.append(starts[-1] + -(-n // OPT_CHUNK))
    if tensors:
        launches.append(OptLaunch(tuple(tensors), tuple(starts)))
    return tuple(launches)


@functools.lru_cache(maxsize=64)
def _plan_arrays(sizes: Tuple[int, ...]):
    """Each launch of the plan as (tensor indices, lengths, block offsets)
    arrays for the C entry point; read only."""
    return [(list(launch.tensors),
             np.asarray([sizes[i] for i in launch.tensors], np.int64),
             np.asarray(launch.chunk_start, np.int32))
            for launch in optim_launch_plan(sizes)]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("optim_update")
    # opt, ptrs, n, chunk_start, count, lr, scalars, stream
    lib.kot_optim_update.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.kot_optim_update.restype = ctypes.c_int
    lib.kot_optim_error_string.argtypes = [ctypes.c_int]
    lib.kot_optim_error_string.restype = ctypes.c_char_p
    return lib


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s values fill one storage span without gaps or
    overlaps, in any order of its dimensions."""
    if t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last):
        return True
    step = 1
    for stride, size in sorted((st, sz) for sz, st in zip(t.shape, t.stride())
                               if sz != 1):
        if stride != step:
            return False
        step *= size
    return True


def _same_layout(x: torch.Tensor, p: torch.Tensor) -> bool:
    """``x`` has ``p``'s shape and strides (a dimension of size 1 may take
    any stride: it never moves an index), so value k of one's span is
    value k of the other's."""
    return x.shape == p.shape and (x.stride() == p.stride() or all(
        a == b for a, b, n in zip(x.stride(), p.stride(), p.shape) if n != 1))


def _check(name: str, params, grads, mu, nu, lr: torch.Tensor) -> torch.device:
    if name not in OPT_CODES:
        raise ValueError(f"unknown optimizer {name!r}")
    lists = [("grads", grads), ("mu", mu), ("nu", nu)][:1 + _MOMENTS[name]]
    for what, xs in lists:
        if len(xs) != len(params):
            raise ValueError(f"{len(xs)} {what} for {len(params)} parameters")
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"the optimizer kernel takes CUDA tensors, the "
                         f"parameters are on {dev}")
    if lr.dim() != 0 or lr.dtype != torch.float32 or lr.device != dev:
        raise ValueError("lr must be a 0-dim float32 tensor on the "
                         "parameters' device")
    f32 = torch.float32
    for i, p in enumerate(params):
        if p.dtype != f32 or p.device != dev:
            raise ValueError(f"parameter {i} is {p.dtype} on {p.device}: the "
                             f"optimizer kernel takes float32 on {dev}")
        if not _dense(p):
            raise ValueError(f"parameter {i} is not dense (gaps or overlaps "
                             "in its storage)")
        for what, xs in lists:
            x = xs[i]
            if x.dtype != f32 or x.device != dev:
                raise ValueError(f"{what}[{i}] is {x.dtype} on {x.device}: "
                                 f"the optimizer kernel takes float32 on {dev}")
            if not _same_layout(x, p):
                raise ValueError(f"{what}[{i}] differs from its parameter in "
                                 f"shape or strides ({tuple(x.shape)}, "
                                 f"{x.stride()} against {tuple(p.shape)}, "
                                 f"{p.stride()})")
    return dev


def cuda_optim_update(name: str, params: Sequence[torch.Tensor],
                      grads: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                      nu: Sequence[torch.Tensor], lr: torch.Tensor,
                      hyper: Sequence[float]) -> None:
    """K6: one step of optimizer ``name`` (a key of ``OPT_CODES``) on
    ``params`` in place from ``grads``: adam, nadam and adamw update their
    moments ``mu`` and ``nu`` in place too, sgdw its trace (in ``mu``),
    sgd neither (pass empty lists). ``lr`` is the 0-dim float32 learning
    rate on the parameters' device, read by the kernel where it runs;
    ``hyper`` the float32 values ``(b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2,
    bc1_next, weight_decay, momentum)``. One launch for every
    ``OPT_MAX_TENSORS`` tensors, none for an empty list; no copy to the
    device and no synchronisation. The bias corrections go by value, so a
    CUDA graph that captures a call replays that step's."""
    global LAUNCHES
    if not params:
        return
    dev = _check(name, params, grads, mu, nu, lr)
    moments = [mu, nu][:_MOMENTS[name]]
    ptrs = np.zeros((4, len(params)), np.int64)
    for row, xs in enumerate([params, grads, *moments]):
        ptrs[row] = [x.data_ptr() for x in xs]
    scalars = np.asarray(hyper, np.float32)
    if scalars.shape != (10,):
        raise ValueError(f"hyper holds 10 values, not {scalars.size}")
    fn = _library().kot_optim_update
    for tensors, n, chunk_start in _plan_arrays(tuple(p.numel() for p in params)):
        table = np.ascontiguousarray(ptrs[:, tensors])
        err = _build.launch(fn, dev, OPT_CODES[name], table.ctypes.data,
                            n.ctypes.data, chunk_start.ctypes.data, len(tensors),
                            lr.data_ptr(), scalars.ctypes.data)
        if err:
            msg = _library().kot_optim_error_string(err).decode()
            raise (ValueError if err < 0 else RuntimeError)(
                f"optimizer kernel: {msg}")
        LAUNCHES += 1
