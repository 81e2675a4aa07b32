"""Build the port's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes``, and launch their C entry points on the
current stream.

``load_library("nms")`` compiles ``ops/csrc/nms.cu`` with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` beside the package (listed
in ``.gitignore``), named by a hash of the source and the flags, so an
edited source builds again. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the GPU")


def build(name: str, csrc: pathlib.Path = CSRC) -> Tuple[pathlib.Path, float, str]:
    """Compile ``<csrc>/<name>.cu`` if its hashed library is missing.
    Returns (library path, build seconds, compiler output); seconds is 0.0
    when the library was already built."""
    source = csrc / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, seconds, proc.stdout + proc.stderr


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    lib, _, _ = build(name)
    return ctypes.CDLL(str(lib))


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, switching the
    current device only where it differs. The stream is the raw handle,
    since ``torch.cuda.current_stream()`` builds a Stream object each
    call."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)
