"""One run of a cell as the runners see it: its configuration, traffic,
seed and device, the set-up clock, the trace and the window."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import time
from typing import Callable, Dict, Optional

import torch

SPAN_PREFIXES = ("train.", "serve.")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Outcome:
    """What a runner measured: the window's calls, the end-to-end values,
    the window's figures for the per-layer readers, the numbers compared
    and the device's peak memory."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    window: Dict
    readings: Dict[str, float]
    memory_peak: int


class Cell:
    """One run of a cell: the system under test (``program``), its
    configuration (``config``, the file's ``config`` as a dict;
    ``program_config``, the system's ``Config``; ``weight_params``, the
    file's ``weights``), traffic, limits, seed, window and device, and the
    set-up clock, trace and window that the runners use."""

    def __init__(self, name: str, config_file: dict, traffic: dict,
                 limits: Dict[str, float], seed: int, seconds: float,
                 tracing: bool, device, program, started: float):
        self.name = name
        self.program = program
        self.started = started
        self.config = config_file["config"]
        self.program_config = program.Config.from_json(
            json.dumps(self.config))
        self.weight_params = config_file["weights"]
        self.traffic, self.limits = traffic, limits
        self.seed = seed
        self.weight_seed = (seed * 2 + 1) % 2 ** 63
        self.seconds, self.tracing = seconds, tracing
        self.device = torch.device(device)
        self.setup_s: Optional[float] = None
        self.trace = None
        # what the runner compared with the reference: its inputs, weights
        # and the program's outputs (read by the limits' calibration)
        self.compared: Dict = {}
        self._profiling = False

    def span(self, name: str):
        """A host span of the benchmark's, recorded while a trace is
        taken."""
        if self._profiling:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def setup_done(self) -> None:
        sync(self.device)
        self.setup_s = time.perf_counter() - self.started

    def take_trace(self, one: Callable[[], None], calls: int) -> None:
        from portbench import trace

        self._profiling = True
        try:
            self.trace = trace.take(one, calls, SPAN_PREFIXES)
        finally:
            self._profiling = False

    def window(self, one: Callable[[], None]):
        """``(calls, seconds)``: calls of ``one`` until ``seconds`` have
        passed on the host, then the wait for the device."""
        t0 = time.perf_counter()
        calls = 0
        while time.perf_counter() - t0 < self.seconds:
            one()
            calls += 1
        sync(self.device)
        return calls, time.perf_counter() - t0

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
