"""Metric logging (counterpart of
``keras_object_detection_tpu/train/metrics_logger.py``): one JSON line per
epoch in ``<log_dir>/train.jsonl``; TensorBoard scalars through
``torch.utils.tensorboard`` when it imports (it is optional, as TensorFlow
is to the JAX package). ``Trainer.fit`` prints each epoch's line to stdout.
A logger that is not ``enabled`` (a data-parallel rank other than 0) writes
nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 enabled: bool = True):
        self.path = os.path.join(log_dir, "train.jsonl")
        self._file = self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(self.path, "a")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb", "train"))

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self._file is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), step)
            self._tb.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
