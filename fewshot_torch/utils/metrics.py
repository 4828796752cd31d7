"""Metrics: JSONL file + stdout, and step timing for episodes/sec.

Port of ``fewshot/utils/metrics.py``.  The headline metrics are the query
NLL per token and episodes per second.  ``span`` names the program's
ranges (train step and its phases, sampling and its decode loop) for
``torch.profiler``.  ``tensorboard=True`` also writes
scalars through ``torch.utils.tensorboard`` where its ``tensorboard``
package is installed, and quietly writes nothing where it is not, as the
JAX package does without tensorflow.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch


class MetricsLogger:
    def __init__(self, log_dir: str | Path | None = None,
                 stdout: bool = True, tensorboard: bool = False):
        self.stdout = stdout
        self._file = None
        self._tb = None
        if log_dir is not None:
            d = Path(log_dir)
            d.mkdir(parents=True, exist_ok=True)
            self._file = open(d / "metrics.jsonl", "a", buffering=1)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(str(d / "tb"))
                except ImportError:
                    pass     # TensorBoard is optional

    def log(self, step: int, **values) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in values.items()})
        if self._file is not None:
            self._file.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, float):
                    self._tb.add_scalar(k, v, int(step))
        if self.stdout:
            body = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "time")
            print(body, flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """Wall-clock episodes/sec between marks (call around synchronised
    steps)."""

    def __init__(self):
        self._t0 = None
        self._episodes = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._episodes = 0

    def add(self, episodes: int) -> None:
        self._episodes += episodes

    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._episodes / dt if dt > 0 else 0.0


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range of the program (``layer.phase``) on the profiler's
    clock: ``torch.profiler.record_function(name)`` while a profiler
    records, so the range and its nesting land in any ``torch.profiler``
    trace (e.g. ``cli.py --profile_dir``); otherwise one shared null
    context, which allocates nothing and touches no device."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.autograd.profiler.record_function(name)
