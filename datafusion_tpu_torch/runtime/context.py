"""Execution runtime context.

Port of datafusion_tpu/runtime/context.py (reference analog: TaskContext +
RuntimeEnv, datafusion/execution/src/task.rs:52): per-query config, the
torch device, metrics registry, memory pool (`execution.memory_pool`:
greedy or fair_spill) and spill manager passed to every operator's
execute()."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ExecMetrics:
    """Per-operator metrics (analog of BaselineMetrics,
    physical-expr-common/src/metrics/baseline.rs:53)."""

    output_rows: int = 0
    elapsed_seconds: float = 0.0

    def record(self, rows: int, seconds: float):
        self.output_rows += int(rows)
        self.elapsed_seconds += seconds


# the device of the session whose SQL is being planned: the SQL planner
# evaluates constant VALUES cells through an ExecContext that names none
_PLANNING_DEVICE = None


@contextlib.contextmanager
def planning_device(device):
    """ExecContexts made without a device inside this block run on `device`."""
    global _PLANNING_DEVICE
    prev, _PLANNING_DEVICE = _PLANNING_DEVICE, device
    try:
        yield
    finally:
        _PLANNING_DEVICE = prev


class ExecContext:
    def __init__(self, config: Optional[Dict[str, Any]] = None, device=None):
        from .memory import FairSpillPool, GreedyMemoryPool, MemoryPool
        from .spill import SpillManager

        self.config = dict(config or {})
        self.device = device if device is not None else _PLANNING_DEVICE
        self.metrics: Dict[str, ExecMetrics] = {}
        limit = (self.config.get("memory_limit_bytes")
                 or self.config.get("execution.memory_limit_bytes"))
        kind = self.config.get("execution.memory_pool", "greedy")
        if not limit:
            self.memory_pool = MemoryPool()
        elif kind == "fair_spill":
            self.memory_pool = FairSpillPool(int(limit))
        else:
            self.memory_pool = GreedyMemoryPool(int(limit))
        compress = self.config.get("execution.spill_compression", False)
        self.spill_manager = SpillManager(
            self.config.get("spill_dir")
            or self.config.get("execution.spill_dir") or None,
            max_host_bytes=self.config.get("execution.spill_max_host_bytes", 0),
            compress=str(compress).lower() not in ("false", "0", "",
                                                   "uncompressed", "none"))
        # cooperative cancellation, checked between operator dispatches
        self.cancel_event = self.config.get("_cancel_event")
        timeout = self.config.get("execution.timeout_seconds")
        self.deadline = (time.monotonic() + float(timeout)) if timeout else None

    def check_cancelled(self):
        from ..common.errors import QueryCancelled

        if self.cancel_event is not None and self.cancel_event.is_set():
            raise QueryCancelled("query cancelled by interrupt()")
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryCancelled("execution.timeout_seconds exceeded")

    def metric(self, name: str) -> ExecMetrics:
        if name not in self.metrics:
            self.metrics[name] = ExecMetrics()
        return self.metrics[name]

    def opt(self, key: str, default=None):
        return self.config.get(key, default)
