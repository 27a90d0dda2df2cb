"""Execution tracing: operator spans -> chrome://tracing JSON.

Port of the span tracer in datafusion_tpu/runtime/tracing.py that
PhysicalPlan._timed records into. Spans are host-clock intervals around
each operator's eager execution; with a CUDA device they cover the enqueue
of the operator's kernels, not their completion."""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import List


class SpanTracer:
    def __init__(self):
        self._lock = threading.Lock()
        self.events: List[dict] = []
        self.enabled = False
        self._t0 = time.perf_counter()

    def reset(self):
        with self._lock:
            self.events = []
            self._t0 = time.perf_counter()

    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self.events.append({
                    "name": name, "ph": "X", "pid": 1,
                    "tid": threading.get_ident() % 100000,
                    "ts": (start - self._t0) * 1e6,
                    "dur": (end - start) * 1e6,
                    "args": args,
                })

    def dump_chrome_trace(self, path: str):
        with self._lock:
            payload = {"traceEvents": self.events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(payload, f)


# set TRACER.enabled to record operator spans
TRACER = SpanTracer()
