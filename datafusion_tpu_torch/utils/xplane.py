"""Device-time summary of a torch.profiler trace: per-op time aggregation.

The counterpart of datafusion_tpu/utils/xplane.py, which decodes the XLA
profiler's XSpace protobuf. Here the trace is torch.profiler's: either a
profile object (its `key_averages()`), or the Chrome trace JSON that
`profile.export_chrome_trace(path)` or `tensorboard_trace_handler` wrote.
Either way it answers the question every kernel-optimization loop starts
with -- which device ops the card spent its time in (the reference exposes
the same through per-operator metrics, datafusion/physical-plan/src/
metrics/) -- counting device events only: kernels, copies and memsets.

Usage:
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run()
    print(top_ops(prof))            # or: prof.export_chrome_trace("t.json")
                                    #     print(top_ops("t.json"))
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

# Chrome trace categories of device events (kernels, copies, memsets)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_files(path_or_dir: str) -> List[str]:
    if not os.path.isdir(path_or_dir):
        return [path_or_dir]
    # every trace the handler wrote in the run directory (one per step/rank)
    paths = sorted(glob.glob(os.path.join(path_or_dir, "**", "*.json"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {path_or_dir}")
    return paths


def _from_chrome(path_or_dir: str, categories) -> Dict[str, List[float]]:
    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for path in _trace_files(path_or_dir):
        with open(path) as f:
            trace = json.load(f)
        events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
        for ev in events:
            if ev.get("ph") != "X" or ev.get("cat", "").lower() not in categories:
                continue
            a = agg[ev.get("name", "?")]
            a[0] += float(ev.get("dur", 0.0)) / 1e3  # us -> ms
            a[1] += 1
    return agg


def _from_profile(prof) -> Dict[str, List[float]]:
    from torch.autograd import DeviceType

    agg: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in prof.key_averages():
        # the step annotation spans the whole step: not a device op
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0 \
                or e.key.startswith("ProfilerStep"):
            continue
        a = agg[e.key]
        a[0] += e.self_device_time_total / 1e3  # us -> ms
        a[1] += e.count
    return agg


def plane_op_times(source, categories=DEVICE_CATEGORIES) -> Dict[str, Tuple[float, int]]:
    """Device time by op name: {op_name: (total_ms, count)}. `source` is a
    torch.profiler profile, or the path of a Chrome trace JSON (or of a
    directory of them, aggregated); `categories` are the Chrome trace
    categories counted as device events."""
    if isinstance(source, (str, os.PathLike)):
        agg = _from_chrome(os.fspath(source), tuple(c.lower() for c in categories))
    else:
        agg = _from_profile(source)
    return {k: (v[0], int(v[1])) for k, v in agg.items()}


def copy_ms(times: Dict[str, Tuple[float, int]]) -> float:
    """Device ms of the copies and memsets among plane_op_times' ops."""
    return sum(ms for name, (ms, _) in times.items()
               if "memcpy" in name.lower() or "memset" in name.lower())


def top_ops(source, n: int = 25, categories=DEVICE_CATEGORIES) -> str:
    """Human-readable top-N ops by total device time."""
    times = plane_op_times(source, categories)
    rows = sorted(times.items(), key=lambda kv: -kv[1][0])[:n]
    total = sum(v[0] for v in times.values())
    out = [f"{'ms':>10}  {'calls':>6}  {'%':>5}  op", "-" * 70]
    for name, (ms, cnt) in rows:
        out.append(f"{ms:10.3f}  {cnt:6d}  {100 * ms / max(total, 1e-9):5.1f}  {name[:120]}")
    out.append(f"{total:10.3f}  total device time")
    return "\n".join(out)
