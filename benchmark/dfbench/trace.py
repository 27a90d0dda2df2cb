"""What the traced run reads: host syncs, host-clock spans and a
torch.profiler trace of whole passes, reduced to plain numbers.

Frozen copies, kept with the benchmark so that no later change to the
program changes how it is measured: OP_FAMILIES and op_family, and the
sync count, from chip_smoke.py (`OP_FAMILIES`, `op_family`, `host_syncs`);
the profile with a discarded warm-up step, idle edges and a retry when the
profiler lost every device event, from chip_smoke.py (`profiled`,
`profile_call`); the Chrome trace reading, from
datafusion_tpu_torch/utils/xplane.py (`DEVICE_CATEGORIES`, `_from_chrome`)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Tuple

# device-op families of the sort and join paths, matched in order on kernel
# names ("searchsorted" before "sort", which it contains)
OP_FAMILIES = (("dense_groupby_sums", ("dgs_",)),
               ("searchsorted", ("searchsorted",)),
               ("sort", ("sort", "Sort")),
               ("scatter", ("scatter", "indexFunc", "index_add")),
               ("gather", ("index_elementwise", "gather", "index_kernel")),
               ("cumsum", ("scan", "Scan", "cumsum")),
               ("copy", ("Memcpy", "Memset", "copy")))

# Chrome trace categories of device events (kernels, copies, memsets)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# host sleep at each edge of the recorded step: the profiler keeps only the
# device events inside its window, and a device time stamp can come out
# milliseconds before the host call that launched it
PROFILE_EDGE_S = 0.03
PROFILE_ATTEMPTS = 4

# the benchmark's own spans, recorded as profiler annotations
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def op_family(name: str) -> str:
    for family, needles in OP_FAMILIES:
        if any(k in name for k in needles):
            return family
    return "other"


def host_syncs(step: Callable[[], None]) -> int:
    """Host synchronisations of one call of step(), as
    torch.cuda.set_sync_debug_mode("warn") reports them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def span(name: str):
    """A benchmark span: a profiler annotation named SPAN_PREFIX + name."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def read_chrome(path: str) -> dict:
    """Device events and benchmark spans of a Chrome trace:
    {"device": [(name, start_us, dur_us)], "spans": [(name, start_us, dur_us)]}."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        row = (str(ev.get("name", "?")), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0)))
        if cat in DEVICE_CATEGORIES:
            device.append(row)
        elif cat == "user_annotation" and row[0].startswith(SPAN_PREFIX):
            spans.append(row)
    return {"device": device, "spans": spans}


def profile_passes(warmup: Callable[[], None], active: Callable[[], None]) -> dict:
    """torch.profiler over two steps: warmup() in the discarded warm-up step,
    active() in the recorded one, inside a WINDOW_SPAN annotation, between
    two PROFILE_EDGE_S sleeps with the card idle. Taken again, a moment
    later, when the trace holds no device event inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if attempt > 1:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            warmup()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_EDGE_S)
            with record_function(WINDOW_SPAN):
                active()
                torch.cuda.synchronize()
            time.sleep(PROFILE_EDGE_S)
            prof.step()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            got = read_chrome(path)
        finally:
            os.remove(path)
        window = [s for s in got["spans"] if s[0] == WINDOW_SPAN]
        if window:
            w0, wd = window[0][1], window[0][2]
            inside = [d for d in got["device"] if d[1] + d[2] > w0 and d[1] < w0 + wd]
            if inside:
                got["window"] = (w0, wd)
                got["device"] = inside
                got["attempts"] = attempt
                return got
    raise RuntimeError(f"profiler: no device event in the window in {PROFILE_ATTEMPTS} attempts")


def busy_intervals(device: List[Tuple[str, float, float]], w0: float, wd: float):
    """The union of the device events' intervals, clipped to the window."""
    iv = sorted((max(s, w0), min(s + d, w0 + wd)) for _, s, d in device)
    out = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy, w0: float, wd: float):
    """The window's idle intervals between busy ones."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w0 + wd > t:
        gaps.append((t, w0 + wd))
    return gaps


def span_at(spans, t: float) -> str:
    """The innermost benchmark span open at time t (name without prefix);
    between_queries where none is."""
    best, best_d = "between_queries", None
    for name, s, d in spans:
        if name == WINDOW_SPAN or not (s <= t < s + d):
            continue
        if best_d is None or d < best_d:
            best, best_d = name[len(SPAN_PREFIX):], d
    return best


def summarize(got: dict) -> Dict:
    """busy_s, window_s, device time by op name and by family, and idle time
    by the span the host was in."""
    w0, wd = got["window"]
    busy = busy_intervals(got["device"], w0, wd)
    by_name: Dict[str, float] = {}
    by_family: Dict[str, float] = {}
    for name, _, d in got["device"]:
        by_name[name] = by_name.get(name, 0.0) + d / 1e6
        fam = op_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + d / 1e6
    spans = [s for s in got["spans"] if s[0] != WINDOW_SPAN]
    edges = sorted({t for _, s, d in spans for t in (s, s + d)})
    idle_by_span: Dict[str, float] = {}
    for a, b in idle_gaps(busy, w0, wd):
        # split the gap where a span opens or closes; name each piece
        cuts = [a] + edges[bisect.bisect_right(edges, a):bisect.bisect_left(edges, b)] + [b]
        for x, y in zip(cuts[:-1], cuts[1:]):
            name = span_at(spans, (x + y) / 2)
            idle_by_span[name] = idle_by_span.get(name, 0.0) + (y - x) / 1e6
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": wd / 1e6,
            "device_s_by_name": by_name, "device_s_by_family": by_family,
            "idle_s_by_span": idle_by_span,
            "dgs_launches": sum(1 for n, _, _ in got["device"] if "dgs_" in n),
            "dgs_s": sum(d for n, _, d in got["device"] if "dgs_" in n) / 1e6,
            "dtoh_s": sum(d for n, _, d in got["device"]
                          if "memcpy" in n.lower() and "dtoh" in n.lower()) / 1e6,
            "attempts": got["attempts"]}
