"""One run of one cell: set-up, the closed-loop window (or, traced, the
passes the per-layer metrics are read from), the comparison with the plain
reference, and the result line.

The client is one closed loop (traffic/<mix>.json): it sends the dataset's
queries in stream order, over and over, the next when the last one's host
table is in hand. `"plan": "held"` plans each query once in set-up and the
window calls collect() on the held DataFrame; `"plan": "per_query"` sends
each query as new SQL, ctx.sql(text), physical_plan(), collect()."""
from __future__ import annotations

import contextlib
import gc
import json
import random
import statistics
import sys
import time
from typing import Dict, List, Optional

from dfbench import manifest
from dfbench.answers import judge

BANNED = ("jax", "jaxlib", "flax", "datafusion_tpu")
GIB = float(1 << 30)
NAME_CHARS = 120  # of a device op's name in the breakdown


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def p95(values: List[float]) -> float:
    """The 95th percentile of every value, interpolated between order
    statistics (statistics.quantiles' 'inclusive' method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def window_metrics(latencies_s: List[float], window_s: float) -> dict:
    """The window's rate and tail: every query completed in the window over
    the window's whole time, and the 95th percentile of every query's
    latency (never of pass or chunk medians)."""
    lat_ms = [x * 1e3 for x in latencies_s]
    return {"window_s": window_s, "queries": len(lat_ms),
            "queries_per_s": len(lat_ms) / window_s if window_s > 0 else 0.0,
            "query_median_ms": statistics.median(lat_ms) if lat_ms else 0.0,
            "query_p95_ms": p95(lat_ms) if lat_ms else 0.0}


class Keeper:
    """The answers kept for the comparison: all of them, or for a query
    with a cap in the configuration's `answers_kept` (by name, or
    "default"), a uniform sample of that many drawn from the seed
    (reservoir sampling), so that the client holds a bounded number of
    host tables however long the window."""

    def __init__(self, caps: Dict[str, int], seed: int):
        self.caps = dict(caps)
        self.default_cap = self.caps.pop("default", None)
        self.rng = random.Random(seed)
        self.kept: Dict[str, list] = {}
        self.seen: Dict[str, int] = {}

    def offer(self, name: str, table) -> None:
        i = self.seen[name] = self.seen.get(name, 0) + 1
        bucket = self.kept.setdefault(name, [])
        cap = self.caps.get(name, self.default_cap)
        if cap is None or len(bucket) < cap:
            bucket.append(table)
            return
        j = self.rng.randrange(i)
        if j < cap:
            bucket[j] = table


class Client:
    """The closed-loop client of one session."""

    def __init__(self, ctx, texts: Dict[str, str], held: bool):
        self.ctx = ctx
        self.texts = texts
        self.held = held
        self.frames = {name: ctx.sql(text) for name, text in texts.items()} if held else {}
        self.plan_s: List[float] = []

    def call(self, name: str, span=None):
        """One query, its host table returned; `span(name)`, when given,
        opens the benchmark's spans (dfbench.trace.span). The host clock
        times each plan (per-query SQL) into `plan_s`."""
        span = span or _no_span
        if self.held:
            with span(f"collect.{name}"):
                return self.frames[name].collect()
        t = time.perf_counter()
        with span(f"plan.{name}"):
            df = self.ctx.sql(self.texts[name])
            df.physical_plan()
        self.plan_s.append(time.perf_counter() - t)
        with span(f"collect.{name}"):
            return df.collect()


def _no_span(name):
    return contextlib.nullcontext()


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, out=None, err=None, sizes=None) -> int:
    """Runs the cell; prints earlier lines and the result line to `out`, the
    compared numbers to `err`. device None is the card; the CPU tests pass
    device "cpu" and smaller `sizes` (keys of the configuration's file)."""
    out = out or sys.stdout
    err = err or sys.stderr

    def emit(obj) -> None:
        print(json.dumps(obj), file=out, flush=True)

    cell = manifest.cell(cell_name)
    conf = {**cell.config, **(sizes or {})}
    traffic = cell.traffic
    ds = manifest.dataset(conf["dataset"])
    ref = manifest.reference(conf["dataset"])
    stream = ds.STREAMS[traffic.get("stream", "default")]
    texts = {n: t for n, t in ds.queries(conf).items() if n in stream}
    on_card = device is None

    import torch

    from dfbench import port

    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=err)
            return 2
    t = time.perf_counter()
    parts = {"start_s": t - t_start}  # interpreter, torch and the benchmark's imports
    tables = ds.generate(conf, seed)
    parts["datagen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if on_card:
        port.build_kernels()
    parts["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx = port.session(device)
    port.register(ctx, tables)
    client = Client(ctx, texts, traffic["plan"] == "held")
    parts["register_s"] = time.perf_counter() - t

    # warm-up: the first pass discovers (uploading the tables), the later
    # ones build and replay the steady state; traced, the first pass also
    # records each query's dense-kernel launches. The answers are kept as
    # the window keeps them: a kept host table holds its pinned buffers, so
    # torch's host cache then holds as many as the window's keeper needs,
    # and the window's first passes allocate no pinned memory
    caps = dict(conf.get("answers_kept", {}))
    warm_keeper = Keeper(caps, seed)
    kernel_calls: Dict[str, List[dict]] = {}
    for p in range(int(traffic["warm_passes"])):
        t = time.perf_counter()
        for name in stream:
            if trace and p == 0:
                calls = kernel_calls.setdefault(name, [])
                with port.kernel_launches(calls):
                    warm_keeper.offer(name, client.call(name))
            else:
                warm_keeper.offer(name, client.call(name))
        if on_card:
            torch.cuda.synchronize()
        parts[f"warm_pass{p}_s"] = time.perf_counter() - t
    del warm_keeper
    client.plan_s.clear()

    keeper = Keeper(caps, seed)
    attempted = failed = 0
    errors: List[str] = []
    latencies: List[float] = []
    by_query: Dict[str, List[float]] = {}
    trace_data = None

    def one(name: str, span=None) -> Optional[float]:
        nonlocal attempted, failed
        attempted += 1
        t0 = time.perf_counter()
        try:
            table = client.call(name, span)
        except Exception as e:  # a query that fails is counted and reported
            failed += 1
            if len(errors) < 5:
                errors.append(f"{name}: {type(e).__name__}: {e}")
            return None
        dt = time.perf_counter() - t0
        keeper.offer(name, table)
        del table
        return dt

    setup_s = time.perf_counter() - t_start
    if not trace:
        t_window = time.perf_counter()
        deadline = t_window + seconds
        passes_ms: List[float] = []
        # whole passes of the stream, the last the one that crosses the
        # deadline: every query weighs alike in the rate and the tail,
        # wherever in a pass the deadline falls
        while time.perf_counter() < deadline:
            t_pass = time.perf_counter()
            for name in stream:
                dt = one(name)
                if dt is not None:
                    latencies.append(dt)
                    by_query.setdefault(name, []).append(dt)
            passes_ms.append((time.perf_counter() - t_pass) * 1e3)
        window_s = time.perf_counter() - t_window
    else:
        trace_data = traced_passes(client, stream, traffic, one, on_card)
        trace_data["kernel_calls"] = kernel_calls
    # the window has closed: memory, then the program's state goes
    peak_alloc = torch.cuda.max_memory_allocated() if on_card else 0
    peak_reserved = torch.cuda.max_memory_reserved() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    count = cell.chips if on_card else 0
    del client, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    answers = ref.answers(tables, conf, sorted(keeper.kept))
    ref_s = time.perf_counter() - t
    mismatched, gap, first_bad = 0, 0.0, None
    compared = 0
    for name, kept in keeper.kept.items():
        for table in kept:
            v = judge(table, answers[name])
            compared += 1
            if v.mismatch is not None:
                mismatched += 1
                first_bad = first_bad or f"{name}: {v.mismatch}"
            gap = max(gap, v.float_gap)
    compare_s = time.perf_counter() - t - ref_s
    limits = conf["limits"]
    numbers = {"mismatched_answers": {"value": mismatched, "limit": limits["mismatched_answers"]},
               "float_gap": {"value": gap, "limit": limits["float_gap"]},
               "failed_queries": {"value": failed, "limit": 0}}
    correct = (mismatched <= limits["mismatched_answers"] and gap <= limits["float_gap"]
               and failed == 0 and compared > 0)
    found = banned_modules()
    if found:
        print(f"benchmark: modules loaded that must not be: {found}", file=err)
        return 3
    emit({"setup": parts, "setup_s": setup_s, "seed": seed, "cell": cell.name,
          "device": kind})
    emit({"answers_compared": compared, "reference_s": ref_s, "compare_s": compare_s,
          "first_mismatch": first_bad, "errors": errors})
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if not trace:
        values = window_metrics(latencies, window_s)
        emit({**values, "median_ms_by_query": {
            n: statistics.median(v) * 1e3 for n, v in by_query.items()},
            "whole_passes_ms": passes_ms})
        values.update(peak_alloc_gib=peak_alloc / GIB, setup_s=setup_s)
        metrics = {m.name: {"value": values[m.name], "unit": m.unit}
                   for m in cell.end_to_end if m.name in values}
        dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": count,
               "memory_peak_bytes": int(peak_reserved)}
    else:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m.name)(trace_data)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        summary = trace_data.get("summary") or {}
        dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": count,
               "memory_peak_bytes": int(peak_reserved),
               "busy_s": summary.get("busy_s", 0.0), "window_s": summary.get("window_s", 0.0)}
        if summary:
            result["breakdown"] = {
                "device_ops": [[n[:NAME_CHARS], s] for n, s in sorted(
                    summary["device_s_by_name"].items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[n, s] for n, s in sorted(
                    summary["idle_s_by_span"].items(), key=lambda kv: -kv[1])[:10]]}
    result["metrics"] = metrics
    result["device"] = dev
    result["compared"] = {k: [v["value"], v["limit"]] for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=err)
    emit(result)
    return 0


def traced_passes(client: Client, stream, traffic: dict, one, on_card: bool) -> dict:
    """The traced run's passes: host syncs over whole passes, host-clock
    plan spans, then whole passes under torch.profiler with the benchmark's
    spans as annotations."""
    from dfbench import port
    from dfbench import trace as TR

    passes = traffic["traced_passes"]
    data: Dict = {"queries_per_pass": len(stream)}
    if on_card:
        def sync_pass():
            for name in stream:
                one(name)
        n = int(passes["syncs"])
        data["syncs"] = sum(TR.host_syncs(sync_pass) for _ in range(n))
        data["sync_queries"] = n * len(stream)
    client.plan_s.clear()
    for _ in range(int(passes["spans"])):
        for name in stream:
            one(name)
    data["plan_s"] = list(client.plan_s)
    if not on_card:
        return data
    n = int(passes["profiled"])

    def profiled():
        current, open_spans = {"name": None}, []

        def enter():
            span = TR.span(f"to_host.{current['name']}")
            span.__enter__()
            open_spans.append(span)

        def leave():
            open_spans.pop().__exit__(None, None, None)

        with port.host_copy_spans(enter, leave):
            for _ in range(n):
                for name in stream:
                    current["name"] = name
                    one(name, TR.span)

    def warm():
        for name in stream:
            one(name)

    got = TR.profile_passes(warm, profiled)
    summary = TR.summarize(got)
    summary["queries"] = n * len(stream)
    summary["executions"] = {name: n for name in stream}
    data["summary"] = summary
    return data
