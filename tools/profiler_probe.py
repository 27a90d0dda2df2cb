#!/usr/bin/env python3
"""Which state makes torch.profiler lose the device events of short windows.

    python3 tools/profiler_probe.py [--sf 1] [--profiles 12] [--sessions 150]
                                    [--clickbench-rows 0] [--traces DIR]

Run from the repository root on a machine with one CUDA card. It builds the
port's kernels, generates TPC-H at --sf, then probes the profiler at each
stage: at the start, after a minute of idling, after --sessions more
profiler sessions of the ops window alone, after each step of
chip_smoke.py's files phase (run_files, its step_done hook), and after a
garbage collection at the end. A probe profiles three short windows
--profiles times each, as chip_smoke.profile_call does (one warm-up step,
one recorded step):

  ops     14 small elementwise kernels and a reduction (~0.1 ms);
  eager   an eager collect() of a LIKE count over `part` (~1 ms);
  fused   the same query's replayed graph;

and ops again with 20 ms of host sleep inside the recorded step after the
work (ops_padded); with --clickbench-rows, also the eager and the fused
collect() of ClickBench q20 (a LIKE count over every row of `hits`) in a
session of its own (q20_eager, q20_fused). For each it prints how many profiles lost every device
event, and over the others the offset of each kernel's device start from
its launch call on the host (correlation ids), and the recorded window's
edges against the device events. A profile that lost them is described
by its host ops in the window, its launch and copy calls on the host and
the threads they ran on; with --traces, the first such profile of each
window and stage, and the first whole one of each window, are written
there as Chrome traces. Beside each probe: live CUDA graphs, sessions and
native threads, and device memory reserved.

Each line on standard output is one JSON object; the last is
{"ok": true, ...} when the run reached its end.
"""
from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as CS  # noqa: E402
from datafusion_tpu_torch import SessionContext  # noqa: E402
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch  # noqa: E402
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query  # noqa: E402
from datafusion_tpu_torch.ops import cuda_build  # noqa: E402

SHORT_SQL = "SELECT count(*) AS n FROM part WHERE p_name LIKE '%green%'"
PAD_S = 0.02


def _ops(x):
    def run():
        y = x
        for _ in range(14):
            y = y * 1.0001 + 1.0
        y.sum()
    return run


def _window(prof):
    """(device events, kernel start - launch start in us, first device
    start - window start in ms, window end - last device end in ms)."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    steps = [e for e in evs if e.name().startswith("ProfilerStep")]
    device = [e for e in evs if e.device_type() == DeviceType.CUDA
              and not e.name().startswith("ProfilerStep")]
    launch = {e.correlation_id(): e for e in evs
              if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")}
    offsets = [(d.start_ns() - launch[d.correlation_id()].start_ns()) / 1e3
               for d in device if d.correlation_id() in launch]
    head = tail = None
    if steps and device:
        w0 = min(s.start_ns() for s in steps)
        w1 = max(s.end_ns() for s in steps)
        head = (min(d.start_ns() for d in device) - w0) / 1e6
        tail = (w1 - max(d.end_ns() for d in device)) / 1e6
    return len(device), offsets, head, tail


def _host_side(prof) -> dict:
    """What the host did in a profile's window."""
    from torch.autograd import DeviceType

    cpu = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU]
    runtime = [e for e in cpu if e.name().startswith("cuda")]
    return {"host_ops": sum(e.name().startswith("aten::") for e in cpu),
            "runtime_calls": len(runtime),
            "runtime_names": sorted({e.name() for e in runtime}),
            "threads": len({e.start_thread_id() for e in cpu})}


def _probe_one(fn, profiles: int, pad: bool, trace=None) -> dict:
    """`trace(kind)` gives the path of a Chrome trace to write (kind is
    "lost" or "whole"), or None."""
    from torch.profiler import ProfilerActivity

    def active():
        fn()
        if pad:
            torch.cuda.synchronize()
            time.sleep(PAD_S)

    lost, offsets, heads, tails, lost_host = 0, [], [], [], []
    for _ in range(profiles):
        prof = CS.profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA], fn, active)
        n, off, head, tail = _window(prof)
        path = trace and trace("lost" if n == 0 else "whole")
        if path:
            prof.export_chrome_trace(path)
        if n == 0:
            lost += 1
            lost_host.append(_host_side(prof))
            continue
        offsets += off
        heads.append(head)
        tails.append(tail)

    def spread(v):
        return None if not v else {"min": min(v), "median": statistics.median(v),
                                   "max": max(v)}

    return {"lost": lost, "of": profiles, "launch_to_start_us": spread(offsets),
            "window_head_ms": spread(heads), "window_tail_ms": spread(tails),
            "lost_host_side": lost_host[:3]}


def _state() -> dict:
    objs = gc.get_objects()
    return {"cuda_graphs": sum(isinstance(o, torch.cuda.CUDAGraph) for o in objs),
            "sessions": sum(isinstance(o, SessionContext) for o in objs),
            "threads": len(os.listdir("/proc/self/task")),
            "memory_reserved": torch.cuda.memory_reserved()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--profiles", type=int, default=12)
    ap.add_argument("--sessions", type=int, default=150)
    ap.add_argument("--clickbench-rows", type=int, default=0)
    ap.add_argument("--traces", default=None,
                    help="directory for Chrome traces of lost profiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    card = CS.card_line()
    t_run = time.perf_counter()
    cuda_build.build_all([CS.DA.SOURCE])
    tables = generate_tpch(args.sf, cache=False)
    mem = SessionContext()
    for name, table in tables.items():
        mem.register_table(name, table)
    frames = CS.oracle_tables(tables)
    refs = {qid: ref_query(qid, frames, args.sf) for qid in range(1, 23)}
    x = torch.rand(1 << 16, device="cuda")
    df = mem.sql(SHORT_SQL)
    for _ in range(3):
        df.collect()  # discovery, capture, a replay
    windows = {"ops": (_ops(x), False), "ops_padded": (_ops(x), True),
               "eager": (lambda: CS.eager_collect(mem, df), False),
               "fused": (df.collect, False)}
    if args.clickbench_rows:
        cb = SessionContext()
        cb.register_table("hits", CS.generate_hits(args.clickbench_rows))
        q20 = cb.sql(CS.clickbench_query(20, args.clickbench_rows))
        for _ in range(3):
            q20.collect()
        windows["q20_eager"] = (lambda: CS.eager_collect(cb, q20), False)
        windows["q20_fused"] = (q20.collect, False)
    if args.traces:
        os.makedirs(args.traces, exist_ok=True)
    written = set()

    def tracer(stage, name):
        def path(kind):
            key = (stage, name) if kind == "lost" else name
            if not args.traces or key in written:
                return None
            written.add(key)
            return os.path.join(args.traces, f"{stage}_{name}_{kind}.json.gz")
        return path

    def probe(stage: str) -> None:
        CS.emit({"stage": stage, "s": time.perf_counter() - t_run, **_state(),
                 **{name: _probe_one(fn, args.profiles, pad, tracer(stage, name))
                    for name, (fn, pad) in windows.items()},
                 "card": card})

    probe("start")
    time.sleep(60)
    probe("idle_60s")
    _probe_one(_ops(x), args.sessions, False)
    probe(f"sessions_{args.sessions}")
    try:
        CS.run_files(mem, tables, refs, args.sf, 1, card, step_done=probe)
    except RuntimeError as e:  # a check of the phase: probe on all the same
        CS.emit({"files_phase_failed": str(e)[:2000]})
    probe("after_files")
    gc.collect()
    torch.cuda.empty_cache()
    probe("after_gc")
    CS.emit({"ok": True, "s": time.perf_counter() - t_run, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
