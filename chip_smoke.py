#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--h2o-rows 10000000] [--repeat 5]

Run from the repository root on a machine with one CUDA card and nvcc. In
order, it:
  1. prints the card's name and power limit (nvidia-smi) and the torch device;
  2. builds every hand-written kernel from csrc/ (one nvcc per source, all in
     parallel), prints each one's -Xptxas -v report, and fails if a kernel
     spills registers or (cuobjdump -sass) holds a shared-memory atomic;
  3. holds each kernel against its plain PyTorch version on the card, bit for
     bit (tolerance 0: integer sums are exact), at the main path's shapes and
     at edge cases, and fails unless every route of the kernel was taken;
  4. generates TPC-H at --sf and runs Q1 and Q6 through
     SessionContext().sql(...).collect() -- the main path -- checks the answers
     against the pandas oracle with frames_diff, and checks that each query
     launched the kernel (launch counts are reset just before each query and
     read just after);
  5. holds each kernel against its plain version again, bit for bit, on the
     inputs the main path gave it, and times it there as cold-L2 device time
     (CUDA events around the call alone, after a 1 GiB write that evicts the
     L2 and a 128 MB read that leaves it clean; median of --iters;
     cross-checked with torch.profiler), beside its
     first design, its plain version, one PyTorch library call computing the
     same function, and its bound (bytes the data needs / the card's memory
     rate), then times warm Q1 and Q6 end to end;
  6. generates the h2o.ai groupby table G1_1e7_1e2_0_0 (--h2o-rows rows,
     K = 100, seed 42) and runs groupby q1-q7, q9 and q10 through the same
     API -- the second main path -- each checked against a pandas oracle on
     the same table (floats to rtol 1e-9 / atol 1e-9, the rest exact) with
     the kernel's launches counted per query (q1, q2 and q4 launch it, on its
     shared and global routes); checks that q8 (a window query) raises; holds
     segment min/max on the card against the CPU on NaN, -0.0 and int64
     extremes; holds the kernel against its plain version at the h2o shapes
     and times it there as in 5; times each query warm and profiles it once
     (device busy, idle share, top device ops, and the sort path's sorts,
     gathers, cumulative sums and scatters);
  7. prints a {"kernels": [...]} line, the card's name and power limit, and,
     last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line is printed.
Without a CUDA device it exits with code 2 at once.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from datafusion_tpu_torch import Schema, SessionContext, Table
from datafusion_tpu_torch.models.h2o.datagen import generate_groupby
from datafusion_tpu_torch.models.h2o.queries import GROUPBY_QUERIES
from datafusion_tpu_torch.models.tpch.compare import frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import cuda_build
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.physical import plan as P

# H100 SXM device memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
# before each timed call: a write that evicts the L2 (50 MB on an H100) and
# keeps the card busy while the host enqueues the call, then a read that
# leaves the L2 holding clean lines of another buffer
L2_FLUSH_WRITE_BYTES = 1 << 30
L2_FLUSH_READ_BYTES = 128 << 20
KERNEL = {
    "name": "dense_groupby_sums",
    "route": "cuda",
    "source": "datafusion_tpu_torch/csrc/dense_groupby_sums.cu",
    "replaces": "datafusion_tpu/ops/pallas_agg.py:153",
}
# the kernel's first design (shared-memory atomics), timed beside it by the
# same method on the same inputs; the engine never calls it
BASELINE = "baseline/dense_groupby_sums_shared_atomics.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class L2Flush:
    """Leaves the L2 cold and clean: a write of L2_FLUSH_WRITE_BYTES evicts
    every input (and, at ~0.35 ms, outlasts the host's enqueue of the timed
    call), then a read of L2_FLUSH_READ_BYTES writes the flush's dirty lines
    back, so the timed call pays for its own bytes only."""

    def __init__(self, dev):
        self.write = torch.empty(L2_FLUSH_WRITE_BYTES, dtype=torch.uint8, device=dev)
        self.read = torch.zeros(L2_FLUSH_READ_BYTES // 8, dtype=torch.int64, device=dev)

    def __call__(self) -> None:
        self.write.zero_()
        self.read.sum()


def cold_ms(fn, iters: int, flush: L2Flush) -> float:
    """Median device time of one call of fn with the L2 cache cold: before
    each call, `flush()`; one pair of CUDA events brackets fn alone. One
    warm-up call first."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def warm_ms(fn, iters: int) -> float:
    """Mean time of one call of fn over `iters` back-to-back calls between
    one pair of events: the L2 stays warm and the host's enqueue rate can
    set the pace. Kept only to show how far it is from cold_ms."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(activities, warmup, active):
    """torch.profiler over two steps: warmup() runs in the profiler's
    warm-up step, whose events are discarded (the first device events of a
    session can be lost), active() in the recorded step. Returns the
    profile."""
    from torch.profiler import profile, schedule

    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in (warmup, active):
            step()
            torch.cuda.synchronize()
            prof.step()
    return prof


def profiled_kernel_ms(fn, iters: int, flush: L2Flush, name: str):
    """(mean self device time of the kernels whose name contains `name` over
    `iters` calls of fn each after an L2 flush, read from torch.profiler:
    the cross-check of cold_ms without the events' own resolution; the
    number of those kernels the profiler saw)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    def calls(k):
        def run():
            for _ in range(k):
                flush()
                fn()
        return run

    prof = profiled([ProfilerActivity.CUDA], calls(3), calls(iters))
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    # the mean is over the launches the profiler saw; most must be there
    seen = sum(e.count for e in hits)
    check(iters // 2 <= seen <= iters,
          f"profiler saw {seen} '{name}' kernels in {iters} calls")
    return sum(e.self_device_time_total for e in hits) / seen / 1e3, seen


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------


def _rand(gen, lo: int, hi: int, n: int, dtype, dev):
    return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)


def kernel_cases(dev):
    """(name, seg, mask, pairs, G) inputs for the bit-exact comparison: the
    main path's shapes, every route and register shape at its boundaries,
    int32/int64 mixes on each route, misaligned views, ragged and tiny N."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    i64, i32 = torch.int64, torch.int32
    big_n = 1 << 23

    def seg_mask(n, G, live=0.9):
        seg = _rand(gen, -1, G + 1, n, i32, dev)  # ids -1 and G are dropped
        mask = torch.rand(n, generator=gen, device=dev) < live
        return seg, mask

    def factors(n, count, with_b=True):
        """count pairs alternating int64 / int32, wide values of both signs,
        every other one with a b of the other type"""
        out = []
        for k in range(count):
            ta, tb = (i64, i32) if k % 2 == 0 else (i32, i64)
            a = _rand(gen, -(2 ** 31), 2 ** 31 - 1, n, ta, dev)
            b = (_rand(gen, -100_000, 100_000, n, tb, dev)
                 if with_b and k % 2 == 1 else None)
            out.append((a, b))
        return out

    # Q1's shape: 6 groups, 7 pairs of int64 decimal-like factors (two of
    # them repeated, as sum and avg of one column repeat them), one with b
    seg, mask = seg_mask(big_n, 6)
    price = _rand(gen, 0, 10_500_000, big_n, i64, dev)
    qty = _rand(gen, 100, 5_001, big_n, i64, dev)
    disc = _rand(gen, 0, 11, big_n, i64, dev)
    disc_price = _rand(gen, 0, 1_050_000_000, big_n, i64, dev)
    tax = _rand(gen, 100, 109, big_n, i64, dev)
    q1 = [(qty, None), (price, None), (disc_price, None), (disc_price, tax),
          (qty, None), (price, None), (disc, None)]
    yield "q1", seg, mask, q1, 6
    # Q6's shape: one group, one pair, 2% live
    seg6, mask6 = seg_mask(big_n, 1, live=0.02)
    yield "q6", seg6, mask6, [(price, disc)], 1
    # a ragged N with the 2^23 columns plus 3 rows
    n = big_n + 3
    seg, mask = seg_mask(n, 6)
    yield "n_2p23_plus_3", seg, mask, factors(n, 3), 6
    # tiny and ragged N, int32 / int64 mixed
    for n in (1, 5, 3000):
        seg, mask = seg_mask(n, 6)
        yield f"n_{n}", seg, mask, factors(n, 3), 6
    # register shapes at their caps, and one past them
    seg, mask = seg_mask(1 << 20, 8)
    yield "g8_p8_cap", seg, mask, factors(1 << 20, 8), 8
    seg, mask = seg_mask(1 << 20, 9)
    yield "g9_p8_over_cap", seg, mask, factors(1 << 20, 8), 9
    seg, mask = seg_mask(1 << 20, 8)
    yield "g8_p9_over_cap", seg, mask, factors(1 << 20, 9), 8
    seg, mask = seg_mask(1 << 20, 1)
    yield "g1_p16", seg, mask, factors(1 << 20, 16), 1
    yield "g1_p0", seg, mask, [], 1
    seg, mask = seg_mask(1 << 20, 2)
    yield "g2_p16_shared", seg, mask, factors(1 << 20, 16), 2
    # every register-route instantiation (G_MAX, exact distinct pairs)
    for g_max, n_pairs in DA.REGISTER_SHAPES:
        n = 40_003
        seg, mask = seg_mask(n, g_max)
        yield f"shape_g{g_max}_p{n_pairs}", seg, mask, factors(n, n_pairs), g_max
    # sums far beyond 2^32 (the TPU kernel's carry case)
    yield ("carry", torch.zeros(2048, dtype=i32, device=dev),
           torch.ones(2048, dtype=torch.bool, device=dev),
           [(torch.full((2048,), 2 ** 30, dtype=i32, device=dev),
             torch.full((2048,), 1000, dtype=i32, device=dev))], 2)
    # products that wrap mod 2^64
    big = torch.full((4096,), 2 ** 62 + 12345, dtype=i64, device=dev)
    yield ("wrap", torch.zeros(4096, dtype=i32, device=dev),
           torch.ones(4096, dtype=torch.bool, device=dev), [(big, big)], 1)
    # all-dead masks on each route, and a count-only call
    dead = torch.zeros(1 << 20, dtype=torch.bool, device=dev)
    for G in (6, 1000, 16384):
        seg, _ = seg_mask(1 << 20, G)
        yield f"all_dead_g{G}", seg, dead, factors(1 << 20, 1), G
    seg, mask = seg_mask(1 << 20, 6)
    yield "count_only", seg, mask, [], 6
    # the shared route: mid-size G, at its last G, and the first global G
    seg, mask = seg_mask(1 << 20, 1000)
    yield "g1000_shared", seg, mask, factors(1 << 20, 2), 1000
    shared_last = DA.SHARED_BYTES_MAX // (DA.SHARED_MIN_WARPS * 2 * 8)
    for G in (shared_last, shared_last + 1):
        seg, mask = seg_mask(1 << 20, G)
        yield f"g{G}_p1", seg, mask, factors(1 << 20, 1), G
    # the largest G the dense path admits: the global route
    seg, mask = seg_mask(1 << 20, 16384)
    yield "g16384", seg, mask, factors(1 << 20, 2), 16384
    # views at an offset: all columns sliced alike (the vector loop starts 3
    # rows in), and only some of them (every row takes the scalar loop)
    for G in (6, 1000, 16384):
        n = (1 << 20) + 1
        seg, mask = seg_mask(n, G)
        pairs = factors(n, 3)
        yield (f"views_1_g{G}", seg[1:], mask[1:],
               [(a[1:], None if b is None else b[1:]) for a, b in pairs], G)
        yield f"views_mask_only_g{G}", seg[:-1], mask[1:], [
            (a[:-1], None if b is None else b[:-1]) for a, b in pairs], G


def compare_kernel(dev) -> float:
    """Every case twice through the kernel and once through the plain
    version, bit for bit; fails unless every route and every register shape
    was taken."""
    worst = 0
    taken = set()
    for name, seg, mask, pairs, G in kernel_cases(dev):
        got = DA.dense_groupby_sums(seg, mask, pairs, G)
        again = DA.dense_groupby_sums(seg, mask, pairs, G)
        want = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
        torch.cuda.synchronize()
        for g, w, a, part in zip(got, want, again, ("sums", "counts")):
            check(g.shape == w.shape, f"{name} {part} shape {tuple(g.shape)} "
                                      f"vs {tuple(w.shape)}")
            err = int((g - w).abs().max()) if g.numel() else 0
            worst = max(worst, err)
            check(torch.equal(g, w), f"{name}: kernel {part} differ from the "
                                     f"plain version (max abs err {err})")
            check(torch.equal(g, a), f"{name}: kernel {part} differ between runs")
        unique, _ = DA.distinct_pairs(pairs)
        plan = DA.card_plan(seg, G, len(unique))
        taken.add((plan.route, plan.variant))
        head, tail = DA.vector_span(
            seg.shape[0], seg.data_ptr(), mask.data_ptr(),
            [(t.data_ptr(), t.element_size()) for p in unique for t in p
             if t is not None])
        emit({"kernel_check": name, "n": int(seg.shape[0]), "G": G,
              "pairs": len(pairs), "distinct_pairs": len(unique),
              **plan._asdict(), "vector_rows": [head, tail], "bit_exact": True})
    want = {("registers", v) for v in range(len(DA.REGISTER_SHAPES))}
    want |= {("shared", -1), ("global", -1)}
    check(taken == want, f"routes taken {sorted(taken)}, want {sorted(want)}")
    return float(worst)


# ---------------------------------------------------------------------------
# 4. the main path
# ---------------------------------------------------------------------------


# the lineitem columns Q1's and Q6's pandas oracle reads
ORACLE_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                  "l_returnflag", "l_linestatus", "l_shipdate")


def oracle_lineitem(lineitem: Table):
    """lineitem as pandas, only the columns the oracle reads (converting the
    comment strings of 6M rows would cost most of a minute)."""
    idx = [lineitem.schema.index_of(c) for c in ORACLE_COLUMNS]
    return Table(Schema([lineitem.schema.fields[i] for i in idx]),
                 [lineitem.columns[i] for i in idx]).to_pandas()


class RecordKernelInputs:
    """Keeps the arguments of every dense_groupby_sums call the engine makes
    while active, so the kernel can be timed on exactly those inputs."""

    def __enter__(self):
        self.calls = []
        self._orig = DA.dense_groupby_sums

        def recording(seg, mask, pairs, G):
            self.calls.append((seg, mask, list(pairs), G))
            return self._orig(seg, mask, pairs, G)

        DA.dense_groupby_sums = recording
        return self

    def __exit__(self, *exc):
        DA.dense_groupby_sums = self._orig


def run_main_path(ctx, pdt, sf: float):
    """Q1 and Q6 once each through the public API, checked against the
    pandas oracle. Returns {qid: (launches, recorded kernel calls)}."""
    out = {}
    for qid in (1, 6):
        DA.reset_launches()
        with RecordKernelInputs() as rec:
            t0 = time.perf_counter()
            got = ctx.sql(query(qid, sf)).to_pandas()
            secs = time.perf_counter() - t0
        launches = DA.launches
        diff = frames_diff(got, ref_query(qid, pdt, sf), ordered=True)
        check(diff is None, f"Q{qid} differs from the pandas oracle: {diff}")
        check(launches > 0, f"Q{qid} never launched dense_groupby_sums")
        check(launches == len(rec.calls), f"Q{qid}: {len(rec.calls)} calls "
                                          f"but {launches} launches")
        emit({"query": f"q{qid}", "sf": sf, "rows": len(got),
              "first_run_s": secs, "kernel_launches": launches,
              "matches_oracle": True})
        out[qid] = (launches, rec.calls)
    return out


# ---------------------------------------------------------------------------
# 5. timings
# ---------------------------------------------------------------------------


def build_report(source: str) -> list:
    """Registers, stack and spill bytes of every kernel in csrc/<source>,
    from its -Xptxas -v report."""
    out, name = [], None
    for line in cuda_build.build_log(source).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append({"kernel": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def sass_opcodes(source: str, prefix: str) -> dict:
    """{kernel: count} of the SASS instructions whose opcode starts with
    `prefix` in the library built from csrc/<source> (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(source))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.search(r"\*/\s+(@!?U?P\w+\s+)?" + prefix, line):
            counts[name] += 1
    return counts


def baseline_call(lib):
    """dense_groupby_sums through the first design's library (its own C
    interface: one launch, the route chosen inside)."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.dense_groupby_sums_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ptrs, ints, ptrs, ints, ctypes.c_void_p, ctypes.c_void_p]
    lib.dense_groupby_sums_launch.restype = ctypes.c_int

    def call(seg, mask, pairs, G):
        k = max(len(pairs), 1)
        a_ptr, b_ptr = (ctypes.c_void_p * k)(), (ctypes.c_void_p * k)()
        a_bytes, b_bytes = (ctypes.c_int * k)(), (ctypes.c_int * k)()
        for i, (a, b) in enumerate(pairs):
            a_ptr[i], a_bytes[i] = a.data_ptr(), a.element_size()
            if b is not None:
                b_ptr[i], b_bytes[i] = b.data_ptr(), b.element_size()
        out = torch.zeros((G, len(pairs) + 1), dtype=torch.int64,
                          device=seg.device)
        err = lib.dense_groupby_sums_launch(
            seg.data_ptr(), mask.data_ptr(), seg.shape[0], G, len(pairs),
            a_ptr, a_bytes, b_ptr, b_bytes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first-design kernel launch failed: CUDA error {err}")
        return out[:, :len(pairs)], out[:, len(pairs)]
    return call


def kernel_timing(call, iters: int, flush: L2Flush, baseline) -> dict:
    """On the inputs of one recorded main-path call: the kernel held against
    its plain version bit for bit (twice), then the cold-L2 device ms of the
    kernel, of its first design (`baseline`, checked too), of the plain
    version and of one index_add_, with the bytes bound of that data."""
    seg, mask, pairs, G = call
    n = seg.shape[0]
    got = DA.dense_groupby_sums(seg, mask, pairs, G)
    again = DA.dense_groupby_sums(seg, mask, pairs, G)
    want = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
    check(all(torch.equal(g, w) and torch.equal(g, a)
              for g, w, a in zip(got, want, again)),
          f"main-path call (G={G}): kernel differs from the plain version "
          f"or between runs")
    live = mask & (seg >= 0) & (seg < G)
    n_live = int(live.sum())
    # bytes the data needs: seg and mask of every row, each distinct factor
    # column at live rows only (the kernel reads no factor of a dead row),
    # and the [G, pairs] sums and [G] counts written once
    factors = {}
    for a, b in pairs:
        for t in (a, b):
            if t is not None:
                factors[t.data_ptr()] = t.element_size()
    nbytes = (n * (seg.element_size() + mask.element_size())
              + n_live * sum(factors.values())
              + G * (max(len(pairs), 1) + 1) * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel = lambda: DA.dense_groupby_sums(seg, mask, pairs, G)  # noqa: E731
    kernel_ms = cold_ms(kernel, iters, flush)
    profiled_ms, profiled_seen = profiled_kernel_ms(kernel, iters, flush, "dgs_")
    back_to_back_ms = warm_ms(kernel, iters)
    first = baseline(seg, mask, pairs, G)
    check(torch.equal(first[0], want[0]) and torch.equal(first[1], want[1]),
          f"main-path call (G={G}): the first design differs from the plain "
          f"version")
    baseline_ms = cold_ms(lambda: baseline(seg, mask, pairs, G), iters, flush)
    plain_ms = cold_ms(lambda: DA.dense_groupby_sums_plain(seg, mask, pairs, G),
                       max(iters // 10, 3), flush)
    # the yardstick: one index_add_ of the precomputed product matrix
    bucket = torch.where(live, seg.to(torch.int64), G)
    vals = torch.stack([a.to(torch.int64) * (1 if b is None else b.to(torch.int64))
                        for a, b in pairs]
                       + [torch.ones(n, dtype=torch.int64, device=seg.device)], 1)
    acc = torch.zeros((G + 1, vals.shape[1]), dtype=torch.int64, device=seg.device)
    library_ms = cold_ms(lambda: acc.index_add_(0, bucket, vals), iters, flush)
    check(min(kernel_ms, profiled_ms) >= bound_ms,
          f"G={G}: a reading below the bound ({kernel_ms} / {profiled_ms} ms "
          f"< {bound_ms} ms) means the timing is wrong")
    return {"n": n, "G": G, "pairs": len(pairs), "bit_exact": True,
            "live_rows": n_live,
            "distinct_factor_columns": len(factors),
            "distinct_pairs": len(DA.distinct_pairs(pairs)[0]),
            "plan": DA.card_plan(seg, G, len(DA.distinct_pairs(pairs)[0]))._asdict(),
            "ms": kernel_ms, "profiled_ms": profiled_ms,
            "profiled_launches_seen": profiled_seen,
            "ms_warm_back_to_back": back_to_back_ms,
            "ms_shared_atomics_same_method": baseline_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes"}


def warm_timing(ctx, sql: str, repeat: int):
    """(DataFrame, dict) -- host wall time of warm runs: sql() + collect()
    each time, and collect() of one DataFrame whose plan is reused."""
    df = ctx.sql(sql)
    df.collect()
    full, exe = [], []
    for _ in range(repeat):
        t0 = time.perf_counter()
        ctx.sql(sql).collect()
        full.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        df.collect()
        exe.append((time.perf_counter() - t0) * 1e3)
    return df, {"repeat": repeat,
                "sql_collect_ms_median": statistics.median(full),
                "sql_collect_ms": full,
                "collect_ms_median": statistics.median(exe), "collect_ms": exe}


def query_timing(ctx, sf: float, qid: int, repeat: int, baseline) -> dict:
    """warm_timing, then the reused-plan collect() once more with the
    engine's kernel and with its first design (`baseline`) swapped in, in
    turns (new, first, first, new, ...), so that the two differ only by the
    kernel."""
    df, out = warm_timing(ctx, query(qid, sf), repeat)
    turns = {"kernel": [], "first_design": []}
    kernel = DA.dense_groupby_sums
    try:
        for i in range(4 * repeat):
            name = ("kernel", "first_design", "first_design", "kernel")[i % 4]
            DA.dense_groupby_sums = kernel if name == "kernel" else baseline
            df.collect()  # warm this kernel
            t0 = time.perf_counter()
            df.collect()
            turns[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        DA.dense_groupby_sums = kernel
    return {"query": f"q{qid}", "sf": sf, **out,
            "collect_ms_median_in_turns": {k: statistics.median(v)
                                           for k, v in turns.items()},
            "collect_ms_in_turns": turns}


# device-op families of the sort path, matched in order on kernel names
OP_FAMILIES = (("dense_groupby_sums", ("dgs_",)),
               ("sort", ("sort", "Sort")),
               ("scatter", ("scatter", "indexFunc", "index_add")),
               ("gather", ("index_elementwise", "gather", "index_kernel")),
               ("cumsum", ("scan", "Scan", "cumsum")),
               ("copy", ("Memcpy", "Memset", "copy")))


def op_family(name: str) -> str:
    for family, needles in OP_FAMILIES:
        if any(k in name for k in needles):
            return family
    return "other"


def profile_query(ctx, label: str, sql: str, expect=()) -> dict:
    """One warm collect() (plan reused) under torch.profiler, after one in
    its warm-up step: device busy time summed over kernels and copies on the
    card, the host wall time of the window, the kernels that took the most
    device time, and the device time of each op family (OP_FAMILIES). A
    profile that lost every device event, or a family in `expect`, is taken
    again (up to 3 times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    df = ctx.sql(sql)
    df.collect()
    for attempt in range(1, 4):
        wall = []

        def timed_collect():
            t0 = time.perf_counter()
            df.collect()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        prof = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        df.collect, timed_collect)
        # the step annotation spans the whole step: not a device op
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        if device and all(any(op_family(e.key) == f for e in device)
                          for f in expect):
            break
    check(bool(device), f"profile {label}: no device events in 3 attempts")
    wall_ms = wall[0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    families = {}
    for e in device:
        f = families.setdefault(op_family(e.key), {"ms": 0.0, "count": 0})
        f["ms"] += e.self_device_time_total / 1e3
        f["count"] += e.count
    return {"profile": label, "attempts": attempt, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in device),
            "families": families,
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


# ---------------------------------------------------------------------------
# 6. the h2o.ai groupby suite
# ---------------------------------------------------------------------------

H2O_K = 100
H2O_QUERIES = (1, 2, 3, 4, 5, 6, 7, 9, 10)  # q8 is a window query
# the kernel's launches per query, and its route there: q1 and q4 group by
# ~100 keys (shared route), q2 by ~10 000 (global route); the others sort
# or take no kernel-eligible aggregate
H2O_LAUNCHES = {1: 1, 2: 1, 4: 1}
H2O_ROUTES = {1: "shared", 2: "global", 4: "shared"}


def h2o_frame(table: Table):
    """The table as pandas, string ids as their dictionary codes: the
    dictionaries are sorted, so codes group and order as the strings do
    (and converting 3 x 1e7 strings to Python objects would take a minute)."""
    import pandas as pd

    return pd.DataFrame({f.name: np.asarray(c.data)
                         for f, c in zip(table.schema.fields, table.columns)})


def _r2(g):
    c = np.corrcoef(g["v1"], g["v2"])[0, 1]
    return c * c


def h2o_oracle(qid: int, x):
    """h2o groupby query `qid` in pandas (as tests/test_torch_h2o.py)."""
    if qid == 1:
        return x.groupby("id1", as_index=False).agg(v1=("v1", "sum"))
    if qid == 2:
        return x.groupby(["id1", "id2"], as_index=False).agg(v1=("v1", "sum"))
    if qid == 3:
        return x.groupby("id3", as_index=False).agg(v1=("v1", "sum"),
                                                    v3=("v3", "mean"))
    if qid == 4:
        return x.groupby("id4", as_index=False).agg(
            v1=("v1", "mean"), v2=("v2", "mean"), v3=("v3", "mean"))
    if qid == 5:
        return x.groupby("id6", as_index=False).agg(
            v1=("v1", "sum"), v2=("v2", "sum"), v3=("v3", "sum"))
    if qid == 6:
        return x.groupby(["id4", "id5"], as_index=False).agg(
            median_v3=("v3", "median"), sd_v3=("v3", "std"))
    if qid == 7:
        ref = x.groupby("id3", as_index=False).agg(mx=("v1", "max"),
                                                   mn=("v2", "min"))
        ref["range_v1_v2"] = ref.pop("mx") - ref.pop("mn")
        return ref
    if qid == 9:
        return (x.groupby(["id2", "id4"]).apply(_r2, include_groups=False)
                .reset_index(name="r2"))
    if qid == 10:
        return x.groupby(["id1", "id2", "id3", "id4", "id5", "id6"],
                         as_index=False).agg(v3=("v3", "sum"), cnt=("v1", "size"))
    raise ValueError(qid)


def h2o_compare(qid: int, ours: Table, ref, table: Table) -> None:
    """Multiset equality of our answer and the oracle's: rows matched by
    their group keys (unique per row), floats to rtol 1e-9 / atol 1e-9, the
    rest exact. String keys compare as codes of the input's dictionary."""
    names = [f.name for f in ours.schema.fields]
    check(names == list(ref.columns), f"h2o q{qid}: columns {names} vs "
                                      f"{list(ref.columns)}")
    check(ours.num_rows == len(ref), f"h2o q{qid}: {ours.num_rows} rows, "
                                     f"oracle {len(ref)}")
    keys = [n for n in names if n.startswith("id")]
    cols = {}
    for f, c in zip(ours.schema.fields, ours.columns):
        data = np.asarray(c.data)
        if c.validity is not None and not c.validity.all():
            # NULL is pandas' NaN (stddev or corr of a one-row group)
            check(f.dtype.is_float, f"h2o q{qid}: NULLs in {f.name}")
            data = np.where(c.validity, data, np.nan)
        if c.dictionary is not None:
            src = table.columns[table.schema.index_of(f.name)].dictionary
            check(np.array_equal(c.dictionary.values, src.values),
                  f"h2o q{qid}: {f.name} has another dictionary")
        cols[f.name] = data
    order = np.lexsort([cols[k] for k in reversed(keys)])
    ref_order = np.lexsort([ref[k].to_numpy() for k in reversed(keys)])
    for n in names:
        a, b = cols[n][order], ref[n].to_numpy()[ref_order]
        if np.issubdtype(b.dtype, np.floating):
            ok = np.allclose(a.astype(np.float64), b, rtol=1e-9, atol=1e-9,
                             equal_nan=True)
            err = float(np.nanmax(np.abs(a - b))) if len(b) else 0.0
        else:
            ok = np.array_equal(a.astype(b.dtype), b)
            err = None
        check(ok, f"h2o q{qid}: column {n} differs from the oracle "
                  f"(max abs err {err})")


def aggregate_path(df) -> str:
    """Which AggregateExec path the plan's aggregate took in its last run."""
    stack = [df.physical_plan()]
    while stack:
        p = stack.pop()
        if isinstance(p, P.AggregateExec):
            return "sorted" if hasattr(p, "_last_cap") else "dense"
        stack.extend(p.children())
    return "none"


class RecordSortKeys:
    """Counts the sorts that packed their keys into one int64 key and those
    that fell back to one stable pass per key operand."""

    def __enter__(self):
        self.packed = self.multipass = 0
        self._orig = K._packed_sort_key

        def recording(keys, sel):
            out = self._orig(keys, sel)
            if out is None:
                self.multipass += 1
            else:
                self.packed += 1
            return out

        K._packed_sort_key = recording
        return self

    def __exit__(self, *exc):
        K._packed_sort_key = self._orig


def run_h2o(ctx, table: Table, frame) -> dict:
    """h2o groupby q1-q7, q9, q10 once each through the public API, checked
    against the pandas oracle; q8 must raise. Returns {qid: (launches,
    recorded kernel calls)}."""
    out = {}
    for qid in H2O_QUERIES:
        sql = GROUPBY_QUERIES[qid - 1]
        df = ctx.sql(sql)
        DA.reset_launches()
        with RecordKernelInputs() as rec, RecordSortKeys() as sorts:
            t0 = time.perf_counter()
            got = df.collect()
            secs = time.perf_counter() - t0
        launches = DA.launches
        t0 = time.perf_counter()
        ref = h2o_oracle(qid, frame)
        oracle_s = time.perf_counter() - t0
        h2o_compare(qid, got, ref, table)
        want = H2O_LAUNCHES.get(qid, 0)
        check(launches == want == len(rec.calls),
              f"h2o q{qid}: {launches} kernel launches ({len(rec.calls)} "
              f"calls), want {want}")
        routes = [DA.kernel_route(G, len(DA.distinct_pairs(pairs)[0]))
                  for _, _, pairs, G in rec.calls]
        if qid in H2O_ROUTES:
            check(routes == [H2O_ROUTES[qid]],
                  f"h2o q{qid}: kernel routes {routes}, want {H2O_ROUTES[qid]}")
        emit({"h2o_query": f"q{qid}", "rows_in": table.num_rows,
              "rows_out": got.num_rows, "first_run_s": secs,
              "oracle_s": oracle_s, "path": aggregate_path(df),
              "sorts_packed": sorts.packed, "sorts_multipass": sorts.multipass,
              "kernel_launches": launches, "kernel_routes": routes,
              "groups": [G for _, _, _, G in rec.calls],
              "matches_oracle": True})
        out[qid] = (launches, rec.calls)
    try:
        ctx.sql(GROUPBY_QUERIES[7]).collect()
        raise RuntimeError("chip_smoke: h2o q8 (a window query) answered")
    except NotImplementedError as e:
        check("item 8" in str(e), f"h2o q8 raised without its ROADMAP item: {e}")
        emit({"h2o_query": "q8", "raises": "NotImplementedError",
              "message": str(e)})
    return out


def check_segment_extremes(dev) -> None:
    """Segment min/max on the card against the CPU: NaN propagates, empty
    segments hold the identity, int64 extremes survive, ids outside
    [0, num_segments) are dropped; -0.0 equals +0.0."""
    inputs = {
        "float": torch.tensor([1.0, float("nan"), 2.0, -0.0, 0.0, 0.0, -0.0,
                               3.0, float("inf"), -float("inf"), 7.5, 1.0],
                              dtype=torch.float64),
        "int64": torch.tensor([-(2 ** 63), 2 ** 63 - 1, 0, -1, 2 ** 63 - 1,
                               -(2 ** 63), 5, 3, 0, 2, 1, 7], dtype=torch.int64),
        "bool": torch.tensor([1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1], dtype=torch.bool),
    }
    seg = torch.tensor([0, 0, 1, 1, 1, 2, 2, 3, -1, 6, 5, 5], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.bool)
    for kind, x in inputs.items():
        for fn in (K.segment_min, K.segment_max):
            for G in (1, 6):
                want = fn(x, seg, mask, G)
                got = fn(x.to(dev), seg.to(dev), mask.to(dev), G).cpu()
                same = (torch.equal(got, want) if kind != "float" else
                        bool(((got == want) | (got.isnan() & want.isnan())).all()))
                check(same, f"{fn.__name__}({kind}, G={G}) on the card "
                            f"{got.tolist()} vs the CPU {want.tolist()}")
    emit({"segment_extremes_card_vs_cpu": "equal"})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--h2o-rows", type=int, default=10_000_000,
                    help="rows of the h2o groupby table (K = 100)")
    ap.add_argument("--repeat", type=int, default=5,
                    help="warm end-to-end runs per query")
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per kernel timing, each after an "
                         "L2 flush (the median is reported)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    card = card_line()
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    sources = [DA.SOURCE, BASELINE]
    cuda_build.build_all(sources)
    emit({"build_s": time.perf_counter() - t0, "sources": sources})
    print(cuda_build.build_log(DA.SOURCE), flush=True)
    report = build_report(DA.SOURCE)
    emit({"ptxas": DA.SOURCE, "kernels": report})
    check(len(report) == len(DA.REGISTER_SHAPES) + 2,
          f"{len(report)} kernels in the -Xptxas -v report")
    check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in report),
          "a kernel spills registers")
    # shared-memory atomics (ATOMS): none in the kernel; the first design's
    # 64-bit adds are compare-and-swap loops (ATOMS.CAST.SPIN.64)
    atoms = {s: sass_opcodes(s, "ATOMS") for s in sources}
    emit({"sass_shared_atomics": atoms})
    check(len(atoms[DA.SOURCE]) == len(report)
          and not any(atoms[DA.SOURCE].values()),
          f"shared-memory atomics in {DA.SOURCE}: {atoms[DA.SOURCE]}")
    baseline = baseline_call(cuda_build.load(BASELINE))

    max_err = compare_kernel(dev)

    t0 = time.perf_counter()
    tables = generate_tpch(args.sf, cache=False)
    ctx = SessionContext()
    check(ctx.device.type == "cuda", f"session device is {ctx.device}")
    for name, table in tables.items():
        ctx.register_table(name, table)
    pdt = {"lineitem": oracle_lineitem(tables["lineitem"])}
    emit({"datagen_s": time.perf_counter() - t0,
          "lineitem_rows": tables["lineitem"].num_rows})

    main_path = run_main_path(ctx, pdt, args.sf)
    launches = sum(n for n, _ in main_path.values())

    shapes = {}
    flush = L2Flush(dev)
    for qid, (n, calls) in main_path.items():
        t = kernel_timing(calls[-1], args.iters, flush, baseline)
        t["launches_per_query"] = n
        shapes[f"q{qid}"] = t
        emit({"kernel_timing": KERNEL["name"], "shape": f"q{qid}", **t})
    for qid in (1, 6):
        emit(query_timing(ctx, args.sf, qid, args.repeat, baseline))
    for qid in (1, 6):
        emit(profile_query(ctx, f"q{qid}", query(qid, args.sf),
                           expect=("dense_groupby_sums",)))

    check_segment_extremes(dev)
    t0 = time.perf_counter()
    h2o = generate_groupby(args.h2o_rows, k=H2O_K, seed=42)
    gen_s = time.perf_counter() - t0
    ctx.register_table("x", h2o)
    frame = h2o_frame(h2o)
    emit({"h2o_datagen_s": gen_s, "rows": h2o.num_rows, "k": H2O_K,
          "distinct": {f.name: len(c.dictionary.values)
                       for f, c in zip(h2o.schema.fields, h2o.columns)
                       if c.dictionary is not None}})
    h2o_path = run_h2o(ctx, h2o, frame)
    launches += sum(n for n, _ in h2o_path.values())
    for qid, (n, calls) in h2o_path.items():
        for call in calls:
            t = kernel_timing(call, args.iters, flush, baseline)
            t["launches_per_query"] = n
            shapes[f"h2o_q{qid}"] = t
            emit({"kernel_timing": KERNEL["name"], "shape": f"h2o_q{qid}", **t})
    for qid in H2O_QUERIES:
        emit({"h2o_timing": f"q{qid}",
              **warm_timing(ctx, GROUPBY_QUERIES[qid - 1], args.repeat)[1]})
        emit(profile_query(ctx, f"h2o_q{qid}", GROUPBY_QUERIES[qid - 1],
                           expect=("dense_groupby_sums",) if qid in H2O_LAUNCHES
                           else ()))

    q1 = shapes["q1"]
    emit({"kernels": [{**KERNEL, "launches": launches, "max_abs_err": max_err,
                       "ms": q1["ms"], "plain_ms": q1["plain_ms"],
                       "bound_ms": q1["bound_ms"], "bound_by": "bytes",
                       "library_ms": q1["library_ms"],
                       "ms_shared_atomics_same_method":
                           q1["ms_shared_atomics_same_method"],
                       "shapes": shapes}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
