#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--repeat 5]

Run from the repository root on a machine with one CUDA card and nvcc. In
order, it:
  1. prints the card's name and power limit (nvidia-smi) and the torch device;
  2. builds every hand-written kernel from csrc/ (one nvcc per source, all in
     parallel) and prints each one's -Xptxas -v report;
  3. holds each kernel against its plain PyTorch version on the card, bit for
     bit (tolerance 0: integer sums are exact), at the main path's shapes and
     at edge cases;
  4. generates TPC-H at --sf and runs Q1 and Q6 through
     SessionContext().sql(...).collect() -- the main path -- checks the answers
     against the pandas oracle with frames_diff, and checks that each query
     launched the kernel (launch counts are reset just before each query and
     read just after);
  5. holds each kernel against its plain version again, bit for bit, on the
     inputs the main path gave it, and times it there with CUDA events,
     beside its plain version, one PyTorch library call computing the same
     function, and its bound (bytes the data needs / the card's memory
     rate), then times warm Q1 and Q6 end to end;
  6. prints a {"kernels": [...]} line, the card's name and power limit, and,
     last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line is printed.
Without a CUDA device it exits with code 2 at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from datafusion_tpu_torch import Schema, SessionContext, Table
from datafusion_tpu_torch.models.tpch.compare import frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import cuda_build
from datafusion_tpu_torch.ops import dense_agg as DA

# H100 SXM device memory rate (NVIDIA data sheet), for the bytes bound
HBM_BYTES_PER_S = 3.35e12
KERNEL = {
    "name": "dense_groupby_sums",
    "route": "cuda",
    "source": "datafusion_tpu_torch/csrc/dense_groupby_sums.cu",
    "replaces": "datafusion_tpu/ops/pallas_agg.py:153",
}


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


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call of fn over `iters` back-to-back calls,
    after one warm-up call (CUDA events; host enqueue overlaps)."""
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


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------


def _rand(gen, lo: int, hi: int, n: int, dtype, dev):
    return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=dtype)


def kernel_cases(dev):
    """(name, seg, mask, pairs, G) inputs for the bit-exact comparison."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = 1 << 23

    def seg_mask(n, G, live=0.9):
        seg = _rand(gen, 0, G + 1, n, torch.int32, dev)  # id G is dropped
        mask = torch.rand(n, generator=gen, device=dev) < live
        return seg, mask

    i64 = torch.int64
    i32 = torch.int32
    # Q1's shape: 6 groups, 7 pairs of int64 decimal-like factors, one with b
    seg, mask = seg_mask(n, 6)
    price = _rand(gen, 0, 10_500_000, n, i64, dev)
    qty = _rand(gen, 100, 5_001, n, i64, dev)
    disc = _rand(gen, 0, 11, n, i64, dev)
    disc_price = _rand(gen, 0, 1_050_000_000, n, i64, dev)
    tax = _rand(gen, 100, 109, n, i64, dev)
    q1 = [(qty, None), (price, None), (disc_price, None), (disc_price, tax),
          (qty, None), (price, None), (disc, None)]
    yield "q1", seg, mask, q1, 6
    # Q6's shape: one group, one pair
    seg, mask = seg_mask(n, 1, live=0.02)
    yield "q6", seg, mask, [(price, disc)], 1
    # a ragged N with mixed int32 / int64 factors, negative values included
    seg, mask = seg_mask(3000, 6)
    a = _rand(gen, -10_000_000, 10_000_000, 3000, i32, dev)
    b = _rand(gen, 0, 10_000, 3000, i64, dev)
    c = _rand(gen, -(2 ** 31), 2 ** 31 - 1, 3000, i32, dev)
    yield "ragged", seg, mask, [(a, b), (c, None), (c, c)], 6
    # sums far beyond 2^32 (the TPU kernel's carry case)
    yield ("carry", torch.zeros(2048, dtype=i32, device=dev),
           torch.ones(2048, dtype=torch.bool, device=dev),
           [(torch.full((2048,), 2 ** 30, dtype=i32, device=dev),
             torch.full((2048,), 1000, dtype=i32, device=dev))], 2)
    # products that wrap mod 2^64
    big = torch.full((4096,), 2 ** 62 + 12345, dtype=i64, device=dev)
    yield ("wrap", torch.zeros(4096, dtype=i32, device=dev),
           torch.ones(4096, dtype=torch.bool, device=dev), [(big, big)], 1)
    # an all-dead mask, and a count-only call
    seg, _ = seg_mask(1 << 20, 6)
    dead = torch.zeros(1 << 20, dtype=torch.bool, device=dev)
    yield "all_dead", seg, dead, [(price[:1 << 20].contiguous(), None)], 6
    seg, mask = seg_mask(1 << 20, 6)
    yield "count_only", seg, mask, [], 6
    # the largest G the dense path admits: the global-atomics route
    seg, mask = seg_mask(1 << 20, 16384)
    yield ("g16384", seg, mask, [(price[:1 << 20].contiguous(),
                                  tax[:1 << 20].contiguous())], 16384)


def compare_kernel(dev) -> float:
    worst = 0
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
        emit({"kernel_check": name, "n": int(seg.shape[0]), "G": G,
              "pairs": len(pairs), "route": DA.kernel_route(G, len(pairs)),
              "bit_exact": True})
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


def kernel_timing(call, iters: int) -> dict:
    """On the inputs of one recorded main-path call: the kernel held against
    its plain version bit for bit, then the ms of the kernel, the plain
    version and one index_add_, with the bytes bound of that data."""
    seg, mask, pairs, G = call
    n = seg.shape[0]
    got = DA.dense_groupby_sums(seg, mask, pairs, G)
    want = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"main-path call (G={G}): kernel differs from the plain version")
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
    kernel_ms = cuda_ms(lambda: DA.dense_groupby_sums(seg, mask, pairs, G), iters)
    plain_ms = cuda_ms(lambda: DA.dense_groupby_sums_plain(seg, mask, pairs, G),
                       max(iters // 10, 3))
    # the yardstick: one index_add_ of the precomputed product matrix
    bucket = torch.where(live, seg.to(torch.int64), G)
    vals = torch.stack([a.to(torch.int64) * (1 if b is None else b.to(torch.int64))
                        for a, b in pairs]
                       + [torch.ones(n, dtype=torch.int64, device=seg.device)], 1)
    acc = torch.zeros((G + 1, vals.shape[1]), dtype=torch.int64, device=seg.device)
    library_ms = cuda_ms(lambda: acc.index_add_(0, bucket, vals), iters)
    return {"n": n, "G": G, "pairs": len(pairs), "bit_exact": True,
            "live_rows": n_live,
            "distinct_factor_columns": len(factors),
            "route": DA.kernel_route(G, len(pairs)), "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def query_timing(ctx, sf: float, qid: int, repeat: int) -> dict:
    """Host wall time of warm runs: sql() + collect() each time, and
    collect() of one DataFrame whose plan is reused."""
    sql = query(qid, sf)
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
    return {"query": f"q{qid}", "sf": sf, "repeat": repeat,
            "sql_collect_ms_median": statistics.median(full),
            "sql_collect_ms": full,
            "collect_ms_median": statistics.median(exe), "collect_ms": exe}


def profile_query(ctx, sf: float, qid: int) -> dict:
    """One warm collect() (plan reused) under torch.profiler: device busy
    time summed over kernels and copies on the card, the host wall time of
    the window, and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    df = ctx.sql(query(qid, sf))
    df.collect()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    return {"profile": f"q{qid}", "sf": sf, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if device else None,
            "device_ops": sum(e.count for e in device),
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--repeat", type=int, default=5,
                    help="warm end-to-end runs per query")
    ap.add_argument("--iters", type=int, default=50,
                    help="back-to-back launches per kernel timing")
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
    cuda_build.build_all([DA.SOURCE])
    emit({"build_s": time.perf_counter() - t0, "sources": [DA.SOURCE]})
    print(cuda_build.build_log(DA.SOURCE), flush=True)

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
    for qid, (n, calls) in main_path.items():
        t = kernel_timing(calls[-1], args.iters)
        t["launches_per_query"] = n
        shapes[f"q{qid}"] = t
        emit({"kernel_timing": KERNEL["name"], "shape": f"q{qid}", **t})
    for qid in (1, 6):
        emit(query_timing(ctx, args.sf, qid, args.repeat))
    for qid in (1, 6):
        emit(profile_query(ctx, args.sf, qid))

    q1 = shapes["q1"]
    emit({"kernels": [{**KERNEL, "launches": launches, "max_abs_err": max_err,
                       "ms": q1["ms"], "plain_ms": q1["plain_ms"],
                       "bound_ms": q1["bound_ms"], "bound_by": "bytes",
                       "library_ms": q1["library_ms"], "shapes": shapes}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
