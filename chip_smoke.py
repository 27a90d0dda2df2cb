#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (datafusion_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--sf 1] [--h2o-rows 10000000] [--tpcds-sf 24]
                          [--clickbench-rows 10000000] [--repeat 3]
                          [--rec-nodes 1048576] [--seed 0]
                          [--only outofcore|udf|interchange|distributed]

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
     rate), then times warm Q1 and Q6 end to end (the kernel against its
     first design in turns on the plan executed operator by operator) and
     profiles one replay of each;
  6. runs all 22 TPC-H queries at --sf through the same API, each on a new
     DataFrame (discovery: the plan operator by operator) -- joins on every
     path (direct, sort-merge, semi/anti, minmax, outer with residual,
     one-row cross joins), LIKE, CASE, IN, extract and substring -- each
     checked against the pandas oracle with frames_diff, and prints for each
     query the path of every JoinExec, the kernel's launches with their G
     and route (launch counts reset just before the query, read just
     after) and the host time of the LIKE and substring work over
     dictionaries; fails unless the kernel ran in Q4, Q11, Q15 and Q17;
     holds the kernel against its plain version, bit for bit, at every new
     shape the queries gave it and times it there as in 5;
  7. the steady state (physical/fused.py), for each TPC-H query: one
     DataFrame collected three times (discovery, capture of the CUDA graph
     and a replay, a replay), each answer checked against the oracle; fails
     unless the steady state is a captured graph, unless one warm collect()
     makes at most 2 host syncs, and unless a profiled replay launches the
     kernel where discovery did (a shared sub-plan runs once there); prints the eager collect() (the plan
     operator by operator, then the host copy) and the fused one timed in
     turns, sql()+collect(), the capture's host ms, the host syncs of each
     (torch.cuda.set_sync_debug_mode), and one profile of each (device busy,
     idle share, op families), and the memory reserved after each query;
  8. nested types (physical/nested.py, UnnestExec, array_agg, string_agg)
     on the SF 1 tables already on the card: every case of
     testing/nested_cases.py on the card, three collect()s of one
     DataFrame, each equal to the CPU (floats to rtol 1e-12, the rest
     exact); each rejected query raises the same class on both; each
     family captured under torch.cuda.set_sync_debug_mode("error") and
     replayed; then N1-N8 (array_agg grouped, its functions, unnest, 1.5M
     lineitem lists, string_agg, a word count through string_to_array,
     lambdas, set functions) through discovery and the steady state as in
     7, each answer equal to a numpy/pandas oracle, printing each one's
     discovered list width and host syncs, N1/N3/N4/N6/N8 timed and
     profiled; a table whose largest group grows between two collect()s
     must send N1's query back to discovery;
 8b. user-defined functions, the Spark library and the DataFrame API
     (run_udf): every case of testing/udf_cases.py (scalar, aggregate,
     window, table and host functions) on the card, three collect()s of
     one DataFrame, each equal to the CPU (floats to rtol 1e-9: the monoid
     scans add in their own order), the steady state a captured graph but
     for the host-function cases, which must run eagerly; each rejected
     query raises the same class on both; each family and one query over
     every Spark family captured under set_sync_debug_mode("error") and
     replayed, and a UDF that reads a device value on the host refused
     there; all 67 Spark SQL files of the reference's corpus and
     async_udf.slt, record by record on the card and on the CPU, with the
     same outcome; then over the SF 1 tables, through the checks of 7
     (a captured graph, at most 2 host syncs per warm collect(), eager
     and fused collect() in turns, one profile each way, the peak bytes
     allocated): U1, Q1 with a scalar UDF in its WHERE clause, and U2,
     Q1 and Q6 built with the DataFrame methods (each equal to the
     oracle, U2 to the SQL query's answer exactly; the kernel launched
     with the SQL query's G and route, held against its plain version
     bit for bit and timed as in 5 at a new shape); U3, a geometric-mean
     UDAF per order (1.5M groups), beside the built-in
     exp(avg(ln(abs(x)))) over the same grouping; U4, a running-sum UDWF
     per supplier; U6, Spark functions (sha2, xxhash64, pmod, bit_count,
     shiftrightunsigned, round of a decimal) grouped by ship mode, each
     against a numpy/hashlib oracle; U5, an async UDF over every row,
     whose steady state must run eagerly on the card (its host syncs, its
     collect() timed, one profile, and the host call alone timed);
 8c. recursive queries and plan interchange (run_interchange), over the
     TPC-H tables already on the card: all 22 queries encoded as Substrait
     (to_substrait, proto3 JSON) and as DataFusion LogicalPlanNode bytes
     (to_proto; the copied codecs refuse the 12 queries of NOT_CARRIED,
     which must be exactly those), decoded with from_substrait /
     from_proto and collected through the checks of 7 (a captured graph,
     at most 2 host syncs per warm collect()), each answer equal to the oracle, with the encode and
     decode ms, the JSON or protobuf length and the decoded fused collect()
     timed in turns with the SQL query's; all 22 physical plans as
     PhysicalPlanNode bytes and back, executed operator by operator, each
     equal to the oracle; Q1 and Q6 in each format must call the kernel
     with the SQL query's G and route, each call held against the plain
     version bit for bit; without google.protobuf only the Substrait half
     runs, and a line says so; then every record of the reference's
     cte.slt on the card and on the CPU with the same outcome; R1 and R2
     (testing/recursive_cases.py) over a random hierarchy of --rec-nodes
     nodes from --seed: three collect()s equal to a numpy level-by-level
     oracle, per-operator execution, the iteration count, host syncs per
     iteration, the collect() median, one profile and the peak bytes; a
     runaway recursion must stop at the cap of 100 iterations;
 8d. the distributed engine (run_distributed) on a mesh of 8 shards of the
     card (parallel/distributed.make_mesh(8, devices=[cuda:0] * 8)), over
     the TPC-H tables already on the card: dryrun_multichip(8) (Q3 through
     broadcast joins, a customer JOIN orders aggregate through partitioned
     ones, each equal to the single-device answer); all 22 queries through
     DistributedQuery with the default options, then Q3, Q5, Q10, Q18 and
     Q21 with every join partitioned, each answer (first and warm walk)
     equal to the oracle, printing each join's mode, the exchanges and the
     largest capacity they made, the slot factor, the host syncs of one
     execute(), the warm execute() + host copy (median of --repeat, up to
     3) in turns with the single-device eager collect(), and the peak
     bytes allocated; the kernel's launches in a warm walk, each call held
     against its plain version bit for bit and timed as in 5 at a new
     shape; fails unless Q1 launches it once per shard; a table whose
     group key is one value in 90% of its 2^22 rows must overflow the
     exchange, grow the slot factor and equal the single-device answer;
     approx_distinct(l_partkey) per l_returnflag with
     execution.approx_distinct_hll on must be within 5% of the exact count
     and equal on meshes of 1, 2 and 8 shards (and exact without it);
     one profile each of Q1 and Q3, printed through utils/xplane.top_ops
     with the share of device time in copies;
  9. takes the h2o.ai groupby table G1_1e7_1e2_0_0 (--h2o-rows rows,
     K = 100, seed 42; it and the hits table of 12 are generated in two
     worker processes started with the run, beside phases 1-8) and runs
     groupby q1-q10 through the same API -- the second main path -- each
     checked against a pandas oracle on the same table (floats to rtol
     1e-9 / atol 1e-9, the rest exact; q8, the two
     largest v3 per id6 through a window top-k, as a multiset) with the
     kernel's launches counted per query (q1, q2 and q4 launch it, on its
     shared and global routes); holds segment min/max on the card against
     the CPU on NaN, -0.0 and int64 extremes; holds the kernel against its
     plain version at the h2o shapes and times it there as in 5; then runs
     each query's steady state as in 7;
 10. TPC-DS (models/tpcds): at generator scale 0.05 runs all 99 queries on
     the card and on the CPU and fails unless their answers are equal
     (sqlite_oracle.frames_match, rows as multisets); then at --tpcds-sf
     (every table on the card) runs each query through the same API --
     discovery (launch counts reset just before the query and read just
     after; the kernel's launches with G and route) and its steady state as
     in 7 (each later answer equal to the discovery answer; a captured
     graph; at most 2 host syncs per warm collect()), timing and profiling
     the steady state of TPCDS_TIMED and of the three slowest queries in
     discovery; holds the kernel against its plain version at every new
     shape the queries give it and times it there as in 5. Fails if a query
     raises anything but NotImplementedError naming a ROADMAP item, and
     prints how many of the 99 run and which do not;
 11. the scalar functions and string casts (physical/functions.py,
     expr_compiler.py): every case of testing/edge_cases.py over its edge
     table (NULLs, NaN, +-0.0, int64 extremes, empty and non-ASCII strings,
     dates before 1970) on the card, three collect()s of one DataFrame, each
     equal to the CPU (floats to rtol 1e-12 / atol 1e-12, the rest exact);
     each call the reference rejects raises the same class on both; each
     function family captured once under
     torch.cuda.set_sync_debug_mode("error") and replayed; a string cast
     whose steady state meets a new value goes back to discovery;
 12. ClickBench (models/clickbench): at 100,000 rows all 43 queries on the
     card equal the CPU, and the 38 sqlite runs equal sqlite; then
     --clickbench-rows rows (every column on the card) through the same API
     as in 10 (discovery with the kernel's launches, a captured steady state
     with at most 2 host syncs, each later answer equal to discovery's, the
     kernel held and timed at every new shape); q18, q27, q28 and q42 (and
     q42 over every counter) against a pandas/numpy oracle that does not use
     the port; CLICKBENCH_TIMED timed and profiled;
 13. file tables (models/tpch/files.py, in a temporary directory removed
     at the end): the SF 1 tables written to Parquet (decimals exact, a
     page index; lineitem as 8 files in one directory, row groups of 2^20
     rows) and registered with CREATE EXTERNAL TABLE ... STORED AS PARQUET;
     each table's file bytes, full read ms and upload ms; all 22 queries
     cold (sql()+collect(), the first scan), then through the checks of 7
     (a captured graph, at most 2 host syncs per warm collect()), each
     answer against the oracle; fails unless a warm collect() uploads
     nothing, a profiled replay makes no host-to-device copy, and Q1 and
     Q6 launch the kernel; warm eager and fused collect() in turns beside
     the in-memory session's. The same for Q1 and Q6 over a pipe-delimited
     lineitem.tbl with a declared column list. Pruning: Q6 over a copy of
     lineitem sorted by l_shipdate (row groups of 2^17, a bloom filter on
     l_orderkey) must prune row groups, an l_orderkey equality there must
     prune by bloom filter, a TopK on l_orderkey must carry its dynamic
     filter; each answer equal to the in-memory session's. The statement
     cases of testing/statement_cases.py and COPY ... TO in five formats
     on the card equal the CPU; `cli.main(["-f", file])` runs Q1 over the
     Parquet files and must print its four groups. Last, the phase's
     sessions (which sit in reference cycles) are collected, so that their
     scans leave the card;
 14. out-of-core execution, run by 13 over its Parquet files before they
     go (run_outofcore): fresh sessions with a 256 MiB budget
     (execution.memory_limit_bytes) and 2^20-row chunks run TPC-H Q1, Q3,
     Q4, Q5, Q6, Q10, Q12, Q13, Q18 and Q19 chunked from memory and from
     Parquet, each against the pandas oracle, with its planning and
     collect() timed apart, its peak allocation, chunks, spills and
     launches, and the bytes allocated on the card as each scan chunk
     arrives; chunked Q1 and Q6 must launch the kernel once per chunk
     (their host syncs per chunk printed), every chunk call of Q1 is held
     bit for bit against the plain version and the kernel timed at the
     chunk's shape as in 5; chunked Q1's and Q18's peaks must stay below
     the same queries' resident ones (a new resident session), every
     query's peak must stay below the budget plus one chunk (the step in
     which it was reached is printed), and chunked Q1 must hold no earlier
     chunk when the next one arrives; `auto`
     must take the chunked route and `off` raise ResourceExhausted; an
     ORDER BY of lineitem must take the external sort and equal numpy's
     lexsort; orders x lineitem under 8 MiB must take the grace join
     (spied) and equal the resident answer; a LIMIT over an endless
     stream must pull only the batches it needs, and execute_stream's
     tables together must equal collect();
 15. prints a {"kernels": [...]} line, the card's name and power limit, and,
     last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line is printed.
Without a CUDA device it exits with code 2 at once. With `--only outofcore`
it runs 2 (the build), then 14 alone over TPC-H at --sf, with the oracle's
answers and the Parquet files made as the full run has them, and ends with
a {"only": ...} line instead of 15: a quicker run for work on that phase.
With `--only udf` it runs 2, TPC-H Q1 and Q6 at --sf as in 4 (the main
path whose kernel calls U1 and U2 must repeat), then 8b alone; with `--only
interchange`, 2, Q1 and Q6 as in 4 and the oracle's answers to the 22
queries, then 8c alone; with `--only distributed`, 2, the oracle's
answers to the 22 queries, then 8d alone.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import gc
import hashlib
import inspect
import itertools
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from datafusion_tpu_torch import Schema, SessionContext, Table
from datafusion_tpu_torch.common import types as T
from datafusion_tpu_torch.models.clickbench.datagen import START as START_DAY
from datafusion_tpu_torch.models.clickbench.datagen import generate_hits
from datafusion_tpu_torch.models.clickbench.queries import QUERIES as CLICKBENCH_QUERIES
from datafusion_tpu_torch.models.clickbench.queries import query as clickbench_query
from datafusion_tpu_torch.models.h2o.datagen import generate_groupby
from datafusion_tpu_torch.models.h2o.queries import GROUPBY_QUERIES
from datafusion_tpu_torch.models.tpcds import ALL_QUERY_IDS
from datafusion_tpu_torch.models.tpcds import query as tpcds_query
from datafusion_tpu_torch.models.tpcds.datagen import generate_tpcds
from datafusion_tpu_torch.models.tpcds.sqlite_oracle import frames_match
from datafusion_tpu_torch.models.tpch import queries_ref
from datafusion_tpu_torch.models.tpch.compare import LIMIT_QUERIES, frames_diff
from datafusion_tpu_torch.models.tpch.datagen import generate_tpch
from datafusion_tpu_torch.models.tpch.queries import query
from datafusion_tpu_torch.models.tpch.queries_ref import ref_query
from datafusion_tpu_torch.ops import cuda_build
from datafusion_tpu_torch.ops import dense_agg as DA
from datafusion_tpu_torch.ops import kernels as K
from datafusion_tpu_torch.data.device import to_host
from datafusion_tpu_torch.expr import nodes as E
from datafusion_tpu_torch.expr import udf as U
from datafusion_tpu_torch.physical import functions as F
from datafusion_tpu_torch.physical import fused as FQ
from datafusion_tpu_torch.physical import plan as P
from datafusion_tpu_torch.parallel.distributed import make_mesh
from datafusion_tpu_torch.parallel.engine import DistributedQuery, dryrun_multichip
from datafusion_tpu_torch.utils import xplane
from datafusion_tpu_torch.spark.functions import _xxhash64
from datafusion_tpu_torch.testing.edge_cases import (CASES, ERRORS, FAMILIES,
                                                     edge_table, edge_types)
from datafusion_tpu_torch.testing.nested_cases import CASES as NESTED_CASES
from datafusion_tpu_torch.testing.nested_cases import ERRORS as NESTED_ERRORS
from datafusion_tpu_torch.testing.nested_cases import FAMILIES as NESTED_FAMILIES
from datafusion_tpu_torch.testing.nested_cases import TPCH as NESTED_TPCH
from datafusion_tpu_torch.testing.nested_cases import tables as nested_tables
from datafusion_tpu_torch.testing import recursive_cases as RC
from datafusion_tpu_torch.testing import slt as port_slt
from datafusion_tpu_torch.testing import udf_cases as UC

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


# host sleep at each edge of the recorded step: the profiler keeps only the
# device events that fall inside the recorded window, and a device event's
# time stamp can come out milliseconds before the host call that launched
# it (down to -1.8 ms in tools/profiler_probe.py's runs), so a step whose
# kernels all run in its first milliseconds could lose every one of them
PROFILE_EDGE_S = 0.03


def profiled(activities, warmup, active):
    """torch.profiler over two steps: warmup() runs in the profiler's
    warm-up step, whose events are discarded (the first device events of a
    session can be lost), active() in the recorded step, between two
    PROFILE_EDGE_S sleeps with the card idle. Returns the profile."""
    from torch.profiler import profile, schedule

    torch.cuda.synchronize()
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warmup()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_EDGE_S)
        active()
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)
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

    # a profile now and then comes back without any device event: taken
    # again, a moment later, up to 6 times (as profile_call)
    for attempt in range(6):
        if attempt:
            time.sleep(0.2)
        prof = profiled([ProfilerActivity.CUDA], calls(3), calls(iters))
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        # the mean is over the launches the profiler saw; most must be there
        seen = sum(e.count for e in hits)
        if seen:
            break
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


def oracle_tables(tables: dict) -> dict:
    """Every TPC-H table as pandas, with only the columns the pandas oracle
    names (converting lineitem's comment strings, 6M rows at SF 1, would
    cost most of a minute)."""
    src = inspect.getsource(queries_ref)
    out = {}
    for name, t in tables.items():
        idx = [i for i, f in enumerate(t.schema.fields)
               if re.search(rf"\b{f.name}\b", src)]
        out[name] = Table(Schema([t.schema.fields[i] for i in idx]),
                          [t.columns[i] for i in idx]).to_pandas()
    return out


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
        # a call without pairs returns one zero column of sums, as the
        # engine's wrapper does
        sums = out[:, :len(pairs)] if pairs else torch.zeros_like(out)
        return sums, out[:, len(pairs)]
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


def eager_collect(ctx, df) -> Table:
    """collect() without the steady state: the DataFrame's physical plan
    operator by operator (the path discovery takes), then the host copy;
    under the session's function registry, as collect() runs."""
    with U.activate(ctx.functions):
        return to_host(df.physical_plan().execute(ctx.exec_context()))


def query_timing(ctx, sf: float, qid: int, repeat: int, baseline) -> dict:
    """warm_timing, then the reused plan executed operator by operator
    (eager_collect: a replayed graph would not call the wrapper) with the
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
            eager_collect(ctx, df)  # warm this kernel
            t0 = time.perf_counter()
            eager_collect(ctx, df)
            turns[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        DA.dense_groupby_sums = kernel
    return {"query": f"q{qid}", "sf": sf, **out,
            "collect_ms_median_in_turns": {k: statistics.median(v)
                                           for k, v in turns.items()},
            "collect_ms_in_turns": turns}


# device-op families of the sort and join paths, matched in order on kernel
# names ("searchsorted" before "sort", which it contains)
OP_FAMILIES = (("dense_groupby_sums", ("dgs_",)),
               ("searchsorted", ("searchsorted",)),
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


def profile_call(label: str, step, expect=(), dgs=None) -> dict:
    """One call of step() (a warm collect()) under torch.profiler, after one
    in its warm-up step: device busy time summed over kernels and copies on
    the card, the host wall time of the window, the kernels that took the
    most device time, the device time of each op family (OP_FAMILIES), the
    dense kernel's launches the profiler saw, and the least offset of a
    device event's start from its launch call on the host (negative when
    the device time stamps run early: PROFILE_EDGE_S must stay above it). A
    profile that lost every device event, or a family in `expect`, or some
    of the `dgs` dense kernel launches the step is known to make, is taken
    again, a moment later (up to 6 times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for attempt in range(1, 7):
        if attempt > 1:
            time.sleep(0.2)
        wall = []

        def timed_step():
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)

        prof = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                        step, timed_step)
        # the step annotation spans the whole step: not a device op
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        if device and all(any(op_family(e.key) == f for e in device)
                          for f in expect) and (
                dgs is None
                or sum(e.count for e in device if "dgs_" in e.key) >= dgs):
            break
    check(bool(device), f"profile {label}: no device events in 6 attempts")
    wall_ms = wall[0]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")}
    offsets = [(e.start_ns() - launch[e.correlation_id()]) / 1e3 for e in events
               if e.device_type() == DeviceType.CUDA and e.correlation_id() in launch]
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    families = {}
    for e in device:
        f = families.setdefault(op_family(e.key), {"ms": 0.0, "count": 0})
        f["ms"] += e.self_device_time_total / 1e3
        f["count"] += e.count
    return {"profile": label, "attempts": attempt, "wall_ms": wall_ms,
            "launch_to_start_us_min": min(offsets, default=None),
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_ops": sum(e.count for e in device),
            "dgs_launches": sum(e.count for e in device if "dgs_" in e.key),
            "htod_copies": sum(e.count for e in device if "HtoD" in e.key),
            "families": families,
            "top": [{"name": e.key[:90], "count": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


# ---------------------------------------------------------------------------
# 6. all 22 TPC-H queries
# ---------------------------------------------------------------------------

# the queries where the reference calls its Pallas kernel (SF 0.01): each
# must launch the kernel here too
TPCH_KERNEL_QUERIES = (4, 11, 15, 17)


def join_paths(df) -> list:
    """The path each JoinExec of the DataFrame's plan took in its last run."""
    out, stack = [], [df.physical_plan()]
    while stack:
        p = stack.pop()
        if isinstance(p, P.JoinExec):
            out.append(p.path)
        stack.extend(p.children())
    return out


class RecordDictionaryWork:
    """Host time of every call that works over a string column's dictionary
    and hands out its lookup table on the card: LIKE (F.dict_predicate) and
    substring (F.transform_dictionary). Both are cached per dictionary: a
    call that hits the cache costs microseconds."""

    NAMES = {"like": "dict_predicate", "substring": "transform_dictionary"}

    def __enter__(self):
        self.ms = {k: [] for k in self.NAMES}
        self._orig = {k: getattr(F, n) for k, n in self.NAMES.items()}

        def timed(kind):
            def call(*args):
                t0 = time.perf_counter()
                out = self._orig[kind](*args)
                self.ms[kind].append((time.perf_counter() - t0) * 1e3)
                return out
            return call

        for kind, name in self.NAMES.items():
            setattr(F, name, timed(kind))
        return self

    def __exit__(self, *exc):
        for kind, name in self.NAMES.items():
            setattr(F, name, self._orig[kind])


def host_syncs(step) -> int:
    """Host synchronisations of one call of step() (a warm collect()), as
    torch.cuda.set_sync_debug_mode("warn") reports them (the result's
    copy to the host included)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def run_tpch22(ctx, frames, sf: float):
    """All 22 TPC-H queries once each through the public API (a new
    DataFrame: discovery, the eager path), checked against the pandas
    oracle. Returns ({qid: (launches, recorded kernel calls)}, {qid: the
    oracle's answer})."""
    out, refs = {}, {}
    for qid in range(1, 23):
        sql = query(qid, sf)
        df = ctx.sql(sql)
        DA.reset_launches()
        with RecordKernelInputs() as rec, RecordDictionaryWork() as dwork:
            t0 = time.perf_counter()
            got = df.collect()
            secs = time.perf_counter() - t0
        launches = DA.launches
        t0 = time.perf_counter()
        ref = ref_query(qid, frames, sf)
        oracle_s = time.perf_counter() - t0
        diff = frames_diff(got.to_pandas(), ref, ordered=qid in LIMIT_QUERIES)
        check(diff is None, f"TPC-H Q{qid} differs from the pandas oracle: {diff}")
        check(launches == len(rec.calls), f"TPC-H Q{qid}: {len(rec.calls)} calls "
                                          f"but {launches} launches")
        if qid in TPCH_KERNEL_QUERIES:
            check(launches > 0, f"TPC-H Q{qid} never launched dense_groupby_sums")
        paths = join_paths(df)
        check(all(paths), f"TPC-H Q{qid}: a JoinExec recorded no path: {paths}")
        emit({"tpch_query": f"q{qid}", "sf": sf, "rows": got.num_rows,
              "first_run_s": secs, "oracle_s": oracle_s, "join_paths": paths,
              "kernel_launches": launches,
              "kernel_calls": [{"G": G, "pairs": len(pairs),
                                "route": DA.kernel_route(G, len(DA.distinct_pairs(pairs)[0]))}
                               for _, _, pairs, G in rec.calls],
              "dictionary_host_ms": dwork.ms, "matches_oracle": True})
        out[qid] = (launches, rec.calls)
        refs[qid] = ref
    return out, refs


# ---------------------------------------------------------------------------
# 7. the h2o.ai groupby suite
# ---------------------------------------------------------------------------

H2O_K = 100
H2O_QUERIES = tuple(range(1, 11))
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
    if qid == 8:
        return (x.sort_values("v3", ascending=False).groupby("id6").head(2)
                [["id6", "v3"]].rename(columns={"v3": "largest2_v3"}))
    raise ValueError(qid)


def h2o_compare(qid: int, ours: Table, ref, table: Table) -> None:
    """Multiset equality of our answer and the oracle's: rows matched by
    their group keys (unique per row; q8's two rows per id6 also by their
    value, which the query selects and does not compute), floats to rtol
    1e-9 / atol 1e-9, the rest exact. String keys compare as codes of the
    input's dictionary."""
    names = [f.name for f in ours.schema.fields]
    check(names == list(ref.columns), f"h2o q{qid}: columns {names} vs "
                                      f"{list(ref.columns)}")
    check(ours.num_rows == len(ref), f"h2o q{qid}: {ours.num_rows} rows, "
                                     f"oracle {len(ref)}")
    keys = [n for n in names if n.startswith("id") or qid == 8]
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


def run_h2o(ctx, table: Table, frame):
    """h2o groupby q1-q10 once each through the public API (a new DataFrame:
    discovery), checked against the pandas oracle. Returns ({qid: (launches, recorded kernel calls)}, {qid: the oracle's
    answer})."""
    out, refs = {}, {}
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
              "operators": new_operators(df), "matches_oracle": True})
        out[qid] = (launches, rec.calls)
        refs[qid] = ref
    return out, refs


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


# ---------------------------------------------------------------------------
# 8. the steady state: discovery, capture, replay
# ---------------------------------------------------------------------------


def fused_query(ctx, label: str, sql, same, repeat: int, timed: bool = True,
                discovered=None) -> dict:
    """One DataFrame (of the SQL text `sql`, or the one `sql()` builds when
    it is a callable) collected three times -- discovery, the capture of its
    steady state (then one replay), a replay -- each answer held by
    `same(table)` against the oracle; the steady state must be a captured
    CUDA graph, and one warm fused collect() may make 2 host syncs (its
    overflow flag and the host copy, or 1 without an overflow guard).
    `discovered` = (DataFrame, discovery ms, kernel launches) of a DataFrame
    already collected once takes the place of the first collect(). When
    `timed`: in turns on the same DataFrame, the eager collect()
    (eager_collect) and the fused one (replay); sql()+collect() on a new
    DataFrame each time (discovery); the host syncs of the eager collect();
    and one profile each way, where the replay must launch the dense kernel
    as often as the steady state's eager run did, which launches it where
    discovery did (a sub-plan shared by two parents, such as Q15's view,
    runs once in the steady state)."""
    make = sql if callable(sql) else lambda: ctx.sql(sql)
    if discovered is None:
        df = make()
        DA.reset_launches()
        t0 = time.perf_counter()
        got = df.collect()
        discovery_ms = (time.perf_counter() - t0) * 1e3
        same(got)
        launches = DA.launches
    else:
        df, discovery_ms, launches = discovered
    fq = df._fused_query()
    # the build runs the steady state once eagerly before capturing it: its
    # launches are what one replay launches (a shared sub-plan, as Q15's
    # view, runs once there and twice in discovery)
    DA.reset_launches()
    t0 = time.perf_counter()
    got = df.collect()
    build_ms = (time.perf_counter() - t0) * 1e3
    same(got)
    del got
    steady_launches = DA.launches
    check((steady_launches > 0) == (launches > 0) and steady_launches <= launches,
          f"{label}: the steady state launched the dense kernel "
          f"{steady_launches} times, discovery {launches}")
    check(isinstance(fq._fused, FQ._Graph),
          f"{label}: the steady state is {type(fq._fused).__name__}, not a "
          f"captured CUDA graph")
    graph = fq._fused
    same(df.collect())
    check(fq._fused is graph, f"{label}: a replay captured the graph again")
    fused_syncs = host_syncs(df.collect)
    check(fused_syncs <= 2, f"{label}: {fused_syncs} host syncs in one "
                            f"warm fused collect()")
    out = {"fused_query": label, "graph": True,
           "discovery_ms": discovery_ms, "capture_ms": fq.capture_ms,
           "second_collect_ms": build_ms, "host_syncs": {"fused": fused_syncs},
           "dgs_launches_discovery": launches,
           "dgs_launches_steady_eager": steady_launches, "matches_oracle": True}
    if timed:
        turns = {"eager": [], "fused": []}
        for i in range(2 * repeat):
            name = ("eager", "fused", "fused", "eager")[i % 4]
            t0 = time.perf_counter()
            eager_collect(ctx, df) if name == "eager" else df.collect()
            turns[name].append((time.perf_counter() - t0) * 1e3)
        full = []
        for _ in range(repeat):
            t0 = time.perf_counter()
            make().collect()
            full.append((time.perf_counter() - t0) * 1e3)
        out["host_syncs"]["eager"] = host_syncs(lambda: eager_collect(ctx, df))
        expect = ("dense_groupby_sums",) if launches else ()
        eager = profile_call(f"{label}_eager", lambda: eager_collect(ctx, df), expect)
        fused = profile_call(f"{label}_fused", df.collect, expect,
                             dgs=steady_launches)
        check(fused["dgs_launches"] == steady_launches,
              f"{label}: {fused['dgs_launches']} dense kernel launches in one "
              f"replay, {steady_launches} in the steady state's eager run")
        check(fq._fused is graph, f"{label}: the graph was captured again")
        out.update({
            "eager_collect_ms_median": statistics.median(turns["eager"]),
            "fused_collect_ms_median": statistics.median(turns["fused"]),
            "sql_collect_ms_median": statistics.median(full),
            "dgs_launches_replay": fused["dgs_launches"],
            "eager_busy_ms": eager["device_busy_ms"],
            "eager_idle_share": eager["device_idle_share"],
            "eager_device_ops": eager["device_ops"],
            "fused_busy_ms": fused["device_busy_ms"],
            "fused_idle_share": fused["device_idle_share"],
            "fused_device_ops": fused["device_ops"],
            "fused_wall_ms": fused["wall_ms"],
            # the profiler slows the host: busy time against the median of
            # the unprofiled collect() too
            "eager_idle_share_vs_median": 1.0 - eager["device_busy_ms"]
            / statistics.median(turns["eager"]),
            "fused_idle_share_vs_median": 1.0 - fused["device_busy_ms"]
            / statistics.median(turns["fused"]),
            "collect_ms_in_turns": turns, "sql_collect_ms": full})
        emit(eager)
        emit(fused)
    del df, fq, graph
    torch.cuda.empty_cache()
    out["memory_reserved_after"] = torch.cuda.memory_reserved()
    return out


def run_fused_tpch(ctx, sf: float, refs, repeat: int) -> None:
    """fused_query over the 22 TPC-H queries (`refs`: their oracle answers)."""
    for qid in range(1, 23):
        def same(got, qid=qid):
            diff = frames_diff(got.to_pandas(), refs[qid],
                               ordered=qid in LIMIT_QUERIES)
            check(diff is None, f"fused TPC-H Q{qid} differs from the pandas "
                                f"oracle: {diff}")
        emit(fused_query(ctx, f"tpch_q{qid}", query(qid, sf), same, repeat))
    emit({"phase": "fused_tpch", "memory_reserved": torch.cuda.memory_reserved()})


# ---------------------------------------------------------------------------
# 9. TPC-DS
# ---------------------------------------------------------------------------

# the scale at which every query runs on the card and on the CPU (the JAX
# package's own TPC-DS test scale)
TPCDS_CHECK_SF = 0.05
# steady states timed and profiled, besides the three slowest in discovery
TPCDS_TIMED = (5, 12, 36, 47, 51, 66, 70, 78, 84, 98)
TPCDS_REPEAT = 3


def new_operators(df) -> list:
    """The operator kinds of the DataFrame's plan that this slice ported."""
    kinds, stack = set(), [df.physical_plan()]
    while stack:
        p = stack.pop()
        kinds.add(type(p).__name__)
        stack.extend(p.children())
    return sorted(kinds & {"UnionExec", "ValuesExec", "EmptyExec", "WindowExec",
                           "WindowTopKExec"})


def tpcds_session(tables, device=None) -> SessionContext:
    ctx = SessionContext(device=device)
    for name, t in tables.items():
        ctx.register_table(name, t)
    return ctx


def not_ported(qid: int, e: NotImplementedError) -> dict:
    check("ROADMAP" in str(e), f"TPC-DS q{qid} raised NotImplementedError "
                               f"without its ROADMAP item: {e}")
    return {"tpcds_query": f"q{qid}", "raises": "NotImplementedError",
            "message": str(e)}


def run_tpcds_card_vs_cpu(sf: float) -> None:
    """Every TPC-DS query at generator scale sf on the card and on the CPU;
    their answers must be equal (frames_match, rows as multisets)."""
    t0 = time.perf_counter()
    tables = generate_tpcds(sf)
    card, cpu = tpcds_session(tables), tpcds_session(tables, "cpu")
    gen_s = time.perf_counter() - t0
    ran, raised, nonempty = [], {}, 0
    for qid in ALL_QUERY_IDS:
        sql = tpcds_query(qid)
        try:
            got = card.sql(sql).to_pandas()
        except NotImplementedError as e:
            raised[qid] = not_ported(qid, e)["message"]
            continue
        diff = frames_match(got, cpu.sql(sql).to_pandas())
        check(diff is None, f"TPC-DS q{qid} at scale {sf}: the card differs "
                            f"from the CPU: {diff}")
        ran.append(qid)
        nonempty += len(got) > 0
    emit({"tpcds_card_vs_cpu": "equal", "sf": sf, "datagen_s": gen_s,
          "queries_run": len(ran), "nonempty_answers": nonempty,
          "raised": raised, "s": time.perf_counter() - t0})


def run_tpcds(sf: float, repeat: int, shapes: dict, seen: set, iters: int,
              flush, baseline) -> int:
    """Every TPC-DS query at generator scale sf through the public API: its
    discovery (kernel inputs recorded), then its steady state (fused_query,
    each answer equal to the discovery answer); the kernel held and timed at
    every new shape. Then the timed steady states. Returns the kernel's
    launches over the discoveries."""
    t0 = time.perf_counter()
    tables = generate_tpcds(sf)
    ctx = tpcds_session(tables)
    emit({"tpcds_datagen_s": time.perf_counter() - t0, "sf": sf,
          "rows": {name: t.num_rows for name, t in tables.items()}})
    launches, answers, discovery_ms, raised = 0, {}, {}, {}
    for qid in ALL_QUERY_IDS:
        sql = tpcds_query(qid)
        df = ctx.sql(sql)
        DA.reset_launches()
        with RecordKernelInputs() as rec:
            t0 = time.perf_counter()
            try:
                got = df.collect()
            except NotImplementedError as e:
                line = not_ported(qid, e)
                raised[qid] = line["message"]
                emit(line)
                continue
            ms = (time.perf_counter() - t0) * 1e3
        n = DA.launches
        check(n == len(rec.calls), f"TPC-DS q{qid}: {len(rec.calls)} calls but "
                                   f"{n} launches")
        launches += n
        answers[qid] = got.to_pandas()
        discovery_ms[qid] = ms
        emit({"tpcds_query": f"q{qid}", "sf": sf, "rows": got.num_rows,
              "discovery_ms": ms, "operators": new_operators(df),
              "kernel_launches": n,
              "kernel_calls": [{"G": G, "pairs": len(pairs),
                                "route": DA.kernel_route(G, len(DA.distinct_pairs(pairs)[0]))}
                               for _, _, pairs, G in rec.calls],
              "memory_reserved": torch.cuda.memory_reserved()})
        del got

        def same(t, qid=qid):
            diff = frames_match(t.to_pandas(), answers[qid])
            check(diff is None, f"TPC-DS q{qid}: the steady state's answer "
                                f"differs from discovery's: {diff}")

        emit(fused_query(ctx, f"tpcds_q{qid}", sql, same, repeat, timed=False,
                         discovered=(df, ms, n)))
        del df
        for call in rec.calls:
            shape = (int(call[0].shape[0]), call[3], len(call[2]))
            if shape in seen:
                continue
            seen.add(shape)
            t = kernel_timing(call, iters, flush, baseline)
            t["launches_per_query"] = n
            label = f"tpcds_q{qid}_G{call[3]}"
            shapes[label] = t
            emit({"kernel_timing": KERNEL["name"], "shape": label, **t})
        del rec
    slowest = sorted(discovery_ms, key=discovery_ms.get)[-3:]
    timed = sorted(set(TPCDS_TIMED) | set(slowest))
    for qid in timed:
        if qid not in answers:
            continue

        def same(t, qid=qid):
            diff = frames_match(t.to_pandas(), answers[qid])
            check(diff is None, f"TPC-DS q{qid}: a timed run's answer differs "
                                f"from discovery's: {diff}")

        emit(fused_query(ctx, f"tpcds_q{qid}_timed", tpcds_query(qid), same, repeat))
    emit({"phase": "tpcds", "sf": sf, "queries_run": len(answers),
          "not_run": sorted(raised), "raised": raised,
          "timed": timed, "slowest_in_discovery": slowest,
          "memory_reserved": torch.cuda.memory_reserved()})
    check(len(answers) >= 95, f"only {len(answers)} of the 99 TPC-DS queries ran")
    return launches


# ---------------------------------------------------------------------------
# 10. scalar functions and string casts: the card against the CPU
# ---------------------------------------------------------------------------

FLOAT_TOL = 1e-12  # rtol and atol of floats, card against CPU


def cells(table) -> list:
    """Per column (type, [raw value or None per row]): strings decoded
    through their dictionary, numbers as stored."""
    out = []
    for f, c in zip(table.schema.fields, table.columns):
        valid = c.valid_mask()
        vals = [None if not valid[r] else
                c.dictionary.values[int(c.data[r])] if f.dtype.is_string else
                c.data[r].item() for r in range(table.num_rows)]
        out.append((repr(f.dtype), vals))
    return out


def same_cells(got: list, want: list) -> bool:
    def same(a, b):
        if isinstance(a, float) or isinstance(b, float):
            if a is None or b is None:
                return a is b
            if np.isnan(a) or np.isnan(b):
                return bool(np.isnan(a) and np.isnan(b))
            return a == b or abs(a - b) <= FLOAT_TOL + FLOAT_TOL * abs(b)
        return a == b

    return len(got) == len(want) and all(
        gt == wt and len(gv) == len(wv) and all(same(x, y) for x, y in zip(gv, wv))
        for (gt, gv), (wt, wv) in zip(got, want))


def run_functions() -> None:
    """Every function and cast case of testing/edge_cases.py over its edge
    table, on the card (three collect()s of one DataFrame: discovery, the
    steady state's capture, a replay) and on the CPU, equal; every call the
    reference rejects raises the same class on both; each family once
    captured under torch.cuda.set_sync_debug_mode("error"), then replayed,
    equal to the CPU."""
    t0 = time.perf_counter()
    card, cpu = SessionContext(), SessionContext(device="cpu")
    for ctx in (card, cpu):
        ctx.register_table("t", Table.from_pydict(edge_table(), edge_types(T)))
    for name, expr in sorted(CASES.items()):
        sql = f"SELECT k, {expr} AS v FROM t"
        want = cells(cpu.sql(sql).collect())
        df = card.sql(sql)
        for i in range(3):
            check(same_cells(cells(df.collect()), want),
                  f"functions {name}: collect() {i + 1} on the card differs "
                  f"from the CPU")
        check(isinstance(df._fused_query()._fused, FQ._Graph),
              f"functions {name}: no captured graph")
    for name, expr in sorted(ERRORS.items()):
        sql = f"SELECT k, {expr} AS v FROM t"
        raised = []
        for ctx in (card, cpu):
            try:
                ctx.sql(sql).collect()
                raised.append(None)
            except Exception as e:  # noqa: BLE001 -- compared between devices
                raised.append(type(e).__name__)
        check(raised[0] is not None and raised[0] == raised[1],
              f"functions {name}: the card raises {raised[0]}, the CPU {raised[1]}")
    for family, expr in sorted(FAMILIES.items()):
        sql = f"SELECT k, {expr} AS v FROM t WHERE k <> 8"
        want = cells(cpu.sql(sql).collect())
        df = card.sql(sql)
        df.collect()
        fq = df._fused_query()
        inputs = tuple(leaf.execute(card.exec_context()) for leaf in fq.leaves)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a sync in warm-up or capture raises
        try:
            graph = FQ._Graph(fq._steady_fn(), inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for _ in range(2):
            rel, overflow = graph.run()
            check(not overflow, f"functions family {family}: the replay overflowed")
            if family != "clock":  # the clock is read once per steady state
                check(same_cells(cells(to_host(rel)), want),
                      f"functions family {family}: a replay differs from the CPU")
    # a value the steady state's string-cast table lacks: the scan's tensor
    # changes in place, the replay raises the flag, discovery renders it
    card.register_table("u", {"x": [1, 2, 3, 1]})
    df = card.sql("SELECT CAST(x AS VARCHAR) AS s FROM u")
    check([df.to_pydict()["s"] for _ in range(3)] == [["1", "2", "3", "1"]] * 3
          and isinstance(df._fused_query()._fused, FQ._Graph),
          "functions: CAST(x AS VARCHAR) on the card")
    card.catalog.get("u")._device[str(card.device)]["x"].data[1] = 77
    check(df.to_pydict()["s"] == ["1", "77", "3", "1"]
          and df._fused_query()._fused is None,
          "functions: a new value did not send the string cast back to discovery")
    check([df.to_pydict()["s"] for _ in range(2)] == [["1", "77", "3", "1"]] * 2,
          "functions: the steady state after rediscovery")
    emit({"phase": "functions", "cases": len(CASES), "rejected": len(ERRORS),
          "families_captured": sorted(FAMILIES), "card_equals_cpu": True,
          "s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# 11. ClickBench
# ---------------------------------------------------------------------------

# the scale at which every answer is checked on the card, on the CPU and,
# where sqlite runs the query, against sqlite
CLICKBENCH_CHECK_ROWS = 100_000
# sqlite cannot run 18 (extract minute), 28 (regexp_replace), 42
# (date_trunc); 36/37 cut ties at their LIMIT, where either engine's rows
# are a right answer
CLICKBENCH_SQLITE_SKIP = {18, 28, 36, 37, 42}
# steady states timed and profiled: this slice's functions, the
# high-cardinality groupings, the LIKE scans, the 90 sums
CLICKBENCH_TIMED = (16, 18, 20, 21, 27, 28, 29, 32, 33, 42)
CLICKBENCH_REPEAT = 3


def hits_sqlite(table: Table):
    import sqlite3

    import pandas as pd

    df = table.to_pandas()
    for c in df.columns:
        if pd.api.types.is_datetime64_any_dtype(df[c].dtype):
            fmt = ("%Y-%m-%d %H:%M:%S"
                   if (df[c].dt.hour.fillna(0) != 0).any() else "%Y-%m-%d")
            df[c] = df[c].dt.strftime(fmt).where(df[c].notna(), None)
    conn = sqlite3.connect(":memory:")
    conn.create_function("length", 1, lambda v: len(v) if v is not None else None)
    df.to_sql("hits", conn, index=False)
    return conn


def run_clickbench_check(rows: int) -> None:
    """All 43 queries at `rows` on the card and on the CPU, equal as
    multisets (sqlite_oracle.frames_match), and the 38 sqlite runs equal to
    a sqlite copy of the table."""
    from datafusion_tpu_torch.models.tpcds.sqlite_oracle import run_sqlite

    t0 = time.perf_counter()
    table = generate_hits(rows)
    card, cpu = SessionContext(), SessionContext(device="cpu")
    for ctx in (card, cpu):
        ctx.register_table("hits", table)
    lite = hits_sqlite(table)
    nonempty = 0
    for qid in range(len(CLICKBENCH_QUERIES)):
        sql = clickbench_query(qid, rows)
        got = card.sql(sql).to_pandas()
        diff = frames_match(got, cpu.sql(sql).to_pandas())
        check(diff is None, f"ClickBench q{qid} at {rows} rows: the card "
                            f"differs from the CPU: {diff}")
        if qid not in CLICKBENCH_SQLITE_SKIP:
            diff = frames_match(got, run_sqlite(lite, sql))
            check(diff is None, f"ClickBench q{qid} at {rows} rows differs "
                                f"from sqlite: {diff}")
        nonempty += len(got) > 0
    lite.close()
    emit({"clickbench_check": "equal", "rows": rows,
          "queries": len(CLICKBENCH_QUERIES),
          "against_sqlite": len(CLICKBENCH_QUERIES) - len(CLICKBENCH_SQLITE_SKIP),
          "nonempty_answers": nonempty, "s": time.perf_counter() - t0})


def _col(table: Table, name: str):
    c = table.columns[table.schema.index_of(name)]
    return np.asarray(c.data), c.dictionary


def clickbench_oracle(qid: str, table: Table, rows: int):
    """The four queries of the scalar-function slice in pandas / numpy over
    the generator's arrays (string columns as dictionary codes; a function
    of a string is computed over the dictionary with Python's str / re and
    gathered by code): q18's minute is floor((us // 10^6) / 60) mod 60, q27's
    length str.len, q28's key re.sub with the query's pattern, q42's minute
    floor(us / 6e7) * 6e7. Returns the full answer before its LIMIT, as a
    DataFrame in the query's order."""
    import pandas as pd

    big = max(rows // 500, 10)
    if qid == "q18":
        sp, _ = _col(table, "SearchPhrase")
        us, _ = _col(table, "EventTime")
        uid, _ = _col(table, "UserID")
        frame = pd.DataFrame({"UserID": uid, "m": (us // 1_000_000 // 60) % 60,
                              "sp": sp})
        return frame.groupby(["UserID", "m", "sp"]).size().rename("c").reset_index()
    if qid in ("q27", "q28"):
        name = "URL" if qid == "q27" else "Referer"
        codes, d = _col(table, name)
        vals = pd.Series(list(d.values), dtype=object)
        keep = vals.to_numpy()[codes] != ""
        frame = pd.DataFrame({"l": vals.str.len().to_numpy()[codes][keep]})
        if qid == "q27":
            frame["k"] = _col(table, "CounterID")[0][keep]
        else:
            pattern, repl = re.search(r"regexp_replace\(Referer, '(.*?)', '(.*?)'\)",
                                      clickbench_query(28, rows)).groups()
            rx = re.compile(pattern)
            keys = np.array([rx.sub(repl, v) for v in d.values], dtype=object)
            frame["k"] = keys[codes][keep]
            frame["m"] = codes[keep]  # the sorted dictionary: min code, min string
        g = frame.groupby("k")
        out = pd.DataFrame({"l": g["l"].mean(), "c": g.size()})
        if qid == "q28":
            out["m"] = [d.values[c] for c in g["m"].min()]
        out = out[out["c"] > big].reset_index()
        return out.sort_values("l", ascending=False, kind="stable")
    # q42 and its form over every counter without the offset
    us, _ = _col(table, "EventTime")
    day, _ = _col(table, "EventDate")
    keep = ((_col(table, "IsRefresh")[0] == 0) & (_col(table, "DontCountHits")[0] == 0)
            & (day >= START_DAY + 13) & (day <= START_DAY + 14))
    if qid == "q42":
        keep &= _col(table, "CounterID")[0] == 62
    m = (us[keep] // 60_000_000) * 60_000_000
    out = pd.Series(m).value_counts().sort_index()
    return pd.DataFrame({"m": out.index.to_numpy(), "pv": out.to_numpy()})


def check_clickbench_oracle(qid: str, got: Table, table: Table, rows: int) -> dict:
    """Our answer against clickbench_oracle: q18 row by row by its keys and
    the multiset of the top 10 counts (ties at the LIMIT may pick other
    rows); q27 / q28 each returned row equal to the oracle's for its key,
    and the averages in order; q42 exactly (minutes as microseconds)."""
    t0 = time.perf_counter()
    ref = clickbench_oracle(qid, table, rows)
    ours = got.to_pandas()
    if qid == "q18":
        d = _col(table, "SearchPhrase")[1]
        code = {v: i for i, v in enumerate(d.values)}
        index = ref.set_index(["UserID", "m", "sp"])["c"]
        for r in ours.itertuples(index=False):
            check(index[(r.UserID, r.m, code[r.SearchPhrase])] == r.c,
                  f"ClickBench q18: {r} differs from the oracle")
        top = sorted(ref["c"].nlargest(10).tolist(), reverse=True)
        check(sorted(ours["c"].tolist(), reverse=True) == top,
              f"ClickBench q18: counts {ours['c'].tolist()} vs {top}")
    elif qid in ("q27", "q28"):
        n = 25
        check(len(ours) == min(n, len(ref)), f"ClickBench {qid}: {len(ours)} rows")
        index = ref.set_index("k")
        key = ours.columns[0]
        for r in ours.itertuples(index=False):
            want = index.loc[getattr(r, key)]
            check(int(want["c"]) == r.c and abs(want["l"] - r.l) <= 1e-9 * abs(want["l"]),
                  f"ClickBench {qid}: {r} differs from the oracle {dict(want)}")
            if qid == "q28":
                check(want["m"] == r.m, f"ClickBench q28: MIN(Referer) {r.m} vs {want['m']}")
        check(np.allclose(ours["l"].to_numpy(), ref["l"].to_numpy()[:n], rtol=1e-9),
              f"ClickBench {qid}: the averages in order differ from the oracle")
    else:
        want = ref.iloc[1000:1010] if qid == "q42" else ref.iloc[:10]
        check(ours["pv"].tolist() == want["pv"].tolist()
              and (ours["m"].astype("int64") // 1000).tolist() == want["m"].tolist(),
              f"ClickBench {qid}: differs from the oracle")
    return {"clickbench_oracle": qid, "rows_out": len(ours), "oracle_rows": len(ref),
            "s": time.perf_counter() - t0}


def device_bytes(provider) -> int:
    """Bytes of the columns a MemTable holds on the card."""
    total = 0
    for cols in provider._device.values():
        for c in cols.values():
            for part in ("data", "validity"):
                t = getattr(c, part, None)
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    total += t.numel() * t.element_size()
    return total


def run_clickbench(rows: int, generated, repeat: int, shapes: dict, seen: set,
                   iters: int, flush, baseline) -> int:
    """The 43 ClickBench queries over `rows` generated hits rows (every
    column on the card; `generated`: the table from generate_table) through
    the public API: each query's discovery (kernel inputs recorded,
    launches counted), its steady state
    (fused_query: each later answer equal to discovery's, a captured graph,
    at most 2 host syncs per warm collect()), q18, q27, q28 and q42 (and
    q42 over every counter) against clickbench_oracle; the kernel held and
    timed at every new shape; then the CLICKBENCH_TIMED steady states timed
    and profiled. Returns the kernel's launches over the discoveries."""
    t0 = time.perf_counter()
    table, gen_s = generated.get()
    wait_s = time.perf_counter() - t0
    ctx = SessionContext()
    ctx.register_table("hits", table)
    t0 = time.perf_counter()
    ctx.catalog.get("hits").scan_device(ctx.exec_context())  # every column
    torch.cuda.synchronize()
    emit({"clickbench_datagen_s": gen_s, "datagen_wait_s": wait_s, "rows": rows,
          "columns": len(table.schema.fields), "upload_s": time.perf_counter() - t0,
          "hits_device_bytes": device_bytes(ctx.catalog.get("hits"))})
    sqls = {f"q{qid}": clickbench_query(qid, rows)
            for qid in range(len(CLICKBENCH_QUERIES))}
    sqls["q42_all_counters"] = (sqls["q42"].replace("CounterID = 62 AND ", "")
                                .replace(" OFFSET 1000", ""))
    launches, answers = 0, {}
    for label, sql in sqls.items():
        df = ctx.sql(sql)
        DA.reset_launches()
        with RecordKernelInputs() as rec:
            t0 = time.perf_counter()
            got = df.collect()
            ms = (time.perf_counter() - t0) * 1e3
        n = DA.launches
        check(n == len(rec.calls), f"ClickBench {label}: {len(rec.calls)} calls "
                                   f"but {n} launches")
        launches += n
        answers[label] = got.to_pandas()
        emit({"clickbench_query": label, "rows": got.num_rows, "discovery_ms": ms,
              "kernel_launches": n,
              "kernel_calls": [{"G": G, "pairs": len(pairs),
                                "route": DA.kernel_route(G, len(DA.distinct_pairs(pairs)[0]))}
                               for _, _, pairs, G in rec.calls]})
        if label in ("q18", "q27", "q28", "q42", "q42_all_counters"):
            emit(check_clickbench_oracle(label, got, table, rows))
        del got

        def same(t, label=label):
            diff = frames_match(t.to_pandas(), answers[label])
            check(diff is None, f"ClickBench {label}: the steady state's answer "
                                f"differs from discovery's: {diff}")

        emit(fused_query(ctx, f"clickbench_{label}", sql, same, repeat, timed=False,
                         discovered=(df, ms, n)))
        del df
        for call in rec.calls:
            shape = (int(call[0].shape[0]), call[3], len(call[2]))
            if shape in seen:
                continue
            seen.add(shape)
            t = kernel_timing(call, iters, flush, baseline)
            t["launches_per_query"] = n
            name = f"clickbench_{label}_G{call[3]}_pairs{len(call[2])}"
            shapes[name] = t
            emit({"kernel_timing": KERNEL["name"], "shape": name, **t})
        del rec
    for qid in CLICKBENCH_TIMED:
        label = f"q{qid}"

        def same(t, label=label):
            diff = frames_match(t.to_pandas(), answers[label])
            check(diff is None, f"ClickBench {label}: a timed run's answer "
                                f"differs from discovery's: {diff}")

        emit(fused_query(ctx, f"clickbench_{label}_timed", sqls[label], same, repeat))
    emit({"phase": "clickbench", "rows": rows, "queries_run": len(answers),
          "memory_reserved": torch.cuda.memory_reserved()})
    return launches


# ---------------------------------------------------------------------------
# 12. nested types: the card against the CPU, then N1-N8 at TPC-H scale
# ---------------------------------------------------------------------------

# the queries timed and profiled (eager and fused collect() in turns)
NESTED_TIMED = ("N1", "N3", "N4", "N6", "N8")
NESTED_REPEAT = 3


def same_values(a, b, tol: float = FLOAT_TOL) -> bool:
    """Equal Python values: lists element by element, floats to `tol`."""
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b) and all(same_values(x, y, tol) for x, y in zip(a, b)))
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if np.isnan(a) or np.isnan(b):
            return bool(np.isnan(a) and np.isnan(b))
        return a == b or abs(a - b) <= tol + tol * abs(b)
    return a == b


def same_pydict(got: dict, want: dict, tol: float = FLOAT_TOL) -> bool:
    return list(got) == list(want) and all(same_values(got[k], want[k], tol)
                                           for k in want)


def list_widths(df) -> list:
    """The list width each array_agg / string_agg AggregateExec discovered."""
    out, stack = [], [df.physical_plan()]
    while stack:
        p = stack.pop()
        if isinstance(p, P.AggregateExec) and p._has_array_agg():
            out.append(p._last_width)
        stack.extend(p.children())
    return out


def run_nested_card_vs_cpu() -> None:
    """Every case of testing/nested_cases.py on the card, three collect()s
    of one DataFrame (discovery, the capture, a replay), each equal to the
    CPU (floats to rtol 1e-12, the rest exact) and the steady state a
    captured graph; each rejected query raises the same class on both; each
    family captured once under torch.cuda.set_sync_debug_mode("error"),
    then replayed twice, equal to the CPU."""
    t0 = time.perf_counter()
    card, cpu = SessionContext(), SessionContext(device="cpu")
    for ctx in (card, cpu):
        for name, cols in nested_tables().items():
            ctx.register_table(name, cols)
    for name, sql in sorted(NESTED_CASES.items()):
        want = cpu.sql(sql).to_pydict()
        df = card.sql(sql)
        for i in range(3):
            check(same_pydict(df.to_pydict(), want),
                  f"nested {name}: collect() {i + 1} on the card differs from the CPU")
        check(isinstance(df._fused_query()._fused, FQ._Graph),
              f"nested {name}: no captured graph")
    for name, sql in sorted(NESTED_ERRORS.items()):
        raised = []
        for ctx in (card, cpu):
            try:
                ctx.sql(sql).collect()
                raised.append(None)
            except Exception as e:  # noqa: BLE001 -- compared between devices
                raised.append(type(e).__name__)
        check(raised[0] is not None and raised[0] == raised[1],
              f"nested {name}: the card raises {raised[0]}, the CPU {raised[1]}")
    for family, sql in sorted(NESTED_FAMILIES.items()):
        want = cpu.sql(sql).to_pydict()
        df = card.sql(sql)
        df.collect()
        fq = df._fused_query()
        inputs = tuple(leaf.execute(card.exec_context()) for leaf in fq.leaves)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a sync in warm-up or capture raises
        try:
            graph = FQ._Graph(fq._steady_fn(), inputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for _ in range(2):
            rel, overflow = graph.run()
            check(not overflow, f"nested family {family}: the replay overflowed")
            check(same_pydict(to_host(rel).to_pydict(), want),
                  f"nested family {family}: a replay differs from the CPU")
    emit({"phase": "nested_card_vs_cpu", "cases": len(NESTED_CASES),
          "rejected": len(NESTED_ERRORS), "families_captured": sorted(NESTED_FAMILIES),
          "card_equals_cpu": True, "s": time.perf_counter() - t0})


def _lists(c) -> tuple:
    """(lengths, flattened elements) of a list column of a host Table."""
    rows = c.data
    check(c.validity is None or bool(np.all(c.validity)), "a NULL list")
    lengths = np.fromiter(map(len, rows), dtype=np.int64, count=len(rows))
    try:
        flat = np.fromiter(itertools.chain.from_iterable(rows), dtype=np.int64,
                           count=int(lengths.sum()))
    except TypeError:  # None
        check(False, "a NULL element")
    return lengths, flat


def _by_key(got: Table, key: str):
    """The answer's rows in key order: (keys, {column: HostColumn taken})."""
    keys, _ = _col(got, key)
    order = np.argsort(keys, kind="stable")
    return keys[order], {f.name: c.take(order) for f, c in zip(got.schema.fields, got.columns)}


def _grouped(keys: np.ndarray, *values: np.ndarray):
    """The oracle's groups: (distinct keys, sizes, each values array sorted
    by (key, that array))."""
    gk, sizes = np.unique(keys, return_counts=True)
    return gk, sizes, [v[np.lexsort((v, keys))] for v in values]


def nested_oracle(name: str, tables: dict):
    """What N<name> must return, from the generator's numpy arrays (strings
    as dictionary codes or decoded words): a function of the answer Table
    that checks it."""
    orders, lineitem = tables["orders"], tables["lineitem"]
    ck = _col(orders, "o_custkey")[0].astype(np.int64)
    ok = _col(orders, "o_orderkey")[0].astype(np.int64)

    def same_lists(label, got_c, sizes, flat, words=None, got_words=None):
        lengths, gflat = _lists(got_c)
        if words is not None:
            gflat = np.asarray(got_words, dtype=object)[gflat]
            flat = np.asarray(words, dtype=object)[flat]
        check(np.array_equal(lengths, sizes) and np.array_equal(gflat, flat),
              f"{name}: {label} differs from the oracle")

    if name in ("N1", "N2", "N7", "N8"):
        gk, sizes, (okeys,) = _grouped(ck, ok)

        def same(got: Table):
            keys, cols = _by_key(got, "o_custkey")
            check(np.array_equal(keys, gk), f"{name}: the groups differ")
            if name == "N1":
                same_lists("os", cols["os"], sizes, okeys)
            elif name == "N2":
                tp, _ = _col(orders, "o_totalprice")
                pr, pd_ = _col(orders, "o_orderpriority")
                urgent = np.asarray(pd_.values, dtype=object)[pr] == "1-URGENT"
                order = np.argsort(ck, kind="stable")
                starts = np.r_[0, np.cumsum(sizes)[:-1]]
                check(np.array_equal(np.asarray(cols["n"].data), sizes)
                      and np.array_equal(np.asarray(cols["mx"].data),
                                         np.maximum.reduceat(tp[order], starts))
                      and np.array_equal(np.asarray(cols["urgent"].data),
                                         np.logical_or.reduceat(urgent[order], starts)),
                      f"{name}: n / mx / urgent differ from the oracle")
            elif name == "N7":
                even = ok % 2 == 0
                gke, se = np.unique(ck[even], return_counts=True)
                full = np.zeros(len(gk), np.int64)
                full[np.searchsorted(gk, gke)] = se
                same_lists("ev", cols["ev"], full, ok[even][np.lexsort((ok[even], ck[even]))])
                tp, _ = _col(orders, "o_totalprice")
                scale = 10 ** (got.schema.fields[got.schema.index_of("dbl")].dtype.elem.scale
                               - orders.schema.fields[orders.schema.index_of(
                                   "o_totalprice")].dtype.scale)
                same_lists("dbl", cols["dbl"], sizes,
                           tp[np.lexsort((tp, ck))] * 2 * scale)
            else:  # N8
                pr, pd_ = _col(orders, "o_orderpriority")
                pairs = np.unique(ck * 8 + pr)
                pk, psz = np.unique(pairs // 8, return_counts=True)
                check(np.array_equal(pk, gk), f"{name}: the groups differ")
                same_lists("ps", cols["ps"], psz, pairs % 8, pd_.values,
                           cols["ps"].dictionary.values)
                both = np.intersect1d(np.unique(ck * 16 + ok % 10), np.unique(ck * 16 + ok % 7))
                isz = np.zeros(len(gk), np.int64)
                ik, ic = np.unique(both // 16, return_counts=True)
                isz[np.searchsorted(gk, ik)] = ic
                same_lists("i", cols["i"], isz, both % 16)
        return same
    if name == "N3":
        want = np.sort(ck * (1 << 32) + ok)

        def same(got: Table):
            c = _col(got, "o_custkey")[0].astype(np.int64)
            o = _col(got, "o_orderkey")[0].astype(np.int64)
            check(np.array_equal(np.sort(c * (1 << 32) + o), want),
                  f"{name}: the (o_custkey, o_orderkey) multiset differs")
        return same
    if name == "N4":
        lk, _ = _col(lineitem, "l_orderkey")
        pk, _ = _col(lineitem, "l_partkey")
        qty, _ = _col(lineitem, "l_quantity")
        gk, sizes, (parts, qtys) = _grouped(lk, pk, qty)

        def same(got: Table):
            keys, cols = _by_key(got, "l_orderkey")
            check(np.array_equal(keys, gk), f"{name}: the groups differ")
            same_lists("ps", cols["ps"], sizes, parts)
            same_lists("qs", cols["qs"], sizes, qtys)
        return same
    if name == "N5":
        nk, _ = _col(tables["customer"], "c_nationkey")
        seg, sd = _col(tables["customer"], "c_mktsegment")
        words = np.asarray(sd.values, dtype=object)[seg]
        want = {int(k): ",".join(sorted(words[nk == k])) for k in np.unique(nk)}

        def same(got: Table):
            d = got.to_pydict()
            check(dict(zip(d["c_nationkey"], d["segs"])) == want
                  and len(d["segs"]) == len(want), f"{name}: differs from the oracle")
        return same
    # N6: the word count
    pn, pdict = _col(tables["part"], "p_name")
    names = np.asarray(pdict.values, dtype=object)[pn]
    want = collections.Counter(w for n in names for w in n.split(" "))

    def same(got: Table):
        d = got.to_pydict()
        check(dict(zip(d["w"], d["c"])) == want and len(d["w"]) == len(want),
              f"{name}: the word counts differ from the oracle")
    return same


def check_width_overflow() -> dict:
    """N1's query over a small orders table whose largest group grows in
    place between two collect()s: the steady state's width flag must send
    the query back to discovery, which widens the list."""
    ctx = SessionContext()
    ctx.register_table("ov", {"o_custkey": [1, 1, 2, 3, 3], "o_orderkey": [5, 6, 7, 8, 9]})
    df = ctx.sql(NESTED_TPCH["N1"].replace("from orders", "from ov") + " order by o_custkey")
    want = {"o_custkey": [1, 2, 3], "os": [[5, 6], [7], [8, 9]]}
    check([df.to_pydict() for _ in range(3)] == [want] * 3
          and isinstance(df._fused_query()._fused, FQ._Graph),
          "nested: the width overflow table's steady state")
    before = list_widths(df)
    ctx.catalog.get("ov")._device[str(ctx.device)]["o_custkey"].data[2] = 1
    got = df.to_pydict()
    check(got == {"o_custkey": [1, 3], "os": [[5, 6, 7], [8, 9]]}
          and df._fused_query()._fused is None,
          f"nested: a longer group did not send N1 back to discovery: {got}")
    after = list_widths(df)
    check(after == [4] and before == [2], f"nested: widths {before} -> {after}")
    check([df.to_pydict() for _ in range(2)] == [got] * 2,
          "nested: the steady state after rediscovery")
    return {"width_before": before, "width_after": after, "rediscovered": True}


def run_nested(ctx, tables: dict, repeat: int) -> None:
    """The nested phase: the case table on the card against the CPU, then
    N1-N8 over the TPC-H tables already on the card, each through
    fused_query (discovery, capture and a replay equal to its oracle; a
    captured graph; at most 2 host syncs per warm collect()), with its
    discovered list width; NESTED_TIMED also timed and profiled; then the
    width overflow."""
    t0 = time.perf_counter()
    run_nested_card_vs_cpu()
    for name, sql in sorted(NESTED_TPCH.items()):
        same = nested_oracle(name, tables)
        df = ctx.sql(sql)
        DA.reset_launches()
        t1 = time.perf_counter()
        got = df.collect()
        discovery_ms = (time.perf_counter() - t1) * 1e3
        same(got)
        out = fused_query(ctx, f"nested_{name}", sql, same, repeat,
                          timed=name in NESTED_TIMED,
                          discovered=(df, discovery_ms, DA.launches))
        out.update({"rows": got.num_rows, "list_widths": list_widths(df),
                    "operators": sorted({type(p).__name__ for p in _plan_nodes(df)})})
        emit(out)
    emit({"phase": "nested", "width_overflow": check_width_overflow(),
          "memory_reserved": torch.cuda.memory_reserved(),
          "s": time.perf_counter() - t0})


def _plan_nodes(df) -> list:
    out, stack = [], [df.physical_plan()]
    while stack:
        p = stack.pop()
        out.append(p)
        stack.extend(p.children())
    return out


# ---------------------------------------------------------------------------
# 8b. user-defined functions, the Spark library and the DataFrame API
# ---------------------------------------------------------------------------

UDF_REPEAT = 3
SCAN_TOL = 1e-9  # rtol and atol of floats out of a monoid scan or a sum
SLT_PORTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "slt",
                          "ported")


def udf_sessions():
    """A card and a CPU session over udf_cases' tables, each with the torch
    half of every user function registered."""
    card, cpu = SessionContext(), SessionContext(device="cpu")
    for ctx in (card, cpu):
        for name, cols in UC.tables().items():
            ctx.register_table(name, cols)
        UC.register(ctx)
    return card, cpu


def capture_checked(ctx, df):
    """df's steady state captured under torch.cuda.set_sync_debug_mode(
    "error") (a sync in its warm-up or capture raises): the _Graph. The
    caller holds ctx's function registry active (U.activate)."""
    df.collect()
    fq = df._fused_query()
    inputs = tuple(leaf.execute(ctx.exec_context()) for leaf in fq.leaves)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return FQ._Graph(fq._steady_fn(), inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_udf_card_vs_cpu() -> dict:
    """Every case of testing/udf_cases.py on the card, three collect()s of
    one DataFrame (discovery, the capture, a replay), each equal to the CPU
    (floats to SCAN_TOL); a captured graph, but an eager steady state for
    the host-function cases; each rejected query raises the same class on
    both; each family and the Spark family query captured under
    set_sync_debug_mode("error") and replayed twice, equal to the CPU; the
    syncing UDF refused there."""
    t0 = time.perf_counter()
    card, cpu = udf_sessions()
    steady = {}
    for name, sql in sorted(UC.CASES.items()):
        want = cpu.sql(sql).to_pydict()
        df = card.sql(sql)
        for i in range(3):
            check(same_pydict(df.to_pydict(), want, SCAN_TOL),
                  f"udf {name}: collect() {i + 1} on the card differs from the CPU")
        kind = type(df._fused_query()._fused)
        expect = FQ._Eager if name in UC.HOST_CASES else FQ._Graph
        check(kind is expect, f"udf {name}: the steady state is {kind.__name__}, "
                              f"not {expect.__name__}")
        steady[name] = kind.__name__
    for name, sql in sorted(UC.ERRORS.items()):
        raised = []
        for ctx in (card, cpu):
            try:
                ctx.sql(sql).collect()
                raised.append(None)
            except Exception as e:  # noqa: BLE001 -- compared between devices
                raised.append(type(e).__name__)
        check(raised[0] is not None and raised[0] == raised[1],
              f"udf {name}: the card raises {raised[0]}, the CPU {raised[1]}")
    families = dict(UC.FAMILIES)
    spark_card, spark_cpu = SessionContext(), SessionContext(device="cpu")
    for ctx in (spark_card, spark_cpu):
        ctx.register_table("r", UC.tables()["r"])
        ctx.enable_spark_functions()
    for family, sql in sorted(families.items()) + [("spark", UC.SPARK_FAMILY)]:
        ctx, ref = (spark_card, spark_cpu) if family == "spark" else (card, cpu)
        want = ref.sql(sql).to_pydict()
        with U.activate(ctx.functions):
            graph = capture_checked(ctx, ctx.sql(sql))
            for _ in range(2):
                rel, overflow = graph.run()
                check(not overflow, f"udf family {family}: the replay overflowed")
                check(same_pydict(to_host(rel).to_pydict(), want, SCAN_TOL),
                      f"udf family {family}: a replay differs from the CPU")
    # a UDF that reads a device value on the host cannot be captured
    try:
        with U.activate(card.functions):
            capture_checked(card, card.sql(UC.SYNCING))
        refused = None
    except RuntimeError as e:
        refused = str(e).splitlines()[0][:120]
    check(refused is not None and "synchroniz" in refused,
          f"udf: the syncing UDF was captured ({refused})")
    out = {"phase": "udf_card_vs_cpu", "cases": len(UC.CASES), "steady": steady,
           "rejected": len(UC.ERRORS), "families_captured": sorted(families) + ["spark"],
           "syncing_udf_refused": refused, "card_equals_cpu": True,
           "s": time.perf_counter() - t0}
    emit(out)
    return out


def _slt_outcome(ctx, rec):
    try:
        table = ctx.sql(rec.sql).collect()
    except Exception:  # noqa: BLE001 -- an error is an outcome
        return ("error",)
    if rec.kind == "query":
        return ("rows", tuple(port_slt.format_rows(table, rec.types, rec.sort_mode)))
    return ("ok",)


def run_spark_slt_card_vs_cpu() -> None:
    """All 67 Spark SQL files of the reference's corpus and async_udf.slt,
    record by record through testing/slt.py on a fresh Spark-enabled card
    session and CPU session each: the same outcome for every record (a
    statement succeeds or fails on both, a query fails on both or renders
    the same rows)."""
    t0 = time.perf_counter()
    names = sorted(n for n in os.listdir(SLT_PORTED) if n.startswith("spark__"))
    names.append("async_udf.slt")
    check(len(names) == 68, f"{len(names)} Spark SQL files")
    records = errors = 0
    for name in names:
        with open(os.path.join(SLT_PORTED, name)) as f:
            recs = port_slt.parse_slt(f.read())
        card, cpu = SessionContext(), SessionContext(device="cpu")
        if name.startswith("spark__"):
            card.enable_spark_functions()
            cpu.enable_spark_functions()
        for rec in recs:
            got, want = _slt_outcome(card, rec), _slt_outcome(cpu, rec)
            check(got == want, f"{name}:{rec.line}: the card's outcome {got} differs "
                               f"from the CPU's {want}")
            records += 1
            errors += got == ("error",)
    emit({"phase": "spark_slt_card_vs_cpu", "files": len(names), "records": records,
          "errors_on_both": errors, "card_equals_cpu": True,
          "s": time.perf_counter() - t0})


def _raw(table: Table, name: str) -> np.ndarray:
    return np.asarray(table.column(name).data)


def same_kernel_calls(label: str, calls: list, want: list, timing) -> list:
    """The dense kernel's calls of a query the SQL one stands for (a U
    query, a decoded plan): the same G and route as the SQL query's
    (`want`), each held against the plain version bit for bit, and timed as
    in 5 at a shape not seen before."""
    shapes, iters, flush, baseline, seen = timing

    def routes(cs):
        return [(G, DA.kernel_route(G, len(DA.distinct_pairs(p)[0]))) for _, _, p, G in cs]

    got = routes(calls)
    check(got and got == routes(want),
          f"{label}: kernel calls {got}, the SQL query's {routes(want)}")
    for seg, mask, pairs, G in calls:
        a = DA.dense_groupby_sums(seg, mask, pairs, G)
        b = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{label}: the kernel differs from its plain version (G={G})")
        shape = (int(seg.shape[0]), G, len(pairs))
        if shape not in seen:
            seen.add(shape)
            t = kernel_timing((seg, mask, pairs, G), iters, flush, baseline)
            shapes[f"{label}_G{G}"] = t
            emit({"kernel_timing": KERNEL["name"], "shape": f"{label}_G{G}", **t})
    return [{"G": G, "route": r} for G, r in got]


def udf_oracles(tables: dict) -> dict:
    """numpy / hashlib answers of U3-U6 over the host lineitem."""
    li = tables["lineitem"]
    ok = _raw(li, "l_orderkey").astype(np.int64)
    price = _raw(li, "l_extendedprice")  # cents
    n = len(ok)
    out = {}
    order = np.argsort(ok, kind="stable")
    keys, starts = np.unique(ok[order], return_index=True)
    counts = np.diff(np.append(starts, n))
    logs = np.log(price[order] / 100.0)
    out["U3"] = (keys, np.exp(np.add.reduceat(logs, starts) / counts))
    sk = _raw(li, "l_suppkey")
    ln = _raw(li, "l_linenumber").astype(np.int64)
    order = np.lexsort((ln, ok, _raw(li, "l_shipdate"), sk))
    q = _raw(li, "l_quantity")[order] / 100.0
    cs = np.cumsum(q)
    first = np.r_[True, sk[order][1:] != sk[order][:-1]]
    base = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rows = ok[order] * 8 + ln[order]
    back = np.argsort(rows)
    out["U4"] = (rows[back], (cs - cs[base] + q[base])[back])
    out["U5"] = (2.0 * float(price.sum()) / 100.0, n)
    codes, modes = _raw(li, "l_shipmode"), li.column("l_shipmode").dictionary.values
    pop = (np.bitwise_count(ok.view(np.uint64)) if hasattr(np, "bitwise_count") else
           np.unpackbits(ok.view(np.uint8)).reshape(n, 64).sum(1))
    su = (-ok).view(np.uint64) >> np.uint64(40)
    rounded = (price + 50) // 100 * 100  # HALF_UP to whole units (prices > 0)
    u6 = {}
    for i, m in enumerate(modes):
        sel = codes == i
        x = _xxhash64(str(m).encode())
        u6[hashlib.sha256(str(m).encode()).hexdigest()] = (
            x - (1 << 64) if x >= 1 << 63 else x, int(sel.sum()), int((ok[sel] % 7).sum()),
            int(pop[sel].sum()), int(su[sel].sum()), int(rounded[sel].sum()))
    out["U6"] = u6
    return out


def _same_u3(oracle):
    keys, gm = oracle

    def same(got: Table):
        k, v = _raw(got, "l_orderkey").astype(np.int64), _raw(got, "gm")
        order = np.argsort(k)
        check(np.array_equal(k[order], keys), "U3: the groups differ from the oracle")
        check(np.allclose(v[order], gm, rtol=SCAN_TOL, atol=0),
              "U3: a geometric mean differs from the oracle")
    return same


def _same_u4(oracle):
    rows, rs = oracle

    def same(got: Table):
        key = _raw(got, "l_orderkey").astype(np.int64) * 8 + _raw(got, "l_linenumber")
        order = np.argsort(key)
        check(np.array_equal(key[order], rows), "U4: the rows differ from the oracle")
        check(np.array_equal(_raw(got, "rs")[order], rs),
              "U4: a running sum differs from the oracle (sums of whole numbers: exact)")
    return same


def _same_u6(oracle):
    def same(got: Table):
        d = got.to_pydict()
        ans = {h: (x, n, pm, bc, su, int(r)) for h, x, n, pm, bc, su, r in zip(
            d["h"], d["x"], d["n"], d["pm"], d["bc"], d["su"], _raw(got, "r"))}
        check(ans == oracle, f"U6 differs from the oracle: {ans} != {oracle}")
    return same


def host_query(ctx, label: str, sql: str, same, repeat: int) -> dict:
    """A query calling a host function: three collect()s of one DataFrame
    each held by `same`, whose steady state must run eagerly on the card
    (not a captured graph); its host syncs per warm collect(), eager and
    steady collect() timed in turns, and one profile."""
    df = ctx.sql(sql)
    for _ in range(3):
        same(df.collect())
    fq = df._fused_query()
    check(isinstance(fq._fused, FQ._Eager) and fq._fused is not False,
          f"{label}: the steady state is {type(fq._fused).__name__}, not eager")
    syncs = host_syncs(df.collect)
    turns = {"eager": [], "steady": []}
    for i in range(2 * repeat):
        name = ("eager", "steady", "steady", "eager")[i % 4]
        t0 = time.perf_counter()
        eager_collect(ctx, df) if name == "eager" else df.collect()
        turns[name].append((time.perf_counter() - t0) * 1e3)
    prof = profile_call(f"{label}_steady", df.collect)
    emit(prof)
    return {"host_query": label, "graph": False, "steady": type(fq._fused).__name__,
            "host_syncs": syncs, "collect_ms_in_turns": turns,
            "eager_collect_ms_median": statistics.median(turns["eager"]),
            "steady_collect_ms_median": statistics.median(turns["steady"]),
            "busy_ms": prof["device_busy_ms"], "idle_share": prof["device_idle_share"],
            "matches_oracle": True}


def run_udf(ctx, tables: dict, refs: dict, main_path: dict, sf: float, repeat: int,
            timing) -> int:
    """The udf phase: the case table and the Spark SQL files on the card
    against the CPU, then U1-U6 over the TPC-H tables already on the card
    (a session sharing ctx's providers, with the user functions and the
    Spark library), each against its oracle; returns the dense kernel's
    launches in the discovery runs of U1 and U2."""
    t0 = time.perf_counter()
    run_udf_card_vs_cpu()
    run_spark_slt_card_vs_cpu()
    uctx = SessionContext()
    for name in tables:
        uctx.register_table(name, ctx.catalog.get(name))
    UC.register(uctx)
    uctx.enable_spark_functions()
    oracles = udf_oracles(tables)
    torch.cuda.reset_peak_memory_stats()
    launches, peaks = 0, {}

    def oracle_of(qid):
        def same(got: Table):
            diff = frames_diff(got.to_pandas(), refs[qid], ordered=True)
            check(diff is None, f"udf Q{qid} differs from the pandas oracle: {diff}")
        return same

    for label, qid, make in (("U1", 1, lambda: uctx.sql(UC.U1)),
                             ("U2_q1", 1, lambda: UC.q1_dataframe(uctx, E)),
                             ("U2_q6", 6, lambda: UC.q6_dataframe(uctx, E))):
        sql_answer = uctx.sql(query(qid, sf)).collect().to_pydict()
        same_oracle = oracle_of(qid)

        def same(got: Table, same_oracle=same_oracle, sql_answer=sql_answer, label=label):
            same_oracle(got)
            if label.startswith("U2"):
                check(got.to_pydict() == sql_answer,
                      f"{label}: the built query's answer differs from the SQL query's")

        df = make()
        DA.reset_launches()
        with RecordKernelInputs() as rec:
            t1 = time.perf_counter()
            got = df.collect()
            ms = (time.perf_counter() - t1) * 1e3
        n = DA.launches
        same(got)
        launches += n
        calls = same_kernel_calls(f"udf_{label}", rec.calls, main_path[qid][1], timing)
        torch.cuda.reset_peak_memory_stats()
        out = fused_query(uctx, f"udf_{label}", make, same, repeat,
                          discovered=(df, ms, n))
        out.update({"kernel_calls": calls, "peak_allocated": torch.cuda.max_memory_allocated()})
        peaks[label] = out["peak_allocated"]
        emit(out)
    for label, sql, same in (("U3", UC.U3, _same_u3(oracles["U3"])),
                             ("U3_builtin", UC.U3_BUILTIN, _same_u3(oracles["U3"])),
                             ("U4", UC.U4, _same_u4(oracles["U4"])),
                             ("U6", UC.U6, _same_u6(oracles["U6"]))):
        torch.cuda.reset_peak_memory_stats()
        out = fused_query(uctx, f"udf_{label}", sql, same, repeat)
        out["peak_allocated"] = peaks[label] = torch.cuda.max_memory_allocated()
        emit(out)

    def same_u5(got: Table):
        d = got.to_pydict()
        s, n = oracles["U5"]
        check(d["n"] == [n] and abs(d["s"][0] - s) <= SCAN_TOL * abs(s),
              f"U5 differs from the oracle: {d} != {(s, n)}")

    torch.cuda.reset_peak_memory_stats()
    out = host_query(uctx, "udf_U5", UC.U5, same_u5, repeat)
    price = uctx.catalog.get("lineitem").scan_device(uctx.exec_context()).column(
        "l_extendedprice")
    x = U.udf_input_array(price)
    host = uctx.functions.scalar("twice").fn
    torch.cuda.synchronize()
    ms = []
    for _ in range(repeat):
        t1 = time.perf_counter()
        host(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    out.update({"host_call_ms_median": statistics.median(ms), "host_call_rows": x.shape[0],
                "peak_allocated": torch.cuda.max_memory_allocated()})
    peaks["U5"] = out["peak_allocated"]
    emit(out)
    emit({"phase": "udf", "launches": launches, "s": time.perf_counter() - t0,
          "peak_allocated": max(peaks.values()), "peak_allocated_by_query": peaks,
          "memory_reserved": torch.cuda.memory_reserved()})
    return launches


# ---------------------------------------------------------------------------
# 8c. recursive queries and plan interchange
# ---------------------------------------------------------------------------

INTERCHANGE_REPEAT = 3
CTE_SLT = os.path.join(SLT_PORTED, "cte.slt")
# TPC-H queries that a logical format cannot carry: the producers and
# consumers are verbatim copies of the JAX package's, which refuse subquery
# expressions and lose the aliases of a self-joined table, with the same
# PlanError in both packages (tests/test_torch_interchange.py)
NOT_CARRIED = (2, 4, 7, 8, 11, 15, 16, 17, 18, 20, 21, 22)


def have_protobuf() -> bool:
    """Whether google.protobuf imports: the DataFusion protobuf formats need
    it, Substrait (proto3 JSON) does not."""
    try:
        import google.protobuf  # noqa: F401
    except ImportError:
        return False
    return True


def decode_logical(ctx, df, fmt: str) -> dict:
    """df encoded in `fmt` (to_substrait, then json.dumps, or to_proto) and
    decoded against ctx's catalog (from_substrait / from_proto), then
    planned: {"df": the decoded DataFrame, or None with "refused": the
    codec's PlanError; "encode_ms", "decode_ms", "length": JSON characters
    or protobuf bytes}."""
    from datafusion_tpu_torch.common.errors import PlanError

    try:
        t0 = time.perf_counter()
        payload = json.dumps(df.to_substrait()) if fmt == "substrait" else df.to_proto()
        t1 = time.perf_counter()
        back = ctx.from_substrait(payload) if fmt == "substrait" else ctx.from_proto(payload)
        t2 = time.perf_counter()
        back.physical_plan()  # names bind while planning
    except PlanError as e:
        return {"df": None, "refused": str(e)[:120]}
    return {"df": back, "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
            "length": len(payload)}


def collect_in_turns(frames: dict, repeat: int) -> dict:
    """Host ms of collect() of each DataFrame in `frames` (each already in its
    steady state), in turns: forward, then backward, `repeat` rounds."""
    names = list(frames)
    ms = {name: [] for name in names}
    for r in range(repeat):
        for name in (names if r % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            frames[name].collect()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: {"median": statistics.median(v), "ms": v} for name, v in ms.items()}


def run_logical_interchange(ctx, refs: dict, main_path: dict, sf: float, repeat: int,
                            formats: tuple, timing) -> int:
    """All 22 TPC-H queries through each logical format: encoded, decoded,
    then collected as in 7 (discovery with the kernel's calls recorded, the
    capture and a replay, a replay; a captured graph; at most 2 host syncs
    per warm collect()), each answer equal to the oracle, and the decoded
    fused collect() timed in turns with the SQL query's. Q1 and Q6 must call
    the kernel as the SQL queries do. Returns the kernel's launches in the
    discovery runs."""
    launches = 0
    carried = {fmt: [] for fmt in formats}
    for qid in range(1, 23):
        def same(got, qid=qid):
            diff = frames_diff(got.to_pandas(), refs[qid], ordered=qid in LIMIT_QUERIES)
            check(diff is None, f"decoded TPC-H Q{qid} differs from the oracle: {diff}")

        sql_df = ctx.sql(query(qid, sf))
        frames = {"sql": sql_df}
        row = {"interchange_query": f"q{qid}"}
        for fmt in formats:
            dec = decode_logical(ctx, sql_df, fmt)
            back = dec.pop("df")
            if back is None:
                row[fmt] = {"carried": False, **dec}
                continue
            carried[fmt].append(qid)
            DA.reset_launches()
            with RecordKernelInputs() as rec:
                t0 = time.perf_counter()
                got = back.collect()
                ms = (time.perf_counter() - t0) * 1e3
            n = DA.launches
            same(got)
            launches += n
            label = f"{fmt}_q{qid}"
            calls = (same_kernel_calls(label, rec.calls, main_path[qid][1], timing)
                     if qid in (1, 6) else None)
            out = fused_query(ctx, label, lambda back=back: back, same, repeat,
                              timed=False, discovered=(back, ms, n))
            row[fmt] = {"carried": True, **dec, "host_syncs": out["host_syncs"]["fused"],
                        "discovery_ms": ms, "capture_ms": out["capture_ms"],
                        "dgs_launches": n, "kernel_calls": calls}
            frames[fmt] = back
        sql_df.collect()
        sql_df.collect()  # discovery, then the capture: all in their steady state
        row["fused_collect_ms"] = collect_in_turns(frames, repeat)
        emit(row)
        del frames, sql_df, back
        torch.cuda.empty_cache()
    for fmt in formats:
        missing = tuple(q for q in range(1, 23) if q not in carried[fmt])
        check(missing == NOT_CARRIED,
              f"{fmt}: queries not carried {missing}, expected {NOT_CARRIED}")
    emit({"phase": "logical_interchange", "carried": carried, "launches": launches})
    return launches


def run_physical_interchange(ctx, refs: dict, main_path: dict, sf: float,
                             timing) -> int:
    """All 22 TPC-H physical plans: PhysicalPlanNode bytes and back, executed
    operator by operator and copied to the host, each answer equal to the
    oracle; Q1 and Q6 must call the kernel as the SQL queries do. Returns the
    kernel's launches."""
    from datafusion_tpu_torch.interchange.dfproto_physical import (
        physical_plan_from_proto_bytes, physical_plan_to_proto_bytes)

    launches = 0
    for qid in range(1, 23):
        plan = ctx.sql(query(qid, sf)).physical_plan()
        t0 = time.perf_counter()
        data = physical_plan_to_proto_bytes(plan, ctx.catalog)
        t1 = time.perf_counter()
        back = physical_plan_from_proto_bytes(data, ctx.catalog)
        t2 = time.perf_counter()
        DA.reset_launches()
        with RecordKernelInputs() as rec:
            got = to_host(back.execute(ctx.exec_context()))
        t3 = time.perf_counter()
        n = DA.launches
        launches += n
        diff = frames_diff(got.to_pandas(), refs[qid], ordered=qid in LIMIT_QUERIES)
        check(diff is None, f"physical TPC-H Q{qid} differs from the oracle: {diff}")
        row = {"physical_query": f"q{qid}", "bytes": len(data),
               "encode_ms": (t1 - t0) * 1e3, "decode_ms": (t2 - t1) * 1e3,
               "execute_ms": (t3 - t2) * 1e3, "dgs_launches": n, "matches_oracle": True}
        if qid in (1, 6):
            row["kernel_calls"] = same_kernel_calls(f"physical_q{qid}", rec.calls,
                                                    main_path[qid][1], timing)
        emit(row)
    return launches


def run_cte_slt_card_vs_cpu() -> None:
    """Every record of the reference's cte.slt on a card session and a CPU
    session: the same outcome; and the whole file against its golden rows
    on each, with the same failures (none on the CPU)."""
    t0 = time.perf_counter()
    with open(CTE_SLT) as f:
        recs = port_slt.parse_slt(f.read())
    card, cpu = SessionContext(), SessionContext(device="cpu")
    for rec in recs:
        got, want = _slt_outcome(card, rec), _slt_outcome(cpu, rec)
        check(got == want, f"cte.slt:{rec.line}: the card's outcome {got} differs "
                           f"from the CPU's {want}")
    golden = [[f.line for f in port_slt.run_slt_file(CTE_SLT, ctx=ctx)]
              for ctx in (SessionContext(), SessionContext(device="cpu"))]
    check(golden[0] == golden[1], f"cte.slt: golden failures {golden[0]} on the card, "
                                  f"{golden[1]} on the CPU")
    emit({"phase": "cte_slt_card_vs_cpu", "records": len(recs),
          "golden_failures": golden[0], "card_equals_cpu": True,
          "s": time.perf_counter() - t0})


def run_recursive(nodes: int, seed: int, repeat: int) -> None:
    """R1 and R2 of testing/recursive_cases.py over a `nodes`-node hierarchy
    on the card: three collect()s each equal to the numpy oracle, the
    iteration count, per-operator execution (no steady state), the host
    syncs of one collect() and per iteration, the collect() median of
    `repeat`, one profile and the peak bytes allocated; then the runaway
    recursion must stop at the cap."""
    from datafusion_tpu_torch.common.errors import ExecutionError

    t0 = time.perf_counter()
    edges = RC.hierarchy(nodes, seed)
    oracle = RC.oracle(edges)
    ctx = SessionContext()
    ctx.register_table("edges", edges)
    emit({"hierarchy_nodes": nodes, "seed": seed, "levels": len(oracle["R1"]["n"]),
          "widest_level": max(oracle["R1"]["n"]), "setup_s": time.perf_counter() - t0})
    for name in ("R1", "R2"):
        df = ctx.sql(getattr(RC, name))
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        first = df.collect().to_pydict()
        first_ms = (time.perf_counter() - t1) * 1e3
        for got in (first, df.collect().to_pydict(), df.collect().to_pydict()):
            check(got == oracle[name], f"{name} differs from the numpy oracle")
        check(df._fused_query()._fused is False,
              f"{name}: the recursive plan has a steady state")
        (rq,) = [p for p in _plan_nodes(df) if isinstance(p, P.RecursiveQueryExec)]
        check(rq.iterations == oracle["iterations"],
              f"{name}: {rq.iterations} iterations, the oracle's {oracle['iterations']}")
        syncs = host_syncs(df.collect)
        ms = []
        for _ in range(repeat):
            t1 = time.perf_counter()
            df.collect()
            ms.append((time.perf_counter() - t1) * 1e3)
        prof = profile_call(f"recursive_{name}", df.collect)
        emit(prof)
        emit({"recursive_query": name, "iterations": rq.iterations,
              "first_collect_ms": first_ms, "collect_ms_median": statistics.median(ms),
              "collect_ms": ms, "host_syncs": syncs,
              "host_syncs_per_iteration": syncs / rq.iterations,
              "join_paths": join_paths(df), "busy_ms": prof["device_busy_ms"],
              "idle_share": prof["device_idle_share"], "families": prof["families"],
              "peak_allocated": torch.cuda.max_memory_allocated(),
              "matches_oracle": True})
    try:
        ctx.sql(RC.RUNAWAY).collect()
        capped = None
    except ExecutionError as e:
        capped = str(e)
    check(capped is not None and "exceeded 100 iterations" in capped,
          f"the runaway recursion was not capped: {capped}")
    emit({"runaway": capped})


def run_interchange(ctx, refs: dict, main_path: dict, sf: float, args, timing) -> int:
    """The interchange phase: the logical formats (Substrait always; the
    DataFusion protobuf ones when google.protobuf imports) and the physical
    one over the TPC-H session already on the card, cte.slt card vs CPU, R1
    and R2 over a hierarchy, the runaway cap. Returns the kernel's
    launches in the decoded queries' discovery runs."""
    t0 = time.perf_counter()
    protobuf = have_protobuf()
    if not protobuf:
        emit({"protobuf": "absent: google.protobuf does not import, so only the "
                          "Substrait half of the interchange phase runs"})
    formats = ("substrait", "proto") if protobuf else ("substrait",)
    repeat = min(args.repeat, INTERCHANGE_REPEAT)
    launches = run_logical_interchange(ctx, refs, main_path, sf, repeat, formats, timing)
    if protobuf:
        launches += run_physical_interchange(ctx, refs, main_path, sf, timing)
    run_cte_slt_card_vs_cpu()
    run_recursive(args.rec_nodes, args.seed, repeat)
    emit({"phase": "interchange", "protobuf": protobuf, "launches": launches,
          "elapsed_s": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# 8d. the distributed engine over a mesh of shards on the card
# ---------------------------------------------------------------------------

DIST_SHARDS = 8  # the mesh size of the reference's tests
DIST_REPEAT = 3
DIST_PARTITIONED = (3, 5, 10, 18, 21)  # the reference's partitioned-join list
DIST_SKEW_ROWS = 1 << 22
DIST_HLL_SQL = ("SELECT l_returnflag, approx_distinct(l_partkey) ad FROM lineitem "
                "GROUP BY l_returnflag")
DIST_HLL_TOL = 0.05
DIST_PROFILED = (1, 3)


def dist_mesh(n: int = DIST_SHARDS):
    return make_mesh(n, devices=[torch.device("cuda", 0)] * n)


def dist_answer(dq, ctx):
    """One DistributedQuery.execute() and the host copy of its result."""
    return to_host(dq.execute(ctx.exec_context()))


def dist_query(ctx, label: str, sql: str, ref, ordered: bool, mesh, options,
               repeat: int, timing=None) -> dict:
    """One query through DistributedQuery: discovery and the first walk,
    then warm walks, each answer against the oracle; the warm execute() +
    host copy (median of `repeat`) timed in turns with the single-device
    eager collect(), the host syncs of one execute(), the peak bytes
    allocated in one, and the kernel's launches in one, each call held
    against its plain version bit for bit (and, with `timing`, timed at a
    shape not seen before)."""
    df = ctx.sql(sql)
    dq = DistributedQuery(df.physical_plan(), mesh, options=options)
    t0 = time.perf_counter()
    got = dist_answer(dq, ctx)
    first_s = time.perf_counter() - t0
    diff = frames_diff(got.to_pandas(), ref, ordered=ordered)
    check(diff is None, f"distributed {label} differs from the oracle: {diff}")
    DA.reset_launches()
    with RecordKernelInputs() as rec:
        got = dist_answer(dq, ctx)
    launches = DA.launches
    check(launches == len(rec.calls),
          f"distributed {label}: {len(rec.calls)} calls but {launches} launches")
    diff = frames_diff(got.to_pandas(), ref, ordered=ordered)
    check(diff is None, f"distributed {label} (warm) differs from the oracle: {diff}")
    for seg, mask, pairs, G in rec.calls:
        a = DA.dense_groupby_sums(seg, mask, pairs, G)
        b = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"distributed {label}: the kernel differs from its plain version (G={G})")
    if timing is not None and rec.calls:
        shapes, iters, flush, baseline, seen = timing
        seg, mask, pairs, G = rec.calls[0]
        shape = (int(seg.shape[0]), G, len(pairs))
        if shape not in seen:
            seen.add(shape)
            t = kernel_timing(rec.calls[0], iters, flush, baseline)
            t["launches_per_query"] = launches
            shapes[f"dist_{label}_shard"] = t
            emit({"kernel_timing": KERNEL["name"], "shape": f"dist_{label}_shard", **t})
    turns = {"distributed": [], "single_device_eager": []}
    for i in range(2 * repeat):
        name = ("distributed", "single_device_eager")[(i + i // 2) % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "distributed":
            dist_answer(dq, ctx)
        else:
            eager_collect(ctx, df)
        turns[name].append((time.perf_counter() - t0) * 1e3)
    syncs = host_syncs(lambda: dist_answer(dq, ctx))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dist_answer(dq, ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"dist_query": label, "rows": got.num_rows, "matches_oracle": True,
            "join_modes": dq.join_modes(), "out_dist": dq.out_dist,
            "slot_factor": dq.slot_factor, **dq.trace_stats,
            "first_s": first_s, "kernel_launches": launches,
            "kernel_calls": [{"n": int(s.shape[0]), "G": G,
                              "route": DA.kernel_route(G, len(DA.distinct_pairs(p)[0]))}
                             for s, _, p, G in rec.calls],
            "host_syncs_per_execute": syncs,
            "execute_ms_median": statistics.median(turns["distributed"]),
            "single_device_eager_collect_ms_median":
                statistics.median(turns["single_device_eager"]),
            "ms_in_turns": turns,
            "peak_allocated_bytes": peak, "allocated_before_bytes": base}


def dist_skew(repeat: int) -> dict:
    """A table whose group key is one value in 90% of its rows: the row
    exchange of count(DISTINCT) must overflow its even-split slots, the
    slot factor grow, and the answer equal the single-device one."""
    rng = np.random.default_rng(0)
    n = DIST_SKEW_ROWS
    k = np.where(rng.random(n) < 0.9, 0, rng.integers(1, 1000, n)).astype(np.int64)
    v = rng.integers(0, 5000, n).astype(np.int64)
    ctx = SessionContext()
    ctx.register_table("skew", Table.from_pydict({"k": k, "v": v}))
    sql = "SELECT k, count(DISTINCT v) c, sum(v) s FROM skew GROUP BY k"
    df = ctx.sql(sql)
    ref = df.to_pandas()
    dq = DistributedQuery(df.physical_plan(), dist_mesh())
    t0 = time.perf_counter()
    got = dist_answer(dq, ctx).to_pandas()
    secs = time.perf_counter() - t0
    diff = frames_diff(got, ref, ordered=False)
    check(diff is None, f"distributed skew differs from the single device: {diff}")
    check(dq.slot_factor > 2, f"skew: the slot factor stayed at {dq.slot_factor}")
    walls = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist_answer(dq, ctx)
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"dist_skew": n, "hot_share": 0.9, "groups": len(got),
            "slot_factor": dq.slot_factor, **dq.trace_stats,
            "first_s_with_ladder": secs, "execute_ms_median": statistics.median(walls),
            "matches_single_device": True}


def dist_hll(ctx) -> dict:
    """approx_distinct(l_partkey) per l_returnflag with the HLL sketch on,
    over meshes of 1, 2 and 8 shards: every estimate within DIST_HLL_TOL of
    the exact count, and equal across the meshes; without the option the
    distributed answer is the exact count."""
    exact = DistributedQuery(ctx.sql(DIST_HLL_SQL).physical_plan(), dist_mesh())
    truth = dist_answer(exact, ctx).to_pandas().set_index("l_returnflag")["ad"]
    single = ctx.sql(DIST_HLL_SQL).to_pandas().set_index("l_returnflag")["ad"]
    check(truth.sort_index().equals(single.sort_index()),
          f"approx_distinct without the sketch: {truth.to_dict()} != {single.to_dict()}")
    ests = {}
    for n in (1, 2, DIST_SHARDS):
        dq = DistributedQuery(ctx.sql(DIST_HLL_SQL).physical_plan(), dist_mesh(n),
                              options={"execution.approx_distinct_hll": True})
        ests[n] = dist_answer(dq, ctx).to_pandas().set_index("l_returnflag")["ad"] \
            .sort_index()
    err = ((ests[DIST_SHARDS] - truth.sort_index()).abs() / truth.sort_index()).max()
    check(err <= DIST_HLL_TOL, f"HLL estimates {ests[DIST_SHARDS].to_dict()} are "
                               f"{err:.4f} from the exact {truth.to_dict()}")
    check(all(ests[n].equals(ests[DIST_SHARDS]) for n in ests),
          f"HLL estimates differ between meshes: { {n: e.to_dict() for n, e in ests.items()} }")
    return {"dist_hll": DIST_HLL_SQL, "exact": truth.to_dict(),
            "estimates": ests[DIST_SHARDS].to_dict(), "max_rel_err": float(err),
            "meshes": list(ests)}


def dist_profile(ctx, qid: int, sf: float) -> dict:
    """One profiled warm execute() of distributed `qid`: its top ops by
    device time through utils/xplane, and the share of copies."""
    from torch.profiler import ProfilerActivity

    dq = DistributedQuery(ctx.sql(query(qid, sf)).physical_plan(), dist_mesh())
    step = lambda: dist_answer(dq, ctx)  # noqa: E731
    step()
    for attempt in range(1, 7):  # a profile can lose every device event
        if attempt > 1:
            time.sleep(0.2)
        prof = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA], step, step)
        times = xplane.plane_op_times(prof)
        if times:
            break
    check(bool(times), f"distributed Q{qid} profile: no device events in 6 attempts")
    print(xplane.top_ops(prof, n=12), flush=True)
    total = sum(ms for ms, _ in times.values())
    return {"dist_profile": f"q{qid}", "attempts": attempt, "device_ms": total,
            "copy_ms": xplane.copy_ms(times),
            "copy_share": xplane.copy_ms(times) / total,
            "device_ops": sum(c for _, c in times.values()),
            "dgs_launches": sum(c for k, (_, c) in times.items() if "dgs_" in k)}


def run_distributed(ctx, refs: dict, sf: float, args, timing) -> int:
    """The distributed phase over the TPC-H session already on the card:
    dryrun_multichip on 8 shards of the card, the 22 queries through
    DistributedQuery (and the partitioned-join five again), the skew
    ladder, the HLL sketch, two profiles. Returns the kernel's launches in
    the queries' timed walks."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dryrun_multichip(DIST_SHARDS, devices=[torch.device("cuda", 0)] * DIST_SHARDS)
    emit({"dryrun_multichip": DIST_SHARDS, "s": time.perf_counter() - t0})
    mesh = dist_mesh()
    repeat = min(args.repeat, DIST_REPEAT)
    launches = 0
    for qid in range(1, 23):
        row = dist_query(ctx, f"q{qid}", query(qid, sf), refs[qid],
                         qid in LIMIT_QUERIES, mesh, {}, repeat, timing)
        launches += row["kernel_launches"]
        if qid == 1:
            check(row["kernel_launches"] == DIST_SHARDS,
                  f"distributed Q1 launched dense_groupby_sums "
                  f"{row['kernel_launches']} times, not once per shard")
        emit(row)
    for qid in DIST_PARTITIONED:
        row = dist_query(ctx, f"q{qid}_partitioned", query(qid, sf), refs[qid],
                         qid in LIMIT_QUERIES, mesh, {"join_mode": "partitioned"}, 1)
        check(set(row["join_modes"]) == {"partitioned"},
              f"Q{qid} partitioned: join modes {row['join_modes']}")
        launches += row["kernel_launches"]
        emit(row)
    emit(dist_skew(repeat))
    emit(dist_hll(ctx))
    for qid in DIST_PROFILED:
        emit(dist_profile(ctx, qid, sf))
    emit({"phase": "distributed", "shards": DIST_SHARDS, "launches": launches,
          "s": time.perf_counter() - t_phase,
          "memory_reserved": torch.cuda.memory_reserved()})
    return launches


def run_distributed_only(args) -> int:
    """`--only distributed`: the kernels built, TPC-H at --sf in a session
    on the card, the oracle's answers to the 22 queries, then
    run_distributed."""
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    cuda_build.build_all([DA.SOURCE, BASELINE])
    baseline = baseline_call(cuda_build.load(BASELINE))
    tables = generate_tpch(args.sf, cache=False)
    ctx = SessionContext()
    for name, table in tables.items():
        ctx.register_table(name, table)
    frames = oracle_tables(tables)
    refs = {q: ref_query(q, frames, args.sf) for q in range(1, 23)}
    emit({"setup_s": time.perf_counter() - t0})
    launches = run_distributed(ctx, refs, args.sf, args,
                               ({}, args.iters, L2Flush(torch.device("cuda")),
                                baseline, set()))
    print(card_line(), flush=True)
    emit({"only": "distributed", "launches": launches,
          "total_s": time.perf_counter() - t0})
    return 0


# ---------------------------------------------------------------------------
# 13. file tables and the session's statements
# ---------------------------------------------------------------------------

FILES_REPEAT = 3
# Q1 and Q6 over the CSV table; every query over the Parquet tables
FILES_CSV_QUERIES = (1, 6)
# row groups of the l_shipdate-sorted copy of lineitem
SORTED_ROW_GROUP = 1 << 17
CLI_Q1_GROUPS = ("A F", "N F", "N O", "R F")


class RecordUploads:
    """Host tables uploaded through the catalog's to_device while active
    (every file provider's upload goes through it)."""

    def __enter__(self):
        from datafusion_tpu_torch.catalog import catalog as PC

        self.rows, self._mod, self._orig = [], PC, PC.to_device

        def recording(table, *a, **kw):
            self.rows.append(table.num_rows)
            return self._orig(table, *a, **kw)

        PC.to_device = recording
        return self

    def __exit__(self, *exc):
        self._mod.to_device = self._orig


def file_bytes(location: str) -> int:
    if os.path.isdir(location):
        return sum(os.path.getsize(os.path.join(location, f))
                   for f in os.listdir(location))
    return os.path.getsize(location)


def read_and_upload_ms(provider, device, card: str) -> dict:
    """A whole Parquet table read from its files (8 threads) into a host
    Table, then uploaded to the card column by column, each timed."""
    from datafusion_tpu_torch.data.device import to_device

    ds = provider._ds
    t0 = time.perf_counter()
    at = ds.read_units([(p, list(rgs)) for p, rgs in ds.plan_units([])], None,
                       threads=8)
    host = Table.from_arrow(at)
    read_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rel = to_device(host, device=device)
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(int(t.numel() * t.element_size()) for c in rel.columns
                 for t in (c.data, c.validity) if t is not None)
    del rel
    return {"rows": host.num_rows, "read_ms": read_ms, "upload_ms": upload_ms,
            "device_bytes": nbytes, "card": card}


def files_query(mem, fctx, label: str, sql: str, same, repeat: int,
                card: str, timed: bool = True) -> dict:
    """One query over file tables: sql()+collect() cold (the first scan
    reads and uploads), then fused_query's checks (a captured graph, at most
    2 host syncs per warm collect()) on the same DataFrame; a warm collect()
    must upload nothing and a profiled replay must make no host-to-device
    copy. When `timed`: eager and fused collect() in turns beside the
    in-memory session's, on the same query."""
    DA.reset_launches()
    with RecordUploads() as up:
        t0 = time.perf_counter()
        df = fctx.sql(sql)
        got = df.collect()
        cold_ms = (time.perf_counter() - t0) * 1e3
    same(got)
    launches = DA.launches
    out = fused_query(fctx, label, sql, same, repeat, timed=False,
                      discovered=(df, cold_ms, launches))
    with RecordUploads() as warm:
        df.collect()
    check(not warm.rows, f"{label}: a warm collect() uploaded {warm.rows} rows")
    expect = ("dense_groupby_sums",) if launches else ()
    prof = profile_call(f"{label}_fused", df.collect, expect)
    check(prof["htod_copies"] == 0,
          f"{label}: {prof['htod_copies']} host-to-device copies in a replay")
    out.update({"card": card, "cold_sql_collect_ms": cold_ms,
                "uploads_cold_rows": up.rows, "replay_htod_copies": 0,
                "replay_busy_ms": prof["device_busy_ms"],
                "replay_profile_attempts": prof["attempts"],
                "replay_idle_share": prof["device_idle_share"],
                "dgs_launches_replay": prof["dgs_launches"]})
    if timed:
        mdf = mem.sql(sql)
        for _ in range(3):  # discovery, capture, a replay
            mdf.collect()
        runs = {"files_eager": lambda: eager_collect(fctx, df),
                "files_fused": df.collect,
                "memory_eager": lambda: eager_collect(mem, mdf),
                "memory_fused": mdf.collect}
        names = list(runs)
        turns = {n: [] for n in names}
        for i in range(repeat):
            for n in names[i % 4:] + names[:i % 4]:
                t0 = time.perf_counter()
                runs[n]()
                turns[n].append((time.perf_counter() - t0) * 1e3)
        out["collect_ms_median"] = {n: statistics.median(v) for n, v in turns.items()}
        out["collect_ms_in_turns"] = turns
        del mdf
    del df
    torch.cuda.empty_cache()
    out["memory_reserved_after"] = torch.cuda.memory_reserved()
    return out


def run_files(mem, tables: dict, refs: dict, sf: float, repeat: int, card: str,
              step_done=None, outofcore=None) -> int:
    """The files phase, in a temporary directory removed at the end: TPC-H
    from Parquet (all 22 queries against the oracle), Q1 and Q6 from a
    pipe-delimited `.tbl` with a declared column list, pruning on a copy of
    lineitem sorted by l_shipdate (statistics, bloom filter, TopK), the
    statement cases on the card against the CPU, and the CLI over a SQL
    file. `mem` is the in-memory session of the same tables; `step_done(name)`,
    where given, is called after each step; `outofcore(locs)`, where given,
    runs right after the Parquet queries, over the same files, and returns
    its kernel launches. Returns the dense kernel's launches in the queries'
    discovery runs (and outofcore's)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from datafusion_tpu_torch import cli
    from datafusion_tpu_torch.models.tpch import files as TF
    from datafusion_tpu_torch.testing import statement_cases as SC

    step_done = step_done or (lambda name: None)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    launches = 0
    try:
        # 1. TPC-H from Parquet
        t0 = time.perf_counter()
        locs = TF.write_tpch_parquet(tables, tmp, lineitem_files=8)
        emit({"files_written": "parquet", "s": time.perf_counter() - t0,
              "card": card})
        fctx = SessionContext()
        for name in tables:
            fctx.sql(TF.external_table_sql(name, locs[name]))
        for name in tables:
            emit({"file_table": name, "format": "parquet",
                  "file_bytes": file_bytes(locs[name]),
                  "files": len(os.listdir(locs[name]))
                  if os.path.isdir(locs[name]) else 1,
                  **read_and_upload_ms(fctx.catalog.get(name), fctx.device, card)})
        step_done("parquet_read")
        for qid in range(1, 23):
            def same(got, qid=qid):
                diff = frames_diff(got.to_pandas(), refs[qid],
                                   ordered=qid in LIMIT_QUERIES)
                check(diff is None, f"files Q{qid} differs from the pandas "
                                    f"oracle: {diff}")
            out = files_query(mem, fctx, f"files_parquet_q{qid}", query(qid, sf),
                              same, repeat, card)
            launches += out["dgs_launches_discovery"]
            if qid in (1, 6):
                check(out["dgs_launches_discovery"] > 0,
                      f"Parquet Q{qid} never launched dense_groupby_sums")
            emit(out)
        emit({"phase": "files_parquet", "lineitem_scans_cached":
              len(fctx.catalog.get("lineitem")._device),
              "memory_reserved": torch.cuda.memory_reserved(), "card": card})
        del fctx
        step_done("parquet_queries")
        if outofcore is not None:
            launches += outofcore(locs)
            step_done("outofcore")

        # 2. Q1 and Q6 from pipe-delimited .tbl text
        tbl = os.path.join(tmp, "lineitem.tbl")
        t0 = time.perf_counter()
        TF.write_tbl(tables["lineitem"], tbl)
        emit({"files_written": "tbl", "s": time.perf_counter() - t0,
              "file_bytes": os.path.getsize(tbl), "card": card})
        cctx = SessionContext()
        cctx.sql(TF.external_table_sql("lineitem", tbl, "tbl", tables["lineitem"]))
        prov = cctx.catalog.get("lineitem")
        t0 = time.perf_counter()
        host = prov.host_table()
        read_ms = (time.perf_counter() - t0) * 1e3
        check([repr(f.dtype) for f in host.schema.fields]
              == [repr(f.dtype) for f in tables["lineitem"].schema.fields],
              "the .tbl table's types differ from the generated lineitem's")
        emit({"file_table": "lineitem", "format": "tbl", "rows": host.num_rows,
              "read_ms": read_ms, "card": card})
        for qid in FILES_CSV_QUERIES:
            def same(got, qid=qid):
                diff = frames_diff(got.to_pandas(), refs[qid], ordered=True)
                check(diff is None, f"CSV Q{qid} differs from the pandas "
                                    f"oracle: {diff}")
            out = files_query(mem, cctx, f"files_csv_q{qid}", query(qid, sf), same,
                              repeat, card)
            launches += out["dgs_launches_discovery"]
            check(out["dgs_launches_discovery"] > 0,
                  f"CSV Q{qid} never launched dense_groupby_sums")
            emit(out)
        del cctx, prov, host
        os.remove(tbl)
        step_done("csv")

        # 3. pruning on the card
        sorted_path = os.path.join(tmp, "lineitem_sorted.parquet")
        t0 = time.perf_counter()
        TF.write_sorted_lineitem(tables["lineitem"], sorted_path, SORTED_ROW_GROUP)
        emit({"files_written": "lineitem_sorted", "row_group_rows": SORTED_ROW_GROUP,
              "s": time.perf_counter() - t0,
              "file_bytes": os.path.getsize(sorted_path), "card": card})
        sctx = SessionContext()
        sctx.sql(TF.external_table_sql("lineitem", sorted_path))
        keys = tables["lineitem"].column("l_orderkey").data
        bloom_key = int(keys[len(keys) // 2])  # an order in the middle
        fctx = SessionContext()
        fctx.sql(TF.external_table_sql("lineitem", locs["lineitem"]))
        topk_sql = ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
                    "ORDER BY l_orderkey DESC, l_linenumber LIMIT 10")
        cases = [
            ("q6_sorted", sctx, query(6, sf), "row_groups_pruned"),
            ("bloom_sorted", sctx, "SELECT count(*) AS n, sum(l_quantity) AS q FROM "
             f"lineitem WHERE l_orderkey = {bloom_key}", "row_groups_bloom_pruned"),
            ("topk_sorted", sctx, topk_sql, None),
            ("topk_files", fctx, topk_sql, "row_groups_pruned"),
        ]
        for label, ctx, sql, counter in cases:
            df = ctx.sql(sql)
            t0 = time.perf_counter()
            got = df.to_pydict()
            cold_ms = (time.perf_counter() - t0) * 1e3
            want = mem.sql(sql).to_pydict()
            check(got == want, f"pruning {label}: {got} != the in-memory {want}")
            check(all(len(v) > 0 for v in got.values()), f"pruning {label}: no rows")
            for _ in range(2):
                check(df.to_pydict() == want, f"pruning {label}: a warm answer differs")
            scan = dict(ctx.catalog.get("lineitem").last_scan)
            topk = [f.name() for p in _plan_nodes(df) if isinstance(p, P.ScanExec)
                    for f in p._topk_filters()]
            if counter is not None:
                check(scan[counter] > 0, f"pruning {label}: {counter} is 0: {scan}")
            if label.startswith("topk"):
                check(bool(topk) and " topk" in df.physical_plan().display(),
                      f"pruning {label}: the scan carries no TopK filter")
            emit({"pruning": label, "last_scan": scan, "topk_filters": topk,
                  "rows": len(next(iter(got.values()))), "cold_ms": cold_ms,
                  "steady": type(df._fused_query()._fused).__name__, "card": card})
        del sctx, fctx, df
        step_done("pruning")

        # 4. statements on the card against the CPU, and the CLI
        for sql in SC.STATEMENTS:
            on_card = SC.run(SessionContext(), SC.SETUP + sql)
            on_cpu = SC.run(SessionContext(device="cpu"), SC.SETUP + sql)
            check(on_card == on_cpu, f"statement {sql!r}: card {on_card} != cpu {on_cpu}")
        for fmt, ext, opts in SC.COPY_FORMATS:
            got = [SC.copy_round_trip(ctx, fmt, opts, os.path.join(tmp, f"{i}.{ext}"))
                   for i, ctx in enumerate((SessionContext(),
                                            SessionContext(device="cpu")))]
            check(got[0] == got[1], f"COPY {fmt}: card {got[0]} != cpu {got[1]}")
            check(got[0][0] == {"count": [4]}, f"COPY {fmt}: {got[0][0]}")
        emit({"statements": len(SC.STATEMENTS), "copy_formats":
              [f for f, _, _ in SC.COPY_FORMATS], "card_equals_cpu": True,
              "card": card})
        step_done("statements")
        script = os.path.join(tmp, "q1.sql")
        with open(script, "w") as f:
            f.write(TF.external_table_sql("lineitem", locs["lineitem"]) + ";\n"
                    + query(1, sf))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-f", script])
        text = buf.getvalue()
        check(rc == 0, f"the CLI exited {rc}")
        check(all(re.search(rf"^\s*{g[0]}\s+{g[2]}\s", text, re.M)
                  for g in CLI_Q1_GROUPS) and "4 row(s)" in text,
              f"the CLI did not print Q1's four groups: {text[-2000:]}")
        emit({"cli": "-f q1.sql", "rc": rc, "s": time.perf_counter() - t0,
              "rows_line": text.strip().splitlines()[-1], "card": card})
        step_done("cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # a session and its catalog refer to each other (as do the SQL
    # planner's closures): without a collection, the phase's sessions and
    # their uploaded scans would stay on the card
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "files", "s": time.perf_counter() - t_phase,
          "memory_reserved": torch.cuda.memory_reserved(), "card": card})
    return launches


# ---------------------------------------------------------------------------
# 14. out-of-core execution
# ---------------------------------------------------------------------------

OOC_QUERIES = (1, 3, 4, 5, 6, 10, 12, 13, 18, 19)
# the session's budget and chunk: lineitem's 5,998,378 rows make 6 chunks
OOC_LIMIT = 256 << 20
OOC_CHUNK_ROWS = 1 << 20
# queries whose chunked peak allocation must stay below their resident one
OOC_PEAK_QUERIES = (1, 18)
# the grace join's budget: below its build side's device bytes
OOC_GRACE_LIMIT = 8 << 20
OOC_GRACE_SQL = ("SELECT o_orderpriority, count(*) AS n, sum(l_quantity) AS q "
                 "FROM orders JOIN lineitem ON o_orderkey = l_orderkey "
                 "GROUP BY o_orderpriority ORDER BY o_orderpriority")
OOC_SORT_SQL = ("SELECT l_orderkey, l_linenumber, l_shipdate, l_quantity FROM "
                "lineitem ORDER BY l_shipdate DESC, l_orderkey, l_linenumber")
OOC_STREAM_BATCH = 1 << 16


def ooc_session(mode: str, tables=None, locs=None, limit: int = OOC_LIMIT):
    """A new session (nothing of the earlier phases on the card) with the
    phase's budget and chunk, over the in-memory tables or the Parquet
    files at `locs`."""
    from datafusion_tpu_torch.models.tpch import files as TF

    cfg = {"execution.out_of_core": mode, "execution.chunk_rows": OOC_CHUNK_ROWS}
    if limit:
        cfg["execution.memory_limit_bytes"] = limit
    ctx = SessionContext(config=cfg)
    if locs is not None:
        for name, loc in locs.items():
            ctx.sql(TF.external_table_sql(name, loc))
    else:
        for name, table in tables.items():
            ctx.register_table(name, table)
    return ctx


def measured(step):
    """(step()'s result, wall ms, peak bytes allocated on the card above
    what was allocated when it began)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - base


class CheckKernelCalls:
    """While active, holds every dense_groupby_sums call the engine makes
    against the plain version on the same inputs, bit for bit, as it
    happens (so no chunk's tensors outlive it), and keeps the first call's
    inputs for timing."""

    def __enter__(self):
        self.calls, self.first = 0, None
        self._orig = DA.dense_groupby_sums

        def checking(seg, mask, pairs, G):
            got = self._orig(seg, mask, pairs, G)
            want = DA.dense_groupby_sums_plain(seg, mask, pairs, G)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"chunk call {self.calls} (G={G}, n={seg.shape[0]}): the "
                  f"kernel differs from the plain version")
            if self.first is None:
                self.first = (seg, mask, list(pairs), G)
            self.calls += 1
            return got

        DA.dense_groupby_sums = checking
        return self

    def __exit__(self, *exc):
        DA.dense_groupby_sums = self._orig


class ChunkArrivals:
    """While active, records the bytes allocated on the card (above what
    was allocated when it began) each time a table's scan chunk arrives,
    that chunk included: what the chunked executor still holds of earlier
    chunks shows as growth from one arrival to the next."""

    def __enter__(self):
        from datafusion_tpu_torch.catalog import catalog as C

        gc.collect()
        self.base = torch.cuda.memory_allocated()
        self.held = []
        self._orig = {cls: cls.__dict__["scan_chunks"]
                      for cls in (C.TableProvider, C.ParquetTable)}

        def note(rel):
            self.held.append(torch.cuda.memory_allocated() - self.base)
            return rel

        for cls, orig in self._orig.items():
            # map() holds no chunk while it pulls the next, as the
            # executor's stages do not
            def scan_chunks(prov, *a, _orig=orig, **kw):
                yield from map(note, _orig(prov, *a, **kw))

            cls.scan_chunks = scan_chunks
        return self

    def __exit__(self, *exc):
        for cls, orig in self._orig.items():
            cls.scan_chunks = orig


class PeakWhere:
    """While active, names the chunked executor's step in which the card's
    peak allocation was reached: each wrapped step compares
    max_memory_allocated() at its entry and exit (host reads, no sync), and
    the innermost step whose exit first sees a new maximum claims it.
    `where` is that step for the last maximum, `held_at_entry` the bytes
    allocated (above the start) when it began."""

    def _steps(self):
        from datafusion_tpu_torch.physical import chunked as CQ
        from datafusion_tpu_torch.physical import plan as P

        return [(CQ.SpillableAccumulator, n) for n in ("add", "_merge_held", "fold")] \
            + [(CQ.ChunkedQuery, n) for n in ("_dense_partial", "_sorted_partial",
                                              "_compact", "_partition_to_host")] \
            + [(P.JoinExec, "execute_rels"), (P.AggregateExec, "execute_rel"),
               (P.SortExec, "_transform_full"), (P.FilterExec, "_transform"),
               (P.ProjectionExec, "_transform"), (P.DistinctExec, "_transform")]

    def __enter__(self):
        gc.collect()
        self.base = torch.cuda.memory_allocated()
        self.where, self.held_at_entry, self._claimed = None, None, 0
        self._orig = []
        for owner, name in self._steps():
            raw = inspect.getattr_static(owner, name)
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            label = f"{owner.__name__}.{name}"

            def wrapped(*a, _fn=fn, _label=label, **kw):
                entry = torch.cuda.memory_allocated()
                before = torch.cuda.max_memory_allocated()
                out = _fn(*a, **kw)
                top = torch.cuda.max_memory_allocated()
                if top > before and top > self._claimed:
                    self._claimed = top
                    self.where, self.held_at_entry = _label, entry - self.base
                return out

            setattr(owner, name, staticmethod(wrapped)
                    if isinstance(raw, staticmethod) else wrapped)
            self._orig.append((owner, name, raw))
        return self

    def __exit__(self, *exc):
        for owner, name, raw in self._orig:
            setattr(owner, name, raw)
        if torch.cuda.max_memory_allocated() > self._claimed:
            # reached while no wrapped step ran: a scan chunk's upload
            self.where, self.held_at_entry = "scan_chunks", None


def ooc_query(ctx, label: str, sql: str, same, card: str):
    """One chunked collect() of a new DataFrame, planned first (`plan_ms`),
    then timed (`wall_ms`) and its peak allocation read, launch counts reset
    just before it and read just after, the bytes held at each chunk's
    arrival recorded; the answer (a host Table) checked by same()."""
    df = ctx.sql(sql)
    t0 = time.perf_counter()
    df.physical_plan()  # planned apart: a new session computes its statistics
    plan_ms = (time.perf_counter() - t0) * 1e3
    DA.reset_launches()
    with ChunkArrivals() as arrivals, PeakWhere() as where:
        got, ms, peak = measured(df.collect)
    launches = DA.launches
    cq = getattr(df, "_cq", None)
    check(cq is not None, f"{label}: the query did not take the chunked route")
    same(got)
    return df, {"ooc_query": label, "rows": got.num_rows, "plan_ms": plan_ms,
                "wall_ms": ms,
                "peak_allocated": peak, "limit": OOC_LIMIT,
                "peak_over_limit_plus_chunk": peak / (OOC_LIMIT + cq.chunk_bytes),
                "held_at_chunk_arrival": arrivals.held,
                "peak_reached_in": where.where,
                "held_at_its_entry": where.held_at_entry,
                "chunks": cq.chunks, "chunk_bytes": cq.chunk_bytes,
                "spills": cq.spill_count, "offloads": cq.offloads,
                "grace_partitions": cq.grace_partitions,
                "agg_splits": cq.agg_splits,
                "kernel_launches": launches, "card": card}


def run_outofcore(mem, tables: dict, refs: dict, sf: float, card: str,
                  locs: dict, timing) -> int:
    """The out-of-core phase: fresh sessions with a 256 MiB budget and
    2^20-row chunks over TPC-H; `mem` is the resident session of the same
    tables, `locs` the Parquet files of the files phase, `timing` (shapes,
    iters, flush, baseline) for timing the kernel at the chunk's shape.
    Returns the dense kernel's launches in the measured runs."""
    from datafusion_tpu_torch.common.errors import ResourceExhausted
    from datafusion_tpu_torch.data.device import table_from_numpy
    from datafusion_tpu_torch.physical import chunked as CQ

    t_phase = time.perf_counter()
    launches = 0

    def oracle(qid):
        def same(got):
            diff = frames_diff(got.to_pandas(), refs[qid],
                               ordered=qid in LIMIT_QUERIES)
            check(diff is None, f"chunked Q{qid} differs from the pandas oracle: {diff}")
        return same

    # 1. the ten queries, chunked from memory and from Parquet
    rows = {}
    for source in ("memory", "parquet"):
        ctx = ooc_session("on", tables=tables if source == "memory" else None,
                          locs=locs if source == "parquet" else None)
        for qid in OOC_QUERIES:
            df, row = ooc_query(ctx, f"{source}_q{qid}", query(qid, sf), oracle(qid),
                                card)
            launches += row["kernel_launches"]
            if qid in (1, 6):
                check(row["kernel_launches"] == row["chunks"] > 1,
                      f"chunked {source} Q{qid}: {row['kernel_launches']} kernel "
                      f"launches for {row['chunks']} chunks")
                syncs = host_syncs(df.collect)
                row["host_syncs"] = syncs
                row["host_syncs_per_chunk"] = syncs / row["chunks"]
            rows[(source, qid)] = row
            emit(row)
        del ctx, df
    gc.collect()

    # 2. every chunk call of Q1 bit for bit; the kernel timed at its shape
    ctx = ooc_session("on", tables=tables)
    with CheckKernelCalls() as kc:
        ctx.sql(query(1, sf)).collect()
    check(kc.calls == rows[("memory", 1)]["chunks"],
          f"chunked Q1 checked {kc.calls} kernel calls")
    shapes, iters, flush, baseline = timing
    t = kernel_timing(kc.first, iters, flush, baseline)
    t["launches_per_query"] = kc.calls
    shapes["ooc_q1_chunk"] = t
    emit({"kernel_timing": KERNEL["name"], "shape": "ooc_q1_chunk", **t})
    del kc, ctx
    gc.collect()

    # 3. peak allocation and wall time, chunked against resident
    for qid in OOC_PEAK_QUERIES:
        res = SessionContext()
        for name, table in tables.items():
            res.register_table(name, table)
        got, ms, peak = measured(lambda: res.sql(query(qid, sf)).collect())
        oracle(qid)(got)
        chunked = rows[("memory", qid)]
        emit({"ooc_peak": f"q{qid}", "chunked_peak_allocated": chunked["peak_allocated"],
              "resident_peak_allocated": peak, "chunked_wall_ms": chunked["wall_ms"],
              "resident_first_collect_ms": ms, "limit": OOC_LIMIT,
              "chunk_bytes": chunked["chunk_bytes"], "chunks": chunked["chunks"],
              "card": card})
        check(chunked["peak_allocated"] < peak,
              f"chunked Q{qid} peaked at {chunked['peak_allocated']} bytes, "
              f"resident at {peak}")
        del res
        gc.collect()
        torch.cuda.empty_cache()

    # 4. the route: `auto` streams Q1 under the budget, `off` raises
    ctx = ooc_session("auto", tables=tables)
    df, row = ooc_query(ctx, "auto_q1", query(1, sf), oracle(1), card)
    launches += row["kernel_launches"]
    emit(row)
    ctx = ooc_session("off", tables=tables)
    try:
        ctx.sql(query(1, sf)).collect()
        raised = None
    except ResourceExhausted as e:
        raised = str(e)
    check(raised is not None, "Q1 under the budget with out_of_core=off did not "
                              "raise ResourceExhausted")
    emit({"ooc_route": "off_q1", "raised": "ResourceExhausted",
          "message": raised[:200], "card": card})
    del ctx, df
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the external sort: sorted runs to the host, one merge there
    ctx = ooc_session("on", tables=tables)
    li = tables["lineitem"]
    cols = {n: np.asarray(li.column(n).data) for n in
            ("l_orderkey", "l_linenumber", "l_shipdate", "l_quantity")}
    want = np.lexsort((cols["l_linenumber"], cols["l_orderkey"],
                       -cols["l_shipdate"].astype(np.int64)))

    def sorted_same(got):
        for n, c in cols.items():
            check(np.array_equal(np.asarray(got.column(n).data), c[want]),
                  f"external sort: column {n} differs from numpy's lexsort")

    df, row = ooc_query(ctx, "external_sort", OOC_SORT_SQL, sorted_same, card)
    check(row["offloads"] >= 1 and row["offloads"] == row["chunks"],
          f"external sort: {row['offloads']} runs moved to the host for "
          f"{row['chunks']} chunks")
    emit(row)
    del ctx, df
    gc.collect()

    # 6. the grace join: a build side over the budget
    graces = []
    orig = CQ.ChunkedQuery._grace_join

    def spy(self, *a, **kw):
        graces.append(1)
        return orig(self, *a, **kw)

    CQ.ChunkedQuery._grace_join = spy
    try:
        ctx = ooc_session("on", tables=tables, limit=OOC_GRACE_LIMIT)
        resident = mem.sql(OOC_GRACE_SQL).to_pandas()

        def grace_same(got):
            diff = frames_diff(got.to_pandas(), resident, ordered=True)
            check(diff is None, f"the grace join differs from the resident "
                                f"answer: {diff}")

        df, row = ooc_query(ctx, "grace_join", OOC_GRACE_SQL, grace_same, card)
    finally:
        CQ.ChunkedQuery._grace_join = orig
    check(bool(graces) and row["grace_partitions"] > 0,
          f"orders x lineitem under {OOC_GRACE_LIMIT} bytes took no grace join")
    row["limit"] = OOC_GRACE_LIMIT
    row["peak_over_limit_plus_chunk"] = row["peak_allocated"] / (
        OOC_GRACE_LIMIT + row["chunk_bytes"])
    launches += row["kernel_launches"]
    emit(row)
    del ctx, df
    gc.collect()

    # 7. streams: LIMIT over endless batches stops early; execute_stream
    pulled = []

    def endless():
        for i in itertools.count():
            pulled.append(i)
            k = np.arange(i * OOC_STREAM_BATCH, (i + 1) * OOC_STREAM_BATCH,
                          dtype=np.int64)
            yield table_from_numpy([("k", T.INT64), ("v", T.INT64)], [k, k % 97])

    ctx = SessionContext()
    ctx.register_streaming_table("s", endless, {"k": T.INT64, "v": T.INT64},
                                 unbounded=True)
    got, ms, _ = measured(
        lambda: ctx.sql("SELECT k FROM s WHERE k % 1000 = 7 LIMIT 50").to_pydict())
    check(got == {"k": [1000 * i + 7 for i in range(50)]},
          f"the stream's LIMIT answered {got}")
    need = -(-(1000 * 49 + 8) // OOC_STREAM_BATCH)  # batches up to the 50th row
    check(len(pulled) == need, f"the stream's LIMIT pulled {len(pulled)} batches "
                               f"for the {need} it needs")
    ctx = ooc_session("on", tables=tables)
    df = ctx.sql("SELECT l_orderkey, l_linenumber FROM lineitem WHERE l_quantity < 5")
    parts = list(df.execute_stream())
    whole = mem.sql("SELECT l_orderkey, l_linenumber FROM lineitem "
                    "WHERE l_quantity < 5").collect()

    def keyed(ok, ln):
        ok, ln = np.asarray(ok), np.asarray(ln)
        o = np.lexsort((ln, ok))
        return ok[o], ln[o]

    streamed = keyed(np.concatenate([t.column("l_orderkey").data for t in parts]),
                     np.concatenate([t.column("l_linenumber").data for t in parts]))
    full = keyed(whole.column("l_orderkey").data, whole.column("l_linenumber").data)
    check(len(parts) > 1 and all(np.array_equal(a, b) for a, b in zip(streamed, full)),
          f"execute_stream's {len(parts)} tables differ from collect()")
    emit({"ooc_stream": "limit_over_endless_batches", "batches_pulled": len(pulled),
          "wall_ms": ms, "execute_stream_tables": len(parts),
          "execute_stream_rows": int(sum(t.num_rows for t in parts)), "card": card})
    del ctx, df, parts
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the budget bounds the card (checked last, so that a failure here
    # still shows every other step): every query's peak within the budget
    # plus one chunk, and no earlier chunk held when Q1's next one arrives
    for (source, qid), row in rows.items():
        check(row["peak_allocated"] <= OOC_LIMIT + row["chunk_bytes"],
              f"chunked {source} Q{qid} peaked at {row['peak_allocated']} bytes, "
              f"above the budget {OOC_LIMIT} plus a chunk of {row['chunk_bytes']}")
    q1 = rows[("memory", 1)]
    check(max(q1["held_at_chunk_arrival"]) < 2 * q1["chunk_bytes"],
          f"chunked Q1 held {q1['held_at_chunk_arrival']} bytes as its chunks "
          f"of {q1['chunk_bytes']} arrived: an earlier chunk stays on the card")
    emit({"phase": "outofcore", "s": time.perf_counter() - t_phase,
          "memory_reserved": torch.cuda.memory_reserved(), "card": card})
    return launches


def run_outofcore_only(args) -> int:
    """`--only outofcore`: the kernels built, TPC-H at --sf in a resident
    session, the oracle's answers to the phase's queries and the tables as
    Parquet in a temporary directory (as the full run has them when phase
    14 starts), then run_outofcore."""
    import shutil
    import tempfile

    from datafusion_tpu_torch.models.tpch import files as TF

    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    cuda_build.build_all([DA.SOURCE, BASELINE])
    baseline = baseline_call(cuda_build.load(BASELINE))
    tables = generate_tpch(args.sf, cache=False)
    mem = SessionContext()
    for name, table in tables.items():
        mem.register_table(name, table)
    frames = oracle_tables(tables)
    refs = {q: ref_query(q, frames, args.sf) for q in OOC_QUERIES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_outofcore_")
    try:
        locs = TF.write_tpch_parquet(tables, tmp, lineitem_files=8)
        emit({"setup_s": time.perf_counter() - t0})
        launches = run_outofcore(
            mem, tables, refs, args.sf, card, locs,
            ({}, args.iters, L2Flush(torch.device("cuda")), baseline))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"only": "outofcore", "launches": launches,
          "total_s": time.perf_counter() - t0})
    return 0


def run_udf_only(args) -> int:
    """`--only udf`: the kernels built, TPC-H at --sf in a session on the
    card, Q1 and Q6 through the main path (run_main_path: their kernel
    calls, which U1 and U2 must repeat) and their oracle answers, then
    run_udf."""
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    cuda_build.build_all([DA.SOURCE, BASELINE])
    baseline = baseline_call(cuda_build.load(BASELINE))
    tables = generate_tpch(args.sf, cache=False)
    ctx = SessionContext()
    for name, table in tables.items():
        ctx.register_table(name, table)
    frames = oracle_tables(tables)
    main_path = run_main_path(ctx, frames, args.sf)
    refs = {q: ref_query(q, frames, args.sf) for q in (1, 6)}
    emit({"setup_s": time.perf_counter() - t0})
    launches = run_udf(ctx, tables, refs, main_path, args.sf,
                       min(args.repeat, UDF_REPEAT),
                       ({}, args.iters, L2Flush(torch.device("cuda")), baseline, set()))
    print(card_line(), flush=True)
    emit({"only": "udf", "launches": launches, "total_s": time.perf_counter() - t0})
    return 0


def run_interchange_only(args) -> int:
    """`--only interchange`: the kernels built, TPC-H at --sf in a session on
    the card, Q1 and Q6 through the main path (run_main_path: their kernel
    calls, which the decoded Q1 and Q6 must repeat) and the oracle's answers
    to the 22 queries, then run_interchange."""
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    cuda_build.build_all([DA.SOURCE, BASELINE])
    baseline = baseline_call(cuda_build.load(BASELINE))
    tables = generate_tpch(args.sf, cache=False)
    ctx = SessionContext()
    for name, table in tables.items():
        ctx.register_table(name, table)
    frames = oracle_tables(tables)
    main_path = run_main_path(ctx, frames, args.sf)
    refs = {q: ref_query(q, frames, args.sf) for q in range(1, 23)}
    emit({"setup_s": time.perf_counter() - t0})
    launches = run_interchange(ctx, refs, main_path, args.sf, args,
                               ({}, args.iters, L2Flush(torch.device("cuda")), baseline,
                                set()))
    print(card_line(), flush=True)
    emit({"only": "interchange", "launches": launches,
          "total_s": time.perf_counter() - t0})
    return 0


def generate_table(kind: str, rows: int):
    """(the h2o groupby table or the ClickBench hits table of `rows` rows,
    the seconds it took), in a worker process."""
    t0 = time.perf_counter()
    if kind == "h2o":
        table = generate_groupby(rows, k=H2O_K, seed=42)
    else:
        table = generate_hits(rows)
    return table, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor")
    ap.add_argument("--h2o-rows", type=int, default=10_000_000,
                    help="rows of the h2o groupby table (K = 100)")
    ap.add_argument("--tpcds-sf", type=float, default=24.0,
                    help="TPC-DS generator scale (24: store_sales 2,880,000 rows)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="warm end-to-end runs per query")
    ap.add_argument("--clickbench-rows", type=int, default=10_000_000,
                    help="rows of the synthetic ClickBench hits table")
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per kernel timing, each after an "
                         "L2 flush (the median is reported)")
    ap.add_argument("--rec-nodes", type=int, default=1 << 20,
                    help="nodes of the hierarchy the recursive queries walk")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the hierarchy the recursive queries walk")
    ap.add_argument("--only", choices=("outofcore", "udf", "interchange", "distributed"),
                    help="run the kernels' build and this phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card", file=sys.stderr)
        return 2
    if args.only == "outofcore":
        return run_outofcore_only(args)
    if args.only == "udf":
        return run_udf_only(args)
    if args.only == "interchange":
        return run_interchange_only(args)
    if args.only == "distributed":
        return run_distributed_only(args)
    # the h2o and ClickBench tables take minutes of host time to generate:
    # two worker processes make them while the earlier phases run
    workers = multiprocessing.get_context("spawn").Pool(2)
    try:
        generated = {
            "h2o": workers.apply_async(generate_table, ("h2o", args.h2o_rows)),
            "hits": workers.apply_async(generate_table,
                                        ("hits", args.clickbench_rows))}
        return run(args, generated)
    finally:
        workers.terminate()
        workers.join()


def run(args, generated: dict) -> int:
    """Every phase, in the order of the module's docstring; `generated`
    holds the h2o and hits tables being made by generate_table."""
    dev = torch.device("cuda")
    t_run = time.perf_counter()

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
    frames = oracle_tables(tables)
    emit({"datagen_s": time.perf_counter() - t0,
          "rows": {name: t.num_rows for name, t in tables.items()}})

    main_path = run_main_path(ctx, frames, args.sf)
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
        df = ctx.sql(query(qid, args.sf))
        df.collect()
        df.collect()  # capture the steady state before the profiler starts
        emit(profile_call(f"q{qid}", df.collect, expect=("dense_groupby_sums",)))

    tpch, refs = run_tpch22(ctx, frames, args.sf)
    launches += sum(n for n, _ in tpch.values())
    seen = {(int(c[0].shape[0]), c[3], len(c[2])) for _, calls in main_path.values()
            for c in calls}
    for qid, (n, calls) in tpch.items():
        for call in calls:
            shape = (int(call[0].shape[0]), call[3], len(call[2]))
            if shape in seen:
                continue
            seen.add(shape)
            t = kernel_timing(call, args.iters, flush, baseline)
            t["launches_per_query"] = n
            label = f"tpch_q{qid}_G{call[3]}"
            shapes[label] = t
            emit({"kernel_timing": KERNEL["name"], "shape": label, **t})

    run_fused_tpch(ctx, args.sf, refs, args.repeat)
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "tpch"})
    run_nested(ctx, tables, min(args.repeat, NESTED_REPEAT))
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "nested"})
    launches += run_udf(ctx, tables, refs, main_path, args.sf,
                        min(args.repeat, UDF_REPEAT),
                        (shapes, args.iters, flush, baseline, seen))
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "udf"})
    launches += run_interchange(ctx, refs, main_path, args.sf, args,
                                (shapes, args.iters, flush, baseline, seen))
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "interchange"})
    launches += run_distributed(ctx, refs, args.sf, args,
                                (shapes, args.iters, flush, baseline, seen))
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "distributed"})

    check_segment_extremes(dev)
    t0 = time.perf_counter()
    h2o, gen_s = generated["h2o"].get()
    wait_s = time.perf_counter() - t0
    ctx.register_table("x", h2o)
    frame = h2o_frame(h2o)
    emit({"h2o_datagen_s": gen_s, "datagen_wait_s": wait_s,
          "rows": h2o.num_rows, "k": H2O_K,
          "distinct": {f.name: len(c.dictionary.values)
                       for f, c in zip(h2o.schema.fields, h2o.columns)
                       if c.dictionary is not None}})
    h2o_path, h2o_refs = run_h2o(ctx, h2o, frame)
    launches += sum(n for n, _ in h2o_path.values())
    for qid, (n, calls) in h2o_path.items():
        for call in calls:
            t = kernel_timing(call, args.iters, flush, baseline)
            t["launches_per_query"] = n
            shapes[f"h2o_q{qid}"] = t
            emit({"kernel_timing": KERNEL["name"], "shape": f"h2o_q{qid}", **t})
    for qid in H2O_QUERIES:
        def same(got, qid=qid):
            h2o_compare(qid, got, h2o_refs[qid], h2o)
        emit(fused_query(ctx, f"h2o_q{qid}", GROUPBY_QUERIES[qid - 1], same,
                         args.repeat))
    emit({"phase": "fused_h2o", "memory_reserved": torch.cuda.memory_reserved()})
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "h2o"})

    run_tpcds_card_vs_cpu(TPCDS_CHECK_SF)
    launches += run_tpcds(args.tpcds_sf, min(args.repeat, TPCDS_REPEAT), shapes,
                          seen, args.iters, flush, baseline)
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "tpcds"})

    run_functions()
    run_clickbench_check(CLICKBENCH_CHECK_ROWS)
    launches += run_clickbench(args.clickbench_rows, generated["hits"],
                               min(args.repeat, CLICKBENCH_REPEAT),
                               shapes, seen, args.iters, flush, baseline)
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "clickbench"})
    launches += run_files(
        ctx, tables, refs, args.sf, min(args.repeat, FILES_REPEAT), card,
        outofcore=lambda locs: run_outofcore(ctx, tables, refs, args.sf, card, locs,
                                             (shapes, args.iters, flush, baseline)))
    emit({"elapsed_s": time.perf_counter() - t_run, "after": "files"})

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
