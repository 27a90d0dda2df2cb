"""Chunked (morsel-driven) out-of-core execution.

Port of datafusion_tpu/physical/chunked.py (reference: the spill-driven
streaming operators, ExternalSorter sorts/sort.rs:110-202, the grouped
aggregation spill in aggregates/grouped_hash_stream.rs:1167, and the memory
pool's back pressure). The scan is cut into capacity-bounded device chunks
that flow one at a time through the same per-operator transforms the
resident engine uses; each pipeline breaker says how its partial results
merge across chunks:

  Filter/Projection/Alias  per chunk (all chunks share one capacity; a
                           table's chunks also share one dictionary per
                           string column and one bounds tuple per column --
                           see TableProvider.scan_chunks -- a stream's do
                           not)
  Aggregate (decomposable) per-chunk Partial states (parallel/aggsplit.py)
                           and a running merge (by key partitions when its
                           working set would pass the budget); dense
                           small-domain keys (of
                           inputs with shared chunk metadata) merge
                           elementwise with no sort, and their exact integer
                           SUM and COUNT states come from the dense
                           aggregation kernel (ops/dense_agg.py) wherever the
                           resident dense aggregate would launch it
  Sort + fetch (TopK)      running top-k: sort the chunk, keep k, re-sort 2k
  Sort (full, at the top)  external sort: each chunk sorted on the device,
                           then moved to host memory as a sorted run; one
                           k-way merge on the host orders the runs
  Join                     build side materialized once (CollectLeft, with
                           its key bounds pushed into the probe's scan; a
                           direct-address table, which the key domain
                           sizes, only within a sixteenth of the budget);
                           probe side streamed; INNER stream x stream joins
                           run symmetrically; a build side over the budget
                           takes a grace hash join (both sides partitioned
                           by key hash on the host, joined bucket by bucket)
  Distinct                 per-chunk distinct, then concat + re-distinct
                           (at the top: a host merge of the sorted runs)
  Limit                    streamed with a running offset; stops early
  anything else            materialized (spilling under pressure) or run
                           resident

Memory pressure: every device relation an operator accumulates is reserved
against the ExecContext memory pool; when the headroom runs out the
accumulator first merges what it holds, then spills it to the host through
the SpillManager (runtime/spill.py). No stage holds a chunk while it pulls
the next one, so the card holds one chunk of a scan (with what is computed
from it) besides what the operators accumulate. Chunks run eagerly, operator by
operator; the reference's per-chunk jit cache is a plain cache of
per-chunk callables here, and every chunk of a scan has one capacity, so a
per-chunk pipeline could later be captured as one graph.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import ExecutionError, PlanError, ResourceExhausted
from ..common.schema import Field, Schema
from ..data.column import Dictionary, HostColumn
from ..data.device import (DeviceColumn, DeviceRelation, bucket_capacity,
                           empty_relation, resolve_device, to_device, to_host)
from ..data.table import Table
from ..expr import nodes as E
from ..logical.plan import JoinType
from ..ops import groupby as G
from ..ops import kernels as K
from ..parallel import aggsplit as AS
from ..runtime.memory import relation_bytes
from . import plan as P
from .expr_compiler import eval_expr
from .planner import AliasExec
from .window import WindowExec

# ---------------------------------------------------------------------------
# host-side helpers: exact sort keys, cheap chunk concat
# ---------------------------------------------------------------------------

_SIGN64 = np.uint64(0x8000000000000000)


def _monotone_i64(data: np.ndarray, validity: Optional[np.ndarray]) -> np.ndarray:
    """Map a device-representation array to int64 keys whose ascending order
    equals the value order EXACTLY (the IEEE-754 total-order trick for
    floats; no float64 round trip for int64, so decimals keep every
    digit)."""
    x = np.ascontiguousarray(data)
    if x.dtype == np.bool_:
        k = x.astype(np.int64)
    elif np.issubdtype(x.dtype, np.floating):
        u = x.astype(np.float64).view(np.uint64)
        mask = np.where(u >> np.uint64(63), np.uint64(0xFFFFFFFFFFFFFFFF), _SIGN64)
        k = ((u ^ mask) ^ _SIGN64).view(np.int64)
    else:
        k = x.astype(np.int64)
    if validity is not None:
        k = np.where(validity, k, np.int64(0))
    return k


def host_sort_indices(keys: Sequence[Tuple[np.ndarray, Optional[np.ndarray],
                                           bool, bool]]) -> np.ndarray:
    """Stable multi-key argsort on the host. keys: (data, validity_or_None,
    descending, nulls_first)."""
    seq: List[np.ndarray] = []
    for data, validity, desc, nulls_first in reversed(list(keys)):
        k = _monotone_i64(data, validity)
        if desc:
            k = ~k
        valid = (np.ones(len(k), dtype=bool) if validity is None
                 else np.asarray(validity))
        rank = valid.astype(np.int64) if nulls_first else (~valid).astype(np.int64)
        seq.append(k)
        seq.append(rank)  # more significant than the key itself
    return np.lexsort(seq)


def pack_key_rows(keys: Sequence[Tuple[np.ndarray, Optional[np.ndarray],
                                       bool, bool]]) -> np.ndarray:
    """Rows -> one composite key per row whose ascending order equals the
    multi-key sort order: per key a validity-rank bit above a monotone int64.
    When the keys' value ranges fit 63 bits together the fields are packed
    into one int64 (numpy searches int64 arrays in machine code); otherwise
    they form a structured array, which numpy compares and searches field by
    field (about 100x slower at millions of rows)."""
    n = len(keys[0][0])
    fields = []
    for data, validity, desc, nulls_first in keys:
        k = _monotone_i64(data, validity)
        if desc:
            k = ~k
        valid = (np.ones(n, dtype=bool) if validity is None
                 else np.asarray(validity))
        fields.append(((valid if nulls_first else ~valid).astype(np.uint8), k))
    packed = _pack_int64(fields, n)
    if packed is not None:
        return packed
    dt, cols = [], []
    for i, (rank, k) in enumerate(fields):
        dt += [(f"r{i}", np.uint8), (f"k{i}", np.int64)]
        cols += [rank, k]
    out = np.empty(n, dtype=np.dtype(dt))
    for (name, _), c in zip(dt, cols):
        out[name] = c
    return out


def _pack_int64(fields, n: int) -> Optional[np.ndarray]:
    """The (rank, key) fields packed most significant first into one int64
    (each key rebased to its minimum), or None when they need more than 63
    bits."""
    spans, total = [], 0
    for rank, k in fields:
        lo = int(k.min()) if n else 0
        width = (int(k.max()) - lo).bit_length() if n else 0
        total += width + (1 if rank.any() else 0)
        spans.append((lo, width, bool(rank.any())))
    if total > 63:
        return None
    acc = np.zeros(n, dtype=np.int64)
    for (rank, k), (lo, width, has_rank) in zip(fields, spans):
        if has_rank:
            acc = (acc << 1) | rank.astype(np.int64)
        acc = (acc << width) | (k - lo)
    return acc


def merge_run_indices(packed: np.ndarray,
                      run_lengths: Sequence[int]) -> np.ndarray:
    """Stable k-way merge of presorted runs laid out one after another in
    `packed`: the indices giving the global ascending order. A pairwise
    searchsorted merge tree, O(n log r) vectorized passes instead of an
    O(n log n) re-sort (reference: the loser-tree streaming merge,
    physical-plan/src/sorts/merge.rs:54-97)."""
    items = []
    off = 0
    for ln in run_lengths:
        if ln:
            items.append((packed[off:off + ln],
                          np.arange(off, off + ln, dtype=np.int64)))
        off += ln
    if not items:
        return np.empty(0, dtype=np.int64)
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            k1, i1 = items[i]
            k2, i2 = items[i + 1]
            # rows of the first run win ties (stability across runs)
            p1 = np.arange(len(k1)) + np.searchsorted(k2, k1, side="left")
            p2 = np.arange(len(k2)) + np.searchsorted(k1, k2, side="right")
            mk = np.empty(len(k1) + len(k2), dtype=k1.dtype)
            mi = np.empty(len(k1) + len(k2), dtype=np.int64)
            mk[p1] = k1
            mk[p2] = k2
            mi[p1] = i1
            mi[p2] = i2
            nxt.append((mk, mi))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0][1]


def concat_host(tables: List[Table], schema: Schema) -> Table:
    """Concatenate host chunk tables sharing a schema. String columns whose
    chunks carry different dictionaries are remapped onto one merged sorted
    dictionary (codes stay order-preserving)."""
    tables = [t for t in tables if t.num_rows] or tables[:1]
    if not tables:
        return Table(schema, [HostColumn(f.dtype, np.zeros(0, f.dtype.np_dtype()))
                              for f in schema.fields])
    if len(tables) == 1:
        return Table(schema, tables[0].columns)
    cols = []
    for i, f in enumerate(schema.fields):
        chunk_cols = [t.columns[i] for t in tables]
        if f.dtype.is_string:
            dicts = {id(c.dictionary) for c in chunk_cols}
            if len(dicts) > 1:
                vals = sorted(set().union(*(
                    set(c.dictionary.values.astype(str))
                    for c in chunk_cols if c.dictionary is not None)))
                shared = Dictionary(np.array(vals, dtype=object))
                chunk_cols = [c.remap_dictionary(shared) for c in chunk_cols]
        data = np.concatenate([c.data for c in chunk_cols])
        validity = None
        if any(c.validity is not None for c in chunk_cols):
            validity = np.concatenate([c.valid_mask() for c in chunk_cols])
        cols.append(HostColumn(f.dtype, data, validity, chunk_cols[0].dictionary))
    return Table(schema, cols)


def _concat(rels: List[DeviceRelation], schema: Schema) -> DeviceRelation:
    """P.concat_relations, keeping each column's bounds when every part has
    them (their union): the dense aggregate's decision, made on a chunk,
    rests on them."""
    out = P.concat_relations(rels, schema)
    cols = []
    for i, c in enumerate(out.columns):
        bs = [r.columns[i].bounds for r in rels]
        if c.bounds is None and bs and all(b is not None for b in bs) \
                and c.data.ndim == 1:
            c = DeviceColumn(c.data, c.validity, c.dtype, c.dictionary,
                             (min(b[0] for b in bs), max(b[1] for b in bs)),
                             c.lengths, c.elem_valid, c.meta)
        cols.append(c)
    return DeviceRelation(schema, tuple(cols), out.sel)


def _rows(rel: DeviceRelation, start: int, stop: int) -> DeviceRelation:
    """Slots [start, stop) of every tensor of the relation (views)."""
    cols = [P._with_leaves(c, {k: v[start:stop]
                               for k, v in P._column_leaves(c).items()})
            for c in rel.columns]
    return DeviceRelation(rel.schema, tuple(cols), rel.sel[start:stop])


# ---------------------------------------------------------------------------
# spill-aware accumulation
# ---------------------------------------------------------------------------


class SpillableAccumulator:
    """Holds device relations under memory-pool accounting. Under pressure it
    first merges what it holds (when given a merge_fn: partial aggregation
    states, distinct runs), then spills to host memory or disk through the
    context's SpillManager (reference: MemoryReservation back pressure
    driving ExternalSorter::spill, sorts/sort.rs:210). A merge_fn may empty
    the list it is given once it has read it: nothing else holds the runs
    then, so they leave the card before the merge's own working set
    peaks."""

    _seq = 0

    def __init__(self, ctx, consumer: str,
                 merge_fn: Optional[Callable[[List[DeviceRelation]], DeviceRelation]] = None,
                 merge_width: int = 8):
        self.ctx = ctx
        SpillableAccumulator._seq += 1
        self.consumer = f"{consumer}#{SpillableAccumulator._seq}"
        self.merge_fn = merge_fn
        self.merge_width = merge_width
        self.held: List[DeviceRelation] = []
        self.spilled: List = []
        # a FairSpillPool divides its budget among registered spillable
        # consumers; other pools have no register()
        reg = getattr(ctx.memory_pool, "register", None)
        if reg is not None:
            reg(self.consumer, True)

    # -- accounting ------------------------------------------------------
    def _grow(self, nbytes: int):
        self.ctx.memory_pool.try_grow(self.consumer, nbytes)

    def _shrink(self, nbytes: int):
        self.ctx.memory_pool.shrink(self.consumer, nbytes)

    def add(self, rel: DeviceRelation):
        b = relation_bytes(rel)
        head = self.ctx.memory_pool.headroom_for(self.consumer)
        if head is not None and b > head:
            self._relieve(b)
        try:
            self._grow(b)
        except ResourceExhausted:
            self._relieve(b)
            self._grow(b)  # raises only if a single chunk exceeds the limit
        self.held.append(rel)
        if self.merge_fn is not None and len(self.held) >= self.merge_width:
            self._merge_held()

    def _merge_held(self):
        if self.merge_fn is None or len(self.held) <= 1:
            return
        old_bytes = sum(relation_bytes(r) for r in self.held)
        merged = self.merge_fn(self.held)
        self.held = [merged]
        self._shrink(old_bytes)
        self._grow(relation_bytes(merged))

    def _relieve(self, need: int):
        self._merge_held()
        pool = self.ctx.memory_pool
        while self.held:
            head = pool.headroom_for(self.consumer)
            if head is None or head >= need:
                return
            rel = self.held.pop(0)
            self.spilled.append(self.ctx.spill_manager.spill(rel))
            self._shrink(relation_bytes(rel))

    @property
    def spill_count(self) -> int:
        return len(self.spilled)

    # -- final fold ------------------------------------------------------
    def fold(self, merge_fn: Optional[Callable] = None) -> DeviceRelation:
        """Merge every run (held and spilled) into one relation, restoring
        spilled runs in memory-bounded batches onto the session's device."""
        merge_fn = merge_fn or self.merge_fn
        if merge_fn is None:
            raise ExecutionError("fold requires a merge function")
        pool = self.ctx.memory_pool
        device = resolve_device(self.ctx.device)
        current: Optional[DeviceRelation] = None
        batch: List[DeviceRelation] = list(self.held)
        self.held = []

        def flush():
            nonlocal current, batch
            runs = ([current] if current is not None else []) + batch
            if not runs:
                return
            old_bytes = sum(relation_bytes(r) for r in runs)
            current, batch = None, []  # the merge alone holds the runs
            merged = merge_fn(runs) if len(runs) > 1 else runs[0]
            self._shrink(old_bytes)
            self._grow(relation_bytes(merged))
            current = merged

        for s in self.spilled:
            head = pool.headroom_for(self.consumer)
            if batch and head is not None and head < s.nbytes:
                flush()
            batch.append(s.restore(device))
            self._grow(relation_bytes(batch[-1]))
            s.release()
            if len(batch) >= self.merge_width:
                flush()
        self.spilled = []
        flush()
        if current is None:
            raise ExecutionError("fold of empty accumulator")
        return current

    def release(self):
        """Drop every run and return every byte attributed to this consumer
        to the pool (a failed fold leaves runs in local variables, so the
        per-consumer total is the reliable record)."""
        pool = self.ctx.memory_pool
        self._shrink(pool.by_consumer.get(self.consumer, 0))
        self.held = []
        for s in self.spilled:
            s.release()
        self.spilled = []


# ---------------------------------------------------------------------------
# plan checks
# ---------------------------------------------------------------------------


def scan_unbounded(plan: P.PhysicalPlan) -> bool:
    """True when any scan in the tree reads an unbounded stream."""
    if isinstance(plan, P.ScanExec) and getattr(plan.provider, "unbounded", False):
        return True
    return any(scan_unbounded(c) for c in plan.children())


def plan_boundedness(plan: P.PhysicalPlan) -> bool:
    """True when the plan's OUTPUT is unbounded; raises PlanError when a
    pipeline-breaking operator consumes an unbounded input (reference: the
    Boundedness / EmissionType planning check, execution_plan.rs:1022,1067,
    and the CLI's unbounded guard, datafusion-cli exec.rs:274-281)."""
    from . import fused as F

    p = plan
    if isinstance(p, P.ScanExec):
        return bool(getattr(p.provider, "unbounded", False))
    if isinstance(p, (P.ValuesExec, P.EmptyExec)):
        return False
    if isinstance(p, (P.FilterExec, P.ProjectionExec, P.CompactExec,
                      P.UnnestExec, AliasExec)):
        return plan_boundedness(p.input)
    if isinstance(p, P.LimitExec):
        ub = plan_boundedness(p.input)
        return ub if p.fetch is None else False
    if isinstance(p, P.UnionExec):
        return any(plan_boundedness(c) for c in p.inputs)
    if isinstance(p, P.JoinExec):
        swapped, jt, _ = F.join_normalize(p)
        lplan, rplan = (p.right, p.left) if swapped else (p.left, p.right)
        if plan_boundedness(rplan):
            if jt is JoinType.INNER:
                # stream x stream runs as the symmetric join (reference:
                # SymmetricHashJoinExec, joins/symmetric_hash_join.rs)
                plan_boundedness(lplan)
                return True
            raise PlanError(
                f"{type(p).__name__}: {jt.value} join build side is an "
                f"unbounded stream; bound it (e.g. with LIMIT) first")
        return plan_boundedness(lplan)
    # pipeline breakers need the whole input before emitting anything
    for c in p.children():
        if plan_boundedness(c):
            raise PlanError(
                f"{type(p).__name__} cannot run over an unbounded stream "
                f"(pipeline breaker); add a LIMIT below it or bound the source")
    return False


def estimate_scan_bytes(plan: P.PhysicalPlan) -> int:
    """Device bytes the plan's scans would hold resident, estimated before
    execution (drives the `auto` out-of-core decision)."""
    total = 0

    def visit(p):
        nonlocal total
        if isinstance(p, P.ScanExec):
            try:
                n = int(p.provider.statistics().num_rows)
            except Exception:  # noqa: BLE001 -- no statistics (a stream)
                n = 0
            width = 1 + sum(f.dtype.np_dtype().itemsize + 1 for f in p.schema.fields)
            total += bucket_capacity(max(n, 1)) * width
        for c in p.children():
            visit(c)

    visit(plan)
    return total


def _direct_bytes(ctx) -> Optional[int]:
    """The most bytes a chunked join's direct-address table may take: a
    sixteenth of the pool's headroom (none when the pool is unbounded)."""
    head = ctx.memory_pool.headroom()
    return None if head is None else head // 16


def _shared_chunk_metadata(plan: P.PhysicalPlan) -> bool:
    """True when every scan under `plan` gives all its chunks one dictionary
    per string column and one bounds tuple per column (a stream's batches
    carry their own): a decision made on one chunk then holds for all."""
    if isinstance(plan, P.ScanExec):
        return plan.provider.shared_chunk_metadata
    return all(_shared_chunk_metadata(c) for c in plan.children())


def _pushed_back(first, rest) -> Iterator[DeviceRelation]:
    """`first`, then `rest`, without holding `first` once it is yielded
    (itertools.chain([first], rest) keeps the list, and so the chunk, for
    as long as it runs)."""
    box = [first]
    del first
    yield box.pop()
    yield from rest


def _key_buckets(keys: Sequence[DeviceColumn], parts: int) -> torch.Tensor:
    """A partition id in [0, parts) per row of group key columns (parts a
    power of two): keys that group together share it (NULLs whatever their
    data, 0.0 and -0.0, every NaN)."""
    hs = []
    for c in keys:
        d = c.data
        if d.dtype.is_floating_point:
            d = d.to(torch.float64) + 0.0  # -0.0 + 0.0 is 0.0
            d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
        elif d.dtype is not torch.bool:
            d = d.to(torch.int64)
        valid = c.valid()
        hs += [torch.where(valid, d, torch.zeros_like(d)), valid]
    return K.hash64(hs) & (parts - 1)


def _metadata_only(c: DeviceColumn) -> DeviceColumn:
    """The column's type, dictionary and bounds over no rows: what a
    decision or an output built from a chunk's column needs, without
    holding the chunk's tensors."""
    return DeviceColumn(c.data.new_empty((0,) + tuple(c.data.shape[1:])), None,
                        c.dtype, c.dictionary, c.bounds)


# ---------------------------------------------------------------------------
# the chunked executor
# ---------------------------------------------------------------------------


class ChunkedQuery:
    """Run a physical plan over capacity-bounded scan chunks, spilling under
    pressure. FusedQuery's counterpart for data that does not fit the card's
    budget; returns a host Table (the results of out-of-core queries land on
    the host anyway). Counters of the last collect(): `chunks` (scan chunks
    streamed), `chunk_bytes` (device bytes of the largest scan chunk),
    `spill_count` (runs the accumulators spilled), `offloads` (every
    device->host spill of the query: those runs, external-sort runs, host
    DISTINCT runs and grace partitions), `grace_partitions` (buckets of
    the last grace join, 0 when none ran) and `agg_splits` (the most
    pieces a sorted aggregate's partial, by row slices, or merge, by key
    partitions, was cut into to fit its working set; 0 when none was)."""

    def __init__(self, plan: P.PhysicalPlan, chunk_rows: int = 1 << 21):
        self.plan = plan
        self.chunk_rows = max(int(chunk_rows), bucket_capacity(1))
        self._fns: Dict[tuple, Callable] = {}
        self.spill_count = self.offloads = 0
        self.chunks = self.chunk_bytes = self.grace_partitions = 0
        self.agg_splits = 0

    # -- public ----------------------------------------------------------
    def collect(self, ctx) -> Table:
        self.spill_count = self.chunks = self.chunk_bytes = 0
        self.grace_partitions = self.agg_splits = 0
        out = self._collect(ctx)
        self.offloads = ctx.spill_manager.spill_count
        return out

    def _collect(self, ctx) -> Table:
        top = self.plan
        if isinstance(top, P.SortExec) and top.fetch is None:
            out = self._external_sort(top, ctx)
            if out is not None:
                return out
        if isinstance(top, P.DistinctExec):
            # a DISTINCT result larger than the budget finishes on the host:
            # per-chunk device dedupe bounds each run, one host merge of the
            # sorted runs dedupes them
            return self._host_distinct(top, ctx)
        # map() holds no chunk while it pulls the next one
        return concat_host(list(map(to_host, self._stream(top, ctx))), top.schema)

    def _host_distinct(self, p: P.DistinctExec, ctx) -> Table:
        tables = []
        for chunk in self._stream(p.input, ctx):
            t = to_host(self._compact(p._transform(chunk), ctx))
            del chunk
            ctx.spill_manager.record_offload(sum(c.data.nbytes for c in t.columns))
            tables.append(t)
        big = concat_host(tables, p.schema)
        if big.num_rows == 0:
            return big
        # per-chunk DISTINCT emits its rows ascending, so the chunks are
        # presorted runs: a k-way merge instead of a re-sort
        keys = [(c.data, c.validity, False, False) for c in big.columns]
        order = merge_run_indices(pack_key_rows(keys), [t.num_rows for t in tables])
        srt = big.take(order)
        differs = np.zeros(srt.num_rows, dtype=bool)
        differs[0] = True
        for c in srt.columns:
            differs[1:] |= c.data[1:] != c.data[:-1]
            if c.validity is not None:
                differs[1:] |= c.validity[1:] != c.validity[:-1]
        return srt.take(np.nonzero(differs)[0])

    # -- per-chunk callables ---------------------------------------------
    def _fn(self, key: tuple, make: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make()
        return fn

    def _compact(self, rel: DeviceRelation, ctx) -> DeviceRelation:
        """Gather the live rows to the front and shrink the capacity (one
        host read of the live count)."""
        live = int(rel.num_rows())
        cap = bucket_capacity(max(live, 1))
        if cap >= rel.capacity:
            return rel
        idx, total = K.compaction_indices(rel.sel, cap)
        cols = [P._with_leaves(c, {k: v[idx] for k, v in P._column_leaves(c).items()})
                for c in rel.columns]
        sel = torch.arange(cap, device=rel.device) < torch.clamp(total, max=cap)
        return DeviceRelation(rel.schema, tuple(cols), sel)

    # -- streaming -------------------------------------------------------
    # Every stage lets go of a chunk before it pulls the next one (map()
    # holds neither; a loop deletes its variables), so a scan's chunk and
    # what is computed from it leave the card before the next one uploads.
    def _stream(self, p: P.PhysicalPlan, ctx) -> Iterator[DeviceRelation]:
        if isinstance(p, P.ScanExec):
            def arrived(rel):
                ctx.check_cancelled()
                self.chunks += 1
                self.chunk_bytes = max(self.chunk_bytes, relation_bytes(rel))
                src = {f.name: c for f, c in zip(rel.schema.fields, rel.columns)}
                return DeviceRelation(
                    p.schema, tuple(src[f.name] for f in p.schema.fields), rel.sel)

            yield from map(arrived, p.provider.scan_chunks(
                ctx, filters=p.filters, projection=p.projection,
                chunk_rows=self.chunk_rows))
            return
        if isinstance(p, (P.ValuesExec, P.EmptyExec)):
            yield p.execute(ctx)
            return
        if isinstance(p, (P.FilterExec, P.ProjectionExec, P.UnnestExec)):
            yield from map(p._transform, self._stream(p.input, ctx))
            return
        if isinstance(p, P.CompactExec):  # chunks are already capacity-bounded
            yield from self._stream(p.input, ctx)
            return
        if isinstance(p, AliasExec):
            yield from map(lambda rel: DeviceRelation(p.schema, rel.columns, rel.sel),
                           self._stream(p.input, ctx))
            return
        if isinstance(p, P.LimitExec):
            yield from self._stream_limit(p, ctx)
            return
        if isinstance(p, P.SortExec):
            # chunk after chunk is never globally ordered: always the full
            # sort, whatever the presorted marking says
            if p.fetch is not None:
                yield from self._stream_topk(p, ctx)
            else:
                yield p._transform_full(self._materialize(p.input, ctx))
            return
        if isinstance(p, P.UnionExec):
            for c in p.inputs:
                yield from map(lambda rel: P.concat_relations([rel], p.schema),
                               self._stream(c, ctx))
            return
        if isinstance(p, P.AggregateExec):
            yield from self._stream_aggregate(p, ctx)
            return
        if isinstance(p, P.DistinctExec):
            yield from self._stream_distinct(p, ctx)
            return
        if isinstance(p, P.JoinExec):
            yield from self._stream_join(p, ctx)
            return
        if isinstance(p, WindowExec):
            yield p._transform(self._materialize(p.input, ctx))
            return
        # any other operator (a window top-k): the subtree runs resident
        yield p.execute(ctx)

    def _materialize(self, p: P.PhysicalPlan, ctx) -> DeviceRelation:
        """Stream a subtree and concatenate it into one compacted relation
        (spilling intermediates under memory pressure)."""
        return self._materialize_chunks(p.schema, ctx, self._stream(p, ctx),
                                        f"materialize:{type(p).__name__}")

    def _materialize_chunks(self, schema: Schema, ctx, chunks,
                            consumer: str) -> DeviceRelation:
        acc = SpillableAccumulator(
            ctx, consumer,
            merge_fn=lambda rels: self._concat_compact(rels, schema, ctx))
        try:
            n = 0
            for rel in chunks:
                acc.add(self._compact(rel, ctx))
                del rel
                n += 1
            if n == 0:
                return empty_relation(schema, ctx.device)
            out = acc.fold()
        except ResourceExhausted:
            acc.release()  # a caller may go on (the grace join): free it all
            raise
        self.spill_count += acc.spill_count
        return out

    def _concat_compact(self, rels: List[DeviceRelation], schema: Schema,
                        ctx) -> DeviceRelation:
        if len(rels) == 1:
            return rels[0]
        rel = _concat(rels, schema)
        rels.clear()
        return self._compact(rel, ctx)

    # -- limit -----------------------------------------------------------
    def _stream_limit(self, p: P.LimitExec, ctx) -> Iterator[DeviceRelation]:
        skip, fetch = p.skip, p.fetch
        seen = 0
        for chunk in self._stream(p.input, ctx):
            rank = torch.cumsum(chunk.sel, 0, dtype=torch.int64) + seen
            keep = chunk.sel & (rank > skip)
            if fetch is not None:
                keep = keep & (rank <= skip + fetch)
            live = int(chunk.num_rows())
            out = chunk.with_sel(keep)
            del chunk, rank, keep
            yield out
            del out
            seen += live
            if fetch is not None and seen >= skip + fetch:
                return

    # -- topk ------------------------------------------------------------
    def _stream_topk(self, p: P.SortExec, ctx) -> Iterator[DeviceRelation]:
        capk = bucket_capacity(max(p.fetch, 1))
        state: Optional[DeviceRelation] = None
        for chunk in self._stream(p.input, ctx):
            # sorted live-first and fetch-masked, then cut to capk
            head = _rows(p._transform_full(chunk), 0, capk)
            del chunk
            if state is not None:
                both = _concat([state, head], p.schema)
                head = _rows(p._transform_full(both), 0, capk)
            state, head = head, None
        yield state if state is not None else empty_relation(p.schema, ctx.device)

    # -- join ------------------------------------------------------------
    def _stream_join(self, p: P.JoinExec, ctx) -> Iterator[DeviceRelation]:
        from . import fused as F

        swapped, jt, on = F.join_normalize(p)
        lplan, rplan = (p.right, p.left) if swapped else (p.left, p.right)
        if jt is JoinType.INNER and scan_unbounded(rplan):
            yield from self._symmetric_join(p, ctx, lplan, rplan)
            return
        if jt is JoinType.FULL:
            # FULL needs the build rows unmatched over the whole probe side
            lrel = self._materialize(lplan, ctx)
            rrel = self._materialize(rplan, ctx)
            yield p.execute_rels(lrel, rrel, direct_bytes=_direct_bytes(ctx))
            return
        rrel = self._try_materialize(rplan, ctx)  # CollectLeft build side
        if rrel is None:
            # the build side exceeds the budget: grace hash join (reference:
            # PartitionMode::Partitioned, joins/hash_join/exec.rs)
            if on:
                yield from self._grace_join(p, ctx, lplan, rplan, on)
                return
            rrel = self._materialize(rplan, ctx)  # a cross join: raises
        if (on and jt in (JoinType.INNER, JoinType.LEFT_SEMI)
                and ctx.opt("optimizer.dynamic_filter_pushdown", True)):
            lplan = self._probe_bounds_pushdown(on, lplan, rrel)
        yield from map(
            lambda chunk: p.execute_rels(chunk, rrel, direct_bytes=_direct_bytes(ctx)),
            self._stream(lplan, ctx))

    def _probe_bounds_pushdown(self, on, lplan, rrel):
        """Dynamic filter pushdown: the build side's min/max key values
        become probe-side predicates -- a BETWEEN filter on each streamed
        chunk, and pruning hints on the probe's ScanExec so that Parquet row
        groups outside the build's key range are never read (reference:
        joins/hash_join/shared_bounds.rs + DynamicFilterPhysicalExpr)."""
        from ..optimizer.decorrelate import conjoin

        preds = []       # qualified: the exact per-chunk filter
        bare_preds = []  # bare column names: the scan's pruning hints
        for lk, rk in on:
            base = lk.expr if isinstance(lk, E.Alias) else lk
            if not isinstance(base, E.Column):
                continue
            try:
                col = eval_expr(rk, rrel)
            except Exception:  # noqa: BLE001 -- a key the build cannot evaluate
                continue
            if not col.dtype.is_integer or col.dictionary is not None:
                continue
            live = rrel.sel if col.validity is None else (rrel.sel & col.validity)
            data = col.data.to(torch.int64)
            info = np.iinfo(np.int64)
            lo_hi = torch.stack([
                torch.where(live, data, torch.full_like(data, info.max)).min(),
                torch.where(live, data, torch.full_like(data, info.min)).max()])
            lo, hi = (int(v) for v in lo_hi.cpu())
            if lo > hi:
                continue  # empty build side: the join itself yields nothing
            preds.append(E.Between(lk, E.lit(lo), E.lit(hi), False))
            bare_preds.append(E.Between(E.Column(base.cname), E.lit(lo),
                                        E.lit(hi), False))
        if not preds:
            return lplan

        def add_hints(plan):
            if isinstance(plan, P.ScanExec):
                return P.ScanExec(plan.provider, plan.schema, plan.projection,
                                  plan.alias, plan.filters + tuple(bare_preds))
            if isinstance(plan, P.FilterExec):
                inner = add_hints(plan.input)
                return None if inner is None else P.FilterExec(inner, plan.predicate)
            if isinstance(plan, P.CompactExec):
                inner = add_hints(plan.input)
                return None if inner is None else P.CompactExec(inner)
            return None

        hinted = add_hints(lplan)
        return P.FilterExec(hinted if hinted is not None else lplan, conjoin(preds))

    def _symmetric_join(self, p: P.JoinExec, ctx, lplan, rplan
                        ) -> Iterator[DeviceRelation]:
        """Symmetric incremental INNER join of two streams (reference:
        SymmetricHashJoinExec, joins/symmetric_hash_join.rs): chunks are
        pulled from both sides in turn; each new chunk joins every chunk
        held from the other side so far, so every (Li, Rj) pair is joined
        exactly once, as soon as both halves have arrived. Both sides keep
        their compacted chunks for the life of the query (the reference
        prunes them by interval analysis)."""
        lit = self._stream(lplan, ctx)
        rit = self._stream(rplan, ctx)
        acc_l: List[DeviceRelation] = []
        acc_r: List[DeviceRelation] = []
        l_done = r_done = False
        while not (l_done and r_done):
            ctx.check_cancelled()
            if not l_done:
                try:
                    lchunk = self._compact(next(lit), ctx)
                except StopIteration:
                    l_done = True
                else:
                    for rchunk in acc_r:
                        yield p.execute_rels(lchunk, rchunk,
                                             direct_bytes=_direct_bytes(ctx))
                    acc_l.append(lchunk)
            if not r_done:
                try:
                    rchunk = self._compact(next(rit), ctx)
                except StopIteration:
                    r_done = True
                else:
                    for lchunk in acc_l:
                        yield p.execute_rels(lchunk, rchunk,
                                             direct_bytes=_direct_bytes(ctx))
                    acc_r.append(rchunk)

    def _try_materialize(self, p: P.PhysicalPlan, ctx) -> Optional[DeviceRelation]:
        try:
            return self._materialize(p, ctx)
        except ResourceExhausted:
            return None

    def _grace_partitions(self, ctx, build_bytes: int) -> int:
        head = ctx.memory_pool.headroom()
        if head is None or head <= 0:
            return 32
        # one build bucket about an eighth of the remaining budget
        parts = 8
        while parts < 256 and max(build_bytes, 1) // parts > max(head // 8, 1):
            parts *= 2
        return parts

    @staticmethod
    def _hash_bucket_fn(key_exprs: Tuple[E.Expr, ...], nparts: int):
        """Per-row bucket ids from join-key VALUES: dictionary codes go
        through a stable per-value hash first, so the two sides -- which may
        carry different dictionaries -- bucket alike."""
        def f(rel):
            hs = []
            for e in key_exprs:
                c = eval_expr(e, rel)
                data = c.data
                if c.dtype.is_string and c.dictionary is not None:
                    hv = np.array([zlib.crc32(str(v).encode())
                                   for v in c.dictionary.values] or [0],
                                  dtype=np.int64)
                    table = torch.from_numpy(hv).to(data.device)
                    data = table[torch.clamp(data.to(torch.int64), 0, len(hv) - 1)]
                elif data.dtype.is_floating_point:
                    data = data.to(torch.float64)
                elif data.dtype is not torch.bool:
                    data = data.to(torch.int64)
                hs.append(data)
                hs.append(c.valid())
            return (K.hash64(hs) & (nparts - 1)).to(torch.int32)

        return f

    def _partition_to_host(self, plan: P.PhysicalPlan,
                           key_exprs: Tuple[E.Expr, ...], nparts: int,
                           ctx) -> List[List[Table]]:
        """Stream `plan`, moving each chunk's live rows to the host split by
        bucket: one batched copy per chunk, the bucket ids riding along as
        one more column."""
        parts: List[List[Table]] = [[] for _ in range(nparts)]
        fn = self._hash_bucket_fn(key_exprs, nparts)
        bucket = Field("__bucket", T.INT32, False)
        for chunk in self._stream(plan, ctx):
            ext = DeviceRelation(Schema(list(chunk.schema.fields) + [bucket]),
                                 chunk.columns + (DeviceColumn(fn(chunk), None, T.INT32),),
                                 chunk.sel)
            host = to_host(ext)
            t = Table(chunk.schema, host.columns[:-1])
            bid = host.columns[-1].data
            ctx.spill_manager.record_offload(sum(c.data.nbytes for c in t.columns))
            order = np.argsort(bid, kind="stable")
            edges = np.searchsorted(bid[order], np.arange(nparts + 1))
            for b in range(nparts):
                if edges[b + 1] > edges[b]:
                    parts[b].append(t.take(order[edges[b]:edges[b + 1]]))
            del chunk, ext
        return parts

    def _grace_join(self, p: P.JoinExec, ctx, lplan, rplan,
                    on) -> Iterator[DeviceRelation]:
        nparts = self._grace_partitions(ctx, estimate_scan_bytes(rplan))
        self.grace_partitions = nparts
        probe_keys = tuple(l for l, _ in on)
        build_keys = tuple(r for _, r in on)
        bparts = self._partition_to_host(rplan, build_keys, nparts, ctx)
        lparts = self._partition_to_host(lplan, probe_keys, nparts, ctx)
        device = resolve_device(ctx.device)
        emitted = False
        for b in range(nparts):
            if not lparts[b]:
                continue  # inner, left and semi joins emit nothing without probe rows
            brel = to_device(concat_host(bparts[b], rplan.schema), device=device)
            ptab = concat_host(lparts[b], lplan.schema)
            step = self.chunk_rows
            for start in range(0, max(ptab.num_rows, 1), step):
                prel = to_device(ptab, device=device,
                                 row_range=(start, min(start + step, ptab.num_rows)))
                out = p.execute_rels(prel, brel, direct_bytes=_direct_bytes(ctx))
                del prel
                yield out
                del out
                emitted = True
            del brel
        if not emitted:
            yield empty_relation(p.schema, device)

    # -- distinct --------------------------------------------------------
    def _stream_distinct(self, p: P.DistinctExec, ctx) -> Iterator[DeviceRelation]:
        def merge(rels: List[DeviceRelation]) -> DeviceRelation:
            rel = _concat(rels, p.schema)
            rels.clear()
            return self._compact(p._transform(rel), ctx)

        acc = SpillableAccumulator(ctx, "distinct", merge_fn=merge)
        n = 0
        for chunk in self._stream(p.input, ctx):
            acc.add(self._compact(p._transform(chunk), ctx))
            del chunk
            n += 1
        if n == 0:
            yield empty_relation(p.schema, ctx.device)
            return
        out = acc.fold()
        self.spill_count += acc.spill_count
        yield out

    # -- aggregation -----------------------------------------------------
    def _stream_aggregate(self, p: P.AggregateExec, ctx) -> Iterator[DeviceRelation]:
        chunks = self._stream(p.input, ctx)
        first = next(chunks, None)
        if first is None:
            yield p.execute_rel(ctx, empty_relation(p.input.schema, ctx.device))
            return
        # the aggregate's static structure, from one concrete chunk; the
        # chunk then goes back at the head of the stream, and nothing here
        # holds it once the consumer has let it go
        specs = p._prepare(first)[3]
        decomp = AS.decomposable(specs)
        shared = _shared_chunk_metadata(p.input)
        # dense slots and the elementwise merge rest on one dictionary and
        # one bounds tuple for every chunk; a stream's batches carry their
        # own, so their grouped (and string-valued) states take the sorted
        # merge, whose concatenation unifies dictionaries
        dense = (p._dense_sizes(first) if decomp and p.group_exprs and shared
                 else None)
        global_dense = (decomp and not p.group_exprs
                        and (shared or not any(c.dtype.is_string for c in
                                               p._prepare(first)[1])))
        chunks = _pushed_back(first, chunks)
        del first
        if not decomp:
            # DISTINCT aggregates and order statistics: exact in one pass
            # over the (spill-accumulated) materialized input
            yield p.execute_rel(ctx, self._materialize_chunks(
                p.input.schema, ctx, chunks, "materialize:agg-input"))
            return
        if global_dense:
            yield self._agg_dense(p, chunks, (), 1)
            return
        if dense is not None:
            yield self._agg_dense(p, chunks, *dense)
            return
        yield self._agg_sorted(p, ctx, chunks)

    def _dense_partial(self, p: P.AggregateExec, sizes, ngroups: int, rel):
        """One chunk's partial states at the dense group slots: (states,
        group counts, group key columns and state plan as metadata over no
        rows, which hold none of the chunk's tensors)."""
        group_cols, arg_cols, filter_cols, specs = p._prepare(rel)
        sp = AS.build_state_plan(specs, arg_cols)
        seg, _ = p.dense_seg(group_cols, rel.sel, list(sizes), ngroups)
        states, group_count = AS.dense_states(
            p, rel, specs, p._agg_fns(), arg_cols, filter_cols, sp, seg, ngroups,
            kernel=bool(sizes) or p._global_dense_ok(rel))
        return (states, group_count, [_metadata_only(c) for c in group_cols],
                dataclasses.replace(sp, state_args=[]))

    def _agg_dense(self, p: P.AggregateExec, chunks, sizes,
                   ngroups: int) -> DeviceRelation:
        """Dense small-domain keys, or a global aggregate (ngroups == 1):
        partial states sit at fixed group slots, and the merge across chunks
        is elementwise."""
        partial = self._fn(("agg-dense-partial", id(p)), lambda: functools.partial(
            self._dense_partial, p, tuple(sizes), ngroups))
        run = run_count = None
        for chunk in chunks:
            states, count, group_cols, sp = partial(chunk)
            del chunk
            if run is None:
                keys_from, sp_final, meta = group_cols, sp, states
                ops = [_MERGE[k if k != "bitop" else m.fname]
                       for k, m in zip(sp.merge_kinds, sp.merge_specs)]
                run, run_count = [s.data for s in states], count
                continue
            run = [op(x, s.data) for op, x, s in zip(ops, run, states)]
            run_count = run_count + count

        merged = [DeviceColumn(d, None, m.dtype, m.dictionary) for d, m in zip(run, meta)]
        if sizes:
            out_sel = run_count > 0
            strides, stride = [], 1
            for size in reversed(list(sizes)):
                strides.append(stride)
                stride *= size
            out_keys = p.dense_keys(keys_from, list(sizes), list(reversed(strides)),
                                    ngroups)
        else:  # a global aggregate: one row, also over no input
            out_sel = torch.ones(1, dtype=torch.bool, device=run_count.device)
            out_keys = []
        out_aggs = AS.finalize(sp_final, merged, out_sel)
        cols = [p._coerce_out(c, f) for c, f in zip(out_keys + out_aggs, p.schema.fields)]
        return DeviceRelation(p.schema, tuple(cols), out_sel)

    @staticmethod
    def _sorted_partial(p: P.AggregateExec, state_schema: Schema, rel) -> DeviceRelation:
        """One chunk's partial states by sorted group key: (keys, states)
        rows, one per group of the chunk."""
        group_cols, arg_cols, filter_cols, specs = p._prepare(rel)
        sp = AS.build_state_plan(specs, arg_cols)
        sg, sa, sf, ssel, seg, is_start, _, _ = G.phase_sort(
            group_cols, sp.state_args, filter_cols, rel.sel, None)
        out_keys, out_states, out_sel = G.phase_reduce(
            sg, sa, sf, ssel, seg, is_start, None, sp.state_specs, rel.capacity)
        return DeviceRelation(state_schema, tuple(out_keys) + tuple(out_states),
                              out_sel)

    # a sorted partial's or merge's working set over the bytes of its
    # input: about six, one for each of the sort key, its permutation, the
    # sorted keys and states, segment ids and prefix sums (whole, chunked
    # TPC-H Q18's merge of 1.5M groups peaked 240.9 MB above what an NVIDIA
    # H100 held when its fold began, Q13's partial over one 1.5M-row join
    # output 203.3 MB)
    SORT_WORKING_FACTOR = 6

    def _agg_pieces(self, ctx, rel: DeviceRelation) -> int:
        """Pieces (a power of two) a sorted partial or merge of `rel` is cut
        into so that one piece's working set fits half the pool's headroom
        (1 when the pool is unbounded)."""
        head = ctx.memory_pool.headroom()
        if head is None:
            return 1
        need = self.SORT_WORKING_FACTOR * relation_bytes(rel)
        parts = 1
        while parts < 64 and need // parts > max(head // 2, 1):
            parts *= 2
        if parts > 1:
            self.agg_splits = max(self.agg_splits, parts)
        return parts

    def _agg_sorted(self, p: P.AggregateExec, ctx, chunks) -> DeviceRelation:
        """Arbitrary keys: sorted Partial states per chunk, accumulated under
        the pool (merged, then spilled, under pressure), one sorted Final
        merge (Partial -> Final on the time axis)."""
        first = next(chunks)
        gcols0, arg_cols0, _, specs0 = p._prepare(first)
        chunks = _pushed_back(first, chunks)
        # the static plan without the chunk's argument columns
        sp_static = dataclasses.replace(AS.build_state_plan(specs0, arg_cols0),
                                        state_args=[])
        nkeys = len(p.group_exprs)
        state_schema = Schema(
            [Field(f"k{i}", c.dtype, nullable=True) for i, c in enumerate(gcols0)]
            + [Field(f"s{i}", s.out_dtype, nullable=True)
               for i, s in enumerate(sp_static.merge_specs)])
        del first, gcols0, arg_cols0, _

        def reduce(rel: DeviceRelation) -> DeviceRelation:
            sg, sa, sf, ssel, seg, is_start, _, ng = G.phase_sort(
                list(rel.columns[:nkeys]), list(rel.columns[nkeys:]), [],
                rel.sel, None)
            del rel  # the sorted copies alone go on
            cap = bucket_capacity(max(int(ng), 1))  # host read: the group count
            mkeys, mstates, msel = G.phase_reduce(
                sg, sa, sf, ssel, seg, is_start, None, sp_static.merge_specs, cap)
            return DeviceRelation(state_schema, tuple(mkeys) + tuple(mstates), msel)

        def merge(rels: List[DeviceRelation]) -> DeviceRelation:
            rel = _concat(rels, state_schema)
            rels.clear()
            parts = (self._agg_pieces(ctx, rel) if nkeys and all(
                c.data.ndim == 1 for c in rel.columns[:nkeys]) else 1)
            if parts == 1:
                return reduce(rel)
            # groups of different key partitions are disjoint: each
            # partition merges alone, with a part of the working set
            bucket = _key_buckets(rel.columns[:nkeys], parts)
            outs = [reduce(self._compact(rel.with_sel(rel.sel & (bucket == b)), ctx))
                    for b in range(parts)]
            del rel, bucket
            return self._concat_compact(outs, state_schema, ctx)

        partial = self._fn(("agg-sorted-partial", id(p)), lambda: functools.partial(
            self._sorted_partial, p, state_schema))
        acc = SpillableAccumulator(ctx, "aggregate:partial", merge_fn=merge)
        for chunk in chunks:
            # a chunk (a join's output may pass the scan's chunk) whose
            # partial would not fit goes in row slices: their partial
            # states merge like any other runs
            step = -(-chunk.capacity // self._agg_pieces(ctx, chunk))
            for start in range(0, chunk.capacity, step):
                acc.add(self._compact(partial(_rows(chunk, start, start + step)), ctx))
            del chunk
        merged = acc.fold()
        self.spill_count += acc.spill_count
        mkeys = list(merged.columns[:nkeys])
        out_aggs = AS.finalize(sp_static, list(merged.columns[nkeys:]), merged.sel)
        cols = [p._coerce_out(c, f) for c, f in zip(mkeys + out_aggs, p.schema.fields)]
        return DeviceRelation(p.schema, tuple(cols), merged.sel)

    # -- external sort ---------------------------------------------------
    def _external_sort(self, p: P.SortExec, ctx) -> Optional[Table]:
        """ORDER BY over plain columns at the top of the plan: each chunk is
        sorted on the device and moved to the host as a sorted run, and one
        O(n log r) k-way merge on the host orders the runs (reference: the
        streaming loser-tree merge, sorts/merge.rs:54-97). None when a sort
        key is a computed expression (the materialized device sort takes
        those)."""
        schema = p.input.schema
        key_idx: List[int] = []
        for s in p.specs:
            e = s.expr
            if not isinstance(e, E.Column):
                return None
            idx = next((i for i, f in enumerate(schema.fields)
                        if f.qualified_name == e.cname or f.name == e.cname), None)
            if idx is None:
                return None
            key_idx.append(idx)
        tables = []
        for rel in self._stream(p.input, ctx):
            t = to_host(p._transform_full(rel))
            del rel
            ctx.spill_manager.record_offload(sum(c.data.nbytes for c in t.columns))
            tables.append(t)
        big = concat_host(tables, schema)
        keys = [(big.columns[i].data, big.columns[i].validity, not s.asc,
                 s.nulls_first) for s, i in zip(p.specs, key_idx)]
        order = merge_run_indices(pack_key_rows(keys), [t.num_rows for t in tables])
        return Table(p.schema, big.take(order).columns)


def _bool_merge(op):
    """A merge of bool states as integers (min/max have no bool kernels on
    every device)."""
    def f(x, y):
        if x.dtype is torch.bool:
            return op(x.to(torch.int32), y.to(torch.int32)).to(torch.bool)
        return op(x, y)

    return f


_MERGE = {
    "sum": lambda x, y: x + y,
    "min": _bool_merge(torch.minimum),
    "max": _bool_merge(torch.maximum),
    "bit_and": torch.bitwise_and,
    "bit_or": torch.bitwise_or,
    "bit_xor": torch.bitwise_xor,
}
