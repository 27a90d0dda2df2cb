"""Distributed execution of the engine's physical plans over a mesh of shards.

Port of datafusion_tpu/parallel/engine.py, the counterpart of the
reference's exchange-parallel physical layer: collectives stand where the
reference inserts RepartitionExec / CoalescePartitionsExec
(physical-plan/src/repartition/mod.rs:1196, coalesce_partitions.rs:45,
physical-optimizer/src/ensure_requirements/enforce_distribution.rs). The JAX
package traces the whole plan into one `shard_map` program; here one process
walks the plan once per execute(), and each node's value is a list of n
per-shard DeviceRelations (parallel/distributed.Mesh):

  Scan leaves         -> contiguous row partitioning of the scanned
                         relation (the `target_partitions` analog)
  Filter/Projection   -> per shard (distribution-preserving)
  Join                -> small build sides are all_gather'ed
                         (PartitionMode::CollectLeft); large build sides
                         switch to PartitionMode::Partitioned: BOTH sides
                         hash-exchanged on the join keys and joined per
                         shard -- exact for every join type, FULL included,
                         because every row of a key lands on one shard
  grouped Aggregate   -> decomposable aggregates split Partial/Final (only
                         states cross shards, aggsplit.py); otherwise rows
                         are exchanged by hash(group keys) and aggregated per
                         shard (AggregateMode::FinalPartitioned)
  global Aggregate    -> all_gather + a replicated single-segment reduce
  Sort+fetch (TopK)   -> per-shard sort truncated to the fetch bound, only
                         n * fetch rows gathered, then the final sort
  Window              -> rows hash-exchanged on the common PARTITION BY keys,
                         then the window per shard
  Distinct            -> rows hash-exchanged on all columns, deduped per shard
  full Sort / Limit   -> all_gather + replicated compute

A partitioned value holds one relation per shard. A replicated value is
computed once per distinct device, and the shards on one device share that
one relation: eight shards on one card hold one copy of a broadcast build
side, and a replicated operator runs once there.

Distribution decisions depend only on the plan and the capacities discovery
recorded (dist_of mirrors _dtrace exactly). Each shard's operators run on
the discovered capacities, as FusedQuery's walk does, without host reads;
the overflow flags of every exchange and partitioned join stay on the device
and are read once, at the end of the walk.

Skew (SURVEY.md §6 "Skewed keys"): every exchange allocates slot_cap =
slot_factor * (capacity / n) receive slots per (source, destination) pair
instead of the overflow-proof worst case (n times the memory). Overflow rows
are dropped and counted; when the flag fires, the host doubles slot_factor
and runs the walk again -- capacities only grow, and the ladder ends at the
overflow-proof bound, where it raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common.errors import ExecutionError
from ..data.device import DeviceRelation
from ..expr import nodes as E
from ..logical.plan import JoinType
from ..ops import kernels as K
from ..physical import expr_compiler as EC
from ..physical import fused as F
from ..physical import plan as PP
from ..physical.expr_compiler import eval_expr
from ..physical.planner import AliasExec
from ..physical.window import WindowExec, WindowTopKExec
from . import distributed as D
from .distributed import Mesh, make_mesh

PART, REPL = "part", "repl"

# build sides at or below this capacity broadcast (CollectLeft); larger ones
# hash-partition both sides (the JoinSelection threshold analog,
# physical-optimizer JoinSelection / config collect_left_threshold)
BROADCAST_CAP_DEFAULT = 1 << 21

Shards = List[DeviceRelation]


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _join_mode(p: PP.JoinExec, options: dict) -> str:
    """'collect' (broadcast build) or 'partitioned' (hash-exchange both
    sides). Depends only on the plan and the discovery-recorded input
    capacities, so dist_of and _dtrace always agree."""
    if not p.on or p.range_on is not None:
        return "collect"  # no equi-keys to partition on
    mode = options.get("join_mode")
    if mode in ("collect", "partitioned"):
        return mode
    caps = getattr(p, "_last_input_caps", None)
    if caps is None:
        return "collect"
    limit = options.get("broadcast_cap", BROADCAST_CAP_DEFAULT)
    return "partitioned" if caps[1] > limit else "collect"


def _window_part_keys(p: WindowExec) -> Optional[List[E.Expr]]:
    """PARTITION BY exprs shared by EVERY window function of the node; rows
    exchanged on them colocate each function's partitions (each function's
    partitioning is equal to or finer than the common set)."""
    common: Optional[Dict[str, E.Expr]] = None
    for e in p.window_exprs:
        w = e.expr if isinstance(e, E.Alias) else e
        if not isinstance(w, E.WindowFunction):
            return None
        keys = {repr(x): x for x in w.partition_by}
        common = keys if common is None else \
            {k: v for k, v in common.items() if k in keys}
    return list(common.values()) if common else None


def _distinct_hashable(p: PP.DistinctExec) -> bool:
    return all(f.name is not None for f in p.schema.fields)


def dist_of(p: PP.PhysicalPlan, memo: Optional[Dict] = None,
            options: Optional[dict] = None) -> str:
    """Static output distribution of a plan node ('part' = row-partitioned
    over the mesh, 'repl' = replicated on every shard). Mirrored exactly by
    _dtrace below."""
    memo = memo if memo is not None else {}
    options = options or {}
    d = memo.get(id(p))
    if d is not None:
        return d
    if isinstance(p, (PP.ScanExec, PP.ValuesExec, PP.EmptyExec)):
        d = PART
    elif isinstance(p, (PP.FilterExec, PP.ProjectionExec, AliasExec,
                        PP.CompactExec)):
        d = dist_of(p.input, memo, options)
    elif isinstance(p, PP.SortExec):
        dist_of(p.input, memo, options)
        d = REPL  # full sort and TopK-merge both emit one global order
    elif isinstance(p, PP.LimitExec):
        dist_of(p.input, memo, options)
        d = REPL
    elif isinstance(p, PP.DistinctExec):
        ci = dist_of(p.input, memo, options)
        d = PART if ci == PART and _distinct_hashable(p) else REPL
    elif isinstance(p, WindowExec):
        ci = dist_of(p.input, memo, options)
        d = PART if ci == PART and _window_part_keys(p) else REPL
    elif isinstance(p, WindowTopKExec):
        ci = dist_of(p.input, memo, options)
        d = PART if ci == PART and p.wfn.partition_by else REPL
    elif isinstance(p, PP.UnionExec):
        ds = [dist_of(c, memo, options) for c in p.inputs]
        d = PART if all(x == PART for x in ds) else REPL
    elif isinstance(p, PP.AggregateExec):
        ci = dist_of(p.input, memo, options)
        d = REPL if not p.group_exprs else ci
    elif isinstance(p, PP.JoinExec):
        swapped, jt, _ = F.join_normalize(p)
        lplan, rplan = (p.right, p.left) if swapped else (p.left, p.right)
        dl = dist_of(lplan, memo, options)
        dist_of(rplan, memo, options)
        if _join_mode(p, options) == "partitioned":
            d = PART
        else:
            d = REPL if jt is JoinType.FULL else dl
    elif len(p.children()) == 1:
        # generic fallback: replicate and run the single-device operator
        # (the reference's EnforceDistribution inserting a coalesce before
        # an operator that requires a single partition)
        dist_of(p.children()[0], memo, options)
        d = REPL
    else:
        raise ExecutionError(f"cannot distribute operator {type(p).__name__}")
    memo[id(p)] = d
    return d


class _DCtx:
    def __init__(self, mesh: Mesh, options: Optional[dict] = None,
                 slot_factor: int = 2):
        self.mesh = mesh
        self.options = options or {}
        self.slot_factor = slot_factor
        self.memo: Dict[int, Tuple[Shards, str]] = {}
        self.flags: List[torch.Tensor] = []  # 0-d bools: True = overflow
        self.max_cap = 0  # widest per-shard relation the collectives made
        self.exchanges: List[int] = []  # per-shard receive capacity of each
        self.gathers = 0

    def note_cap(self, cap: int) -> None:
        self.max_cap = max(self.max_cap, cap)

    def each(self, dist: str, fn, *shard_lists) -> list:
        """fn per shard of partitioned inputs, once per device of
        replicated ones."""
        if dist == REPL:
            return D.per_device(self.mesh, fn, *shard_lists)
        return [fn(*args) for args in zip(*shard_lists)]


def _rebuild(template: DeviceRelation, tensors, sel, schema=None,
             cover_zero: bool = False) -> DeviceRelation:
    return DeviceRelation(schema if schema is not None else template.schema,
                          tuple(D.columns_like(template.columns, tensors, cover_zero)),
                          sel)


def _gather_rel(rels: Shards, mesh: Mesh) -> Shards:
    """all_gather every tensor of the shards' relations (tiled): local
    capacity C -> n * C on each device, in shard-major row order."""
    leaves = [D.column_tensors(r.columns) for r in rels]
    cols = [D.all_gather([lv[j] for lv in leaves], mesh) for j in range(len(leaves[0]))]
    sel = D.all_gather([r.sel for r in rels], mesh)
    return D.per_device(mesh, lambda i: _rebuild(rels[i], [c[i] for c in cols], sel[i]),
                        list(range(mesh.n)))


def _as_repl(rels: Shards, dist: str, dctx: _DCtx) -> Shards:
    if dist == REPL:
        return rels
    out = _gather_rel(rels, dctx.mesh)
    dctx.gathers += 1
    dctx.note_cap(out[0].capacity)
    return out


def _row_hash(cols) -> torch.Tensor:
    """Hash rows of key columns, canonically across relations: data under a
    NULL is masked to zero (storage under invalid slots is arbitrary, and
    join sides may disagree on validity presence) and a validity plane is
    always included, so NULL keys land together."""
    hs: List[torch.Tensor] = []
    for c in cols:
        if c.lengths is not None or c.data.ndim != 1:
            raise ExecutionError("cannot hash-exchange list-typed keys")
        d = c.data
        if c.validity is not None:
            d = torch.where(c.validity, d, torch.zeros((), dtype=d.dtype, device=d.device))
            hs.append(c.validity)
        else:
            hs.append(torch.ones(d.shape[:1], dtype=torch.bool, device=d.device))
        hs.append(d)
    return K.hash64(hs)


def _exchange_rel(rels: Shards, hs: Sequence[torch.Tensor], dctx: _DCtx,
                  schema=None) -> Shards:
    """Hash-exchange the shards' rows to shard h % n, with slot_factor x the
    even split of receive slots; overflow is counted into dctx.flags for
    the host's detect -> grow -> run-again ladder."""
    n = dctx.mesh.n
    cap = rels[0].capacity
    slot_cap = min(cap, _pow2(max(64, -(-cap // n) * dctx.slot_factor)))
    leaves = [D.column_tensors(r.columns) for r in rels]
    outs, new_sel, dropped = D.exchange_by_key(
        [[lv[j] for lv in leaves] for j in range(len(leaves[0]))], hs,
        [r.sel for r in rels], dctx.mesh, slot_cap=slot_cap)
    if slot_cap < cap:
        dctx.flags.extend(d > 0 for d in dropped)
    dctx.note_cap(n * slot_cap)
    dctx.exchanges.append(n * slot_cap)
    # receive buffers zero-fill unoccupied slots: bounds widen to take 0
    return [_rebuild(r, [o[i] for o in outs], new_sel[i], schema, cover_zero=True)
            for i, r in enumerate(rels)]


def _exchange_by_group(p: PP.AggregateExec, rels: Shards, dctx: _DCtx) -> Shards:
    """Hash-repartition rows by group keys, so that each group lies wholly
    on one shard (RepartitionExec::Hash)."""
    hs = [_row_hash([eval_expr(g, r) for g in p.group_exprs]) for r in rels]
    return _exchange_rel(rels, hs, dctx)


def _departition(rels: Shards, hs: Sequence[torch.Tensor], mesh: Mesh) -> Shards:
    """Split a REPLICATED relation into a partitioned one without any
    communication: every shard keeps the rows whose hash routes to it (where
    _exchange_rel would have sent them)."""
    n = mesh.n
    return [r.with_sel(r.sel & (K.hash_mod(h, n) == i))
            for i, (r, h) in enumerate(zip(rels, hs))]


def _truncate(rel: DeviceRelation, cap: int) -> DeviceRelation:
    return _rebuild(rel, [t[:cap] for t in D.column_tensors(rel.columns)],
                    rel.sel[:cap])


def _dtrace(p, inputs, leaf_index, dctx) -> Tuple[Shards, str]:
    hit = dctx.memo.get(id(p))
    if hit is not None:
        return hit
    out = _dtrace_inner(p, inputs, leaf_index, dctx)
    dctx.memo[id(p)] = out
    return out


def _join_side_hashes(on, lrels: Shards, rrels: Shards):
    """Cross-side-consistent row hashes of the (normalized) join keys: string
    keys share one dictionary first, as the local join's keys do
    (physical/plan.unified_keys)."""
    hl, hr = [], []
    for l, r in zip(lrels, rrels):
        lk, rk = PP.unified_keys(on, l, r)
        hl.append(_row_hash(lk))
        hr.append(_row_hash(rk))
    return hl, hr


def _dtrace_inner(p, inputs, leaf_index, dctx) -> Tuple[Shards, str]:
    mesh = dctx.mesh
    if isinstance(p, (PP.ScanExec, PP.ValuesExec, PP.EmptyExec)):
        rels = inputs[leaf_index[id(p)]]
        if isinstance(p, PP.ScanExec):
            def pick(rel):
                src = {f.name: c for f, c in zip(rel.schema.fields, rel.columns)}
                return DeviceRelation(
                    p.schema, tuple(src[f.name] for f in p.schema.fields), rel.sel)
            rels = [pick(r) for r in rels]
        return rels, PART
    if isinstance(p, (PP.FilterExec, PP.ProjectionExec)):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        return dctx.each(d, p._transform, rels), d
    if isinstance(p, PP.CompactExec):  # shard-local capacities stay as they are
        return _dtrace(p.input, inputs, leaf_index, dctx)
    if isinstance(p, AliasExec):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        return dctx.each(d, lambda r: DeviceRelation(p.schema, r.columns, r.sel),
                         rels), d
    if isinstance(p, PP.SortExec):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        if d == PART and p.fetch is not None:
            # distributed TopK: the global top-k is a subset of the union of
            # the per-shard top-k runs, so only n * fetch rows are gathered
            # (reference: topk/mod.rs heap + sort_preserving_merge.rs)
            local = [p._transform_full(r) for r in rels]
            capk = min(local[0].capacity, _pow2(max(p.fetch, 64)))
            gathered = _as_repl([_truncate(r, capk) for r in local], PART, dctx)
            return D.per_device(mesh, p._transform_full, gathered), REPL
        gathered = _as_repl(rels, d, dctx)
        # shard-major gather order is NOT globally sorted: always run the
        # full sort, even when the single-device plan was marked presorted
        return D.per_device(mesh, p._transform_full, gathered), REPL
    if isinstance(p, PP.LimitExec):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
    if isinstance(p, PP.DistinctExec):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        if d == PART and _distinct_hashable(p):
            try:
                hs = [_row_hash(r.columns) for r in rels]
            except ExecutionError:  # a list-typed column: gather instead
                return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
            return [p._transform(r) for r in _exchange_rel(rels, hs, dctx)], PART
        return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
    if isinstance(p, WindowExec):
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        pby = _window_part_keys(p)
        if d == PART and pby:
            try:
                hs = [_row_hash([eval_expr(e, r) for e in pby]) for r in rels]
            except ExecutionError:
                return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
            return [p._transform(r) for r in _exchange_rel(rels, hs, dctx)], PART
        return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
    if isinstance(p, WindowTopKExec):
        # per-group top-k: whole partitions exchanged to one shard (as
        # WindowExec), then the local sort + rank + compaction at the
        # discovered capacity (a shard's survivors are a subset of the
        # discovery run's, so the capacity holds per shard)
        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        cap = p._last_cap
        if cap is None:
            raise ExecutionError("window top-k capacity not discovered")

        def local(r):
            perm, rank, keep = p._phase1(r)
            return p._apply(r, perm, rank, keep, cap)

        if d == PART and p.wfn.partition_by:
            try:
                hs = [_row_hash([eval_expr(e, r) for e in p.wfn.partition_by])
                      for r in rels]
            except ExecutionError:
                return D.per_device(mesh, local, _as_repl(rels, d, dctx)), REPL
            return [local(r) for r in _exchange_rel(rels, hs, dctx)], PART
        return D.per_device(mesh, local, _as_repl(rels, d, dctx)), REPL
    if isinstance(p, PP.UnionExec):
        rds = [_dtrace(c, inputs, leaf_index, dctx) for c in p.inputs]
        if all(d == PART for _, d in rds):
            return [p._transform(list(rs)) for rs in zip(*(r for r, _ in rds))], PART
        reps = [_as_repl(r, d, dctx) for r, d in rds]
        return D.per_device(mesh, lambda *rs: p._transform(list(rs)), *reps), REPL
    if isinstance(p, PP.AggregateExec):
        from . import aggsplit

        rels, d = _dtrace(p.input, inputs, leaf_index, dctx)
        local = lambda r: F.apply_aggregate(p, r, cached=False)  # noqa: E731
        if not p.group_exprs or d == REPL:
            return D.per_device(mesh, local, _as_repl(rels, d, dctx)), REPL
        # Partial/Final split (states, not rows, cross shards) when every
        # aggregate decomposes; dense keys merge by psum (PartialReduce)
        dense = p._dense_sizes(rels[0], cached=False)
        if dense is not None:
            out = aggsplit.dense_partial_final(p, rels, mesh, *dense,
                                               options=dctx.options)
        else:
            out = aggsplit.sorted_partial_final(p, rels, mesh, options=dctx.options)
        if out is not None:
            return out, PART
        # fallback (DISTINCT, order statistics): exchange the rows, then the
        # single-phase local aggregation -- exact for everything
        return [local(r) for r in _exchange_by_group(p, rels, dctx)], PART
    if isinstance(p, PP.JoinExec):
        swapped, jt, on = F.join_normalize(p)
        lplan, rplan = (p.right, p.left) if swapped else (p.left, p.right)
        lrels, dl = _dtrace(lplan, inputs, leaf_index, dctx)
        rrels, dr = _dtrace(rplan, inputs, leaf_index, dctx)
        if _join_mode(p, dctx.options) == "partitioned":
            # PartitionMode::Partitioned (joins/mod.rs:96): BOTH sides
            # hash-exchanged on the join keys; every key's rows from both
            # sides land on one shard, so the local join -- unmatched rows
            # included -- is exact for every join type, FULL included
            hl, hr = _join_side_hashes(on, lrels, rrels)
            lpart = (_exchange_rel(lrels, hl, dctx) if dl == PART
                     else _departition(lrels, hl, mesh))
            rpart = (_exchange_rel(rrels, hr, dctx) if dr == PART
                     else _departition(rrels, hr, mesh))
            co, co_cap = p._last_co, None
            if co:
                co_cap = min(co, _pow2(max(64, -(-co // mesh.n) * dctx.slot_factor)))
            out = [F.apply_join(p, l, r, tctx=dctx, co_cap=co_cap)
                   for l, r in zip(lpart, rpart)]
            dctx.note_cap(out[0].capacity)
            return out, PART
        if jt is JoinType.FULL or dl == REPL:
            # FULL needs both sides' unmatched rows emitted exactly once
            return D.per_device(mesh, lambda l, r: F.apply_join(p, l, r),
                                _as_repl(lrels, dl, dctx),
                                _as_repl(rrels, dr, dctx)), REPL
        # CollectLeft: the build side broadcast, the probe stays local
        return [F.apply_join(p, l, r) for l, r in
                zip(lrels, _as_repl(rrels, dr, dctx))], PART
    if len(p.children()) == 1 and hasattr(p, "_transform"):
        # generic single-input fallback: replicate, then each device runs
        # the operator's own single-device transform
        rels, d = _dtrace(p.children()[0], inputs, leaf_index, dctx)
        return D.per_device(mesh, p._transform, _as_repl(rels, d, dctx)), REPL
    raise ExecutionError(f"cannot distribute operator {type(p).__name__}")


class DistributedQuery:
    """Execute a physical plan over a mesh of shards.

    As FusedQuery: one single-device discovery run fixes the data-dependent
    capacities, then every execute() walks the plan shard by shard on them,
    with the collectives at the distribution boundaries. Exchange overflow
    (skew) raises a device-side flag, read once per walk; the host then
    doubles the slot factor and walks again (see the module docstring).

    execute() returns the result on the mesh's first device: a partitioned
    result as the shard-major concatenation of the shards' relations (what
    the reference's sharded global array reads as), a replicated one as
    shard 0's. `shards` keeps the per-shard relations of the last walk and
    `out_dist` their distribution; `trace_stats` the walk's collectives."""

    def __init__(self, plan: PP.PhysicalPlan, mesh: Optional[Mesh] = None,
                 axis: str = "dp", options: Optional[dict] = None):
        self.plan = plan
        self.mesh = mesh if mesh is not None else make_mesh(axis=axis)
        self.axis = axis
        self.options = dict(options or {})
        self.leaves: List[PP.PhysicalPlan] = []
        self._collect_leaves(plan)
        self._discovered = False
        self._values: dict = {}  # expression values fixed after discovery
        self.slot_factor = int(self.options.get("slot_factor", 2))
        self.trace_stats: Dict[str, object] = {}
        self.shards: Optional[Shards] = None
        # provisional (before discovery); recomputed in execute() once the
        # joins' input capacities are known
        self.out_dist = dist_of(plan, options=self.options)

    def _collect_leaves(self, p: PP.PhysicalPlan):
        if isinstance(p, (PP.ScanExec, PP.ValuesExec, PP.EmptyExec)):
            if p not in self.leaves:
                self.leaves.append(p)
            return
        for c in p.children():
            self._collect_leaves(c)

    def join_modes(self) -> List[str]:
        """The mode of every JoinExec of the plan, in pre-order."""
        out, stack = [], [self.plan]
        while stack:
            p = stack.pop()
            if isinstance(p, PP.JoinExec):
                out.append(_join_mode(p, self.options))
            stack.extend(reversed(p.children()))
        return out

    def execute(self, ctx) -> DeviceRelation:
        if not self._discovered:
            self.plan.execute(ctx)  # capacity discovery (single device)
            self.out_dist = dist_of(self.plan, options=self.options)
            self._discovered = True
        while True:
            inputs = tuple(self._shard(leaf.execute(ctx)) for leaf in self.leaves)
            rels, dist, flag = self._walk(inputs)
            if flag is None or not bool(flag):  # the walk's one host read
                break
            n = self.mesh.n
            if self.slot_factor >= n:
                raise ExecutionError(
                    "exchange overflow at the overflow-proof slot bound")
            self.slot_factor = min(self.slot_factor * 2, n)
        self.shards, self.out_dist = rels, dist
        return self._result(rels, dist)

    def _shard(self, rel: DeviceRelation) -> Shards:
        """Contiguous row partitioning: the capacity padded to a multiple of
        n with dead rows, shard i taking the i-th slice, moved to its
        device (a view when it is already there)."""
        n = self.mesh.n
        cap = rel.capacity
        per = -(-cap // n)
        tensors = [rel.sel] + D.column_tensors(rel.columns)
        pad = per * n - cap
        if pad:
            tensors = [torch.cat([t, torch.zeros((pad,) + tuple(t.shape[1:]),
                                                 dtype=t.dtype, device=t.device)])
                       for t in tensors]
        out = []
        for i, dev in enumerate(self.mesh.shard_devices):
            ts = [t[i * per:(i + 1) * per].to(dev, non_blocking=True) for t in tensors]
            out.append(_rebuild(rel, ts[1:], ts[0]))
        return out

    def _walk(self, inputs):
        """(per-shard relations, their distribution, the overflow flag as a
        0-d tensor on the first device, or None without a guard)."""
        leaf_index = {id(l): i for i, l in enumerate(self.leaves)}
        dctx = _DCtx(self.mesh, self.options, self.slot_factor)
        # expression-level discovery state (string casts) applies the
        # discovered tables and reports through the same flags
        prev = EC.set_flag_sink(dctx.flags, self._values)
        try:
            rels, dist = _dtrace(self.plan, inputs, leaf_index, dctx)
        finally:
            EC.set_flag_sink(*prev)
        self.trace_stats = {"max_capacity": dctx.max_cap,
                            "exchanges": len(dctx.exchanges),
                            "exchange_max_capacity": max(dctx.exchanges, default=0),
                            "gathers": dctx.gathers, "flags": len(dctx.flags)}
        flag = None
        if dctx.flags:
            dev0 = self.mesh.shard_devices[0]
            flag = torch.stack([f.to(dev0, non_blocking=True) for f in dctx.flags]).any()
        return rels, dist, flag

    def _result(self, rels: Shards, dist: str) -> DeviceRelation:
        if dist == REPL:
            return rels[0]
        dev0 = self.mesh.shard_devices[0]
        leaves = [D.column_tensors(r.columns) for r in rels]
        cols = [torch.cat([lv[j].to(dev0, non_blocking=True) for lv in leaves])
                for j in range(len(leaves[0]))]
        sel = torch.cat([r.sel.to(dev0, non_blocking=True) for r in rels])
        return _rebuild(rels[0], cols, sel)


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> None:
    """Run TPC-H Q3 (join chain + grouped aggregate + top-k) through
    SessionContext.sql and DistributedQuery on a mesh of n_devices shards
    (over `devices`, default the visible CUDA devices): scans row-
    partitioned, build sides all_gather'ed, aggregation states exchanged,
    final sort replicated; then a customer JOIN orders aggregate with both
    join sides hash-exchanged (PartitionMode::Partitioned). Raises unless
    each equals the single-device engine's answer."""
    from ..context import SessionContext
    from ..data.device import to_host
    from ..models.tpch.datagen import generate_tpch
    from ..models.tpch.queries import query

    tables = generate_tpch(0.01)
    ctx = SessionContext(device=None if devices is None else devices[0])
    for name, t in tables.items():
        ctx.register_table(name, t)
    df = ctx.sql(query(3, 0.01))
    ref = df.collect()  # the single-device engine's answer

    mesh = make_mesh(n_devices, devices=devices)

    def check(options):
        dq = DistributedQuery(df.physical_plan(), mesh, options=options)
        ours = to_host(dq.execute(ctx.exec_context()))
        if ours.num_rows != ref.num_rows:
            raise ExecutionError(f"dryrun: {ours.num_rows} rows, want {ref.num_rows}")
        a, b = ours.to_pydict(), ref.to_pydict()
        for col in a:
            for x, y in zip(a[col], b[col]):
                bad = (abs(x - y) >= 1e-6 * max(1.0, abs(y)) if isinstance(x, float)
                       else x != y)
                if bad:
                    raise ExecutionError(f"dryrun: column {col}: {x!r} != {y!r}")

    # CollectLeft (broadcast build) on the whole Q3 plan
    check({})

    # PartitionMode::Partitioned (both sides hash-exchanged on the join keys)
    # on a compact join + aggregate
    df2 = ctx.sql(
        "SELECT c_mktsegment, count(*) c, sum(o_totalprice) s "
        "FROM customer JOIN orders ON c_custkey = o_custkey "
        "GROUP BY c_mktsegment")
    ref2 = df2.collect()
    dq2 = DistributedQuery(df2.physical_plan(), mesh,
                           options={"join_mode": "partitioned"})
    got = to_host(dq2.execute(ctx.exec_context())).to_pydict()
    want = ref2.to_pydict()
    key = sorted(zip(got["c_mktsegment"], got["c"]))
    if key != sorted(zip(want["c_mktsegment"], want["c"])):
        raise ExecutionError(f"dryrun: partitioned join answered {key}")
