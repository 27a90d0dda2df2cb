"""Whole-query execution: discovery, then a steady state replayed as one graph.

Port of datafusion_tpu/physical/fused.py. The reference traces the whole
physical plan into one jitted XLA program once the data-dependent capacities
are known; here the same steady state is captured into one
`torch.cuda.CUDAGraph` and replayed.

Two-phase adaptive execution, one FusedQuery per DataFrame:
  1. discovery (the first execute()): the plan runs operator by operator
     (physical/plan.py). Compactions, sorted aggregates and joins decide
     their capacities and paths with host reads and record them on their
     nodes (DISCOVERY_ATTRS).
  2. steady state (the second execute() builds it, later ones replay it):
     a walker (_trace) applies the recorded decisions without reading the
     host, and every decision appends a 0-d bool overflow flag (live rows
     past a compaction's capacity, groups past a sorted aggregate's, a
     group longer than an array_agg / string_agg list width, matches
     past a join's expansion, a duplicate key under a direct join,
     survivors past a window top-k's capacity, a live value missing from a
     string cast's value table). The
     flags reduce to one tensor on the device, read once per execute() (a
     plan without a guard reads nothing). On a CUDA device the steady
     state is run once on a side stream (which also copies every dictionary
     lookup table to the card) and captured under `torch.cuda.graph` with a
     private memory pool; each later execute() replays the graph and reads
     the one flag. On the CPU there is no graph: the walker runs eagerly on
     each call.
A raised flag sends the query back to discovery (capacities only grow), and
the next execute() builds the steady state anew. A plan holding an operator
the walker does not know keeps per-operator execution; a plan holding a
recursive query (holds_recursion) is marked so before any leaf of a steady
state runs. A plan that calls a host function (a scalar from
register_async_udf or a plugin: the reference calls it from inside its
program through jax.pure_callback, which a CUDA graph cannot hold) is
marked before capture, and its steady state is the walker run eagerly on
the card, as on the CPU. Any other failure while capturing (a host sync or
a pageable copy in the steady state) raises: it is a bug, never turned into
eager execution.

What a replay does not run: Python side effects of the operators. Tracing
spans and memory-pool accounting (`PhysicalPlan._timed`) are skipped by the
walker as in the reference; `JoinExec.path` and the dense kernel's launch
count are set at discovery and at capture, and a replay leaves them as they
are (the profiler sees the replayed kernels).

A graph reads its inputs at the addresses it was captured with. The leaves
(scans, VALUES and empty relations) run outside the graph; VALUES and empty
relations are made once per device and kept by their nodes. The leaf
relations a graph was captured on are kept, and every execute() compares their
tensors with the scans' current ones and captures again when they differ.
The lookup tables the graph reads are kept with it (expr_compiler.
hold_tables). Its outputs are packed into one buffer inside the graph and
copied out once per execute(), so a later replay never overwrites a
relation a caller holds.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..common.errors import ExecutionError, PlanError, QueryCancelled
from ..data.device import DeviceColumn, DeviceRelation
from ..ops import groupby as G
from ..runtime.context import ExecContext
from . import expr_compiler as EC
from . import plan as P
from .planner import AliasExec

_LEAF_PARTS = ("data", "validity", "lengths", "elem_valid")
_LEAVES = (P.ScanExec, P.ValuesExec, P.EmptyExec)
_ALIGN = 16  # bytes: every packed output starts on a 16-byte boundary


class _TraceCtx:
    def __init__(self):
        self.flags: List[torch.Tensor] = []  # each: 0-d bool, True = overflow
        # shared sub-plans (CTEs referenced more than once) are walked once
        self.memo: Dict[int, DeviceRelation] = {}


class FusedQuery:
    """Wraps a PhysicalPlan with discovery and a steady state."""

    def __init__(self, plan: P.PhysicalPlan):
        self.plan = plan
        self.leaves: List[P.PhysicalPlan] = []
        self._collect_leaves(plan, self.leaves)
        # None: no steady state; False: per-operator execution; else the
        # steady state (_Eager on the CPU, _Graph on a CUDA device)
        self._fused = None
        self._discovered = False
        self._hinted = False
        self.capture_ms: Optional[float] = None  # host ms of the last build

    def _collect_leaves(self, p: P.PhysicalPlan, out: List[P.PhysicalPlan]):
        if isinstance(p, _LEAVES):
            if p not in out:
                out.append(p)
            return
        for c in p.children():
            self._collect_leaves(c, out)

    # -- discovery hints ------------------------------------------------
    # The per-node discovery results, exported by one FusedQuery and planted
    # in another over the same plan shape, let the second skip discovery.
    # Stale hints are safe: every hinted quantity is guarded by an overflow
    # flag that forces a real discovery.
    DISCOVERY_ATTRS = {
        "CompactExec": ("_decision",),
        "AggregateExec": ("_last_cap", "_last_width"),
        "JoinExec": ("_direct_ok", "_last_co"),
        "WindowTopKExec": ("_last_cap",),
    }

    def _nodes_preorder(self):
        out = []

        def walk(p):
            out.append(p)
            for c in p.children():
                walk(c)

        walk(self.plan)
        return out

    def discovery_hints(self):
        """Picklable per-node discovery state (pre-order), or None before
        the plan has been discovered."""
        if not self._discovered:
            return None
        out = []
        for p in self._nodes_preorder():
            attrs = {}
            for a in self.DISCOVERY_ATTRS.get(type(p).__name__, ()):
                if hasattr(p, a):
                    attrs[a] = getattr(p, a)
            out.append((type(p).__name__, attrs))
        return out

    def plant_hints(self, hints) -> bool:
        """Install previously exported discovery state; True when the plan
        shape matches. The next execute() skips discovery."""
        nodes = self._nodes_preorder()
        if hints is None or len(nodes) != len(hints):
            return False
        if any(type(p).__name__ != t for p, (t, _) in zip(nodes, hints)):
            return False
        for p, (_, attrs) in zip(nodes, hints):
            for a, v in attrs.items():
                setattr(p, a, dict(v) if isinstance(v, dict) else v)
        self._fused = None
        self._discovered = self._hinted = True
        return True

    # ------------------------------------------------------------------
    def execute(self, ctx: ExecContext) -> DeviceRelation:
        if self._fused is None and not self._discovered:
            out = self.plan.execute(ctx)
            self._discovered = True
            return out
        if self._fused is None and holds_recursion(self.plan):
            self._fused = False  # decided before any leaf runs or capture starts
        if self._fused is False:
            return self.plan.execute(ctx)
        inputs = tuple(leaf.execute(ctx) for leaf in self.leaves)
        if self._fused is not None and self._fused.matches(inputs):
            rel, overflow = self._fused.run()
        else:
            self._fused = None  # free the old graph before capturing anew
            try:
                self._fused, (rel, overflow) = self._build(inputs)
            except (ExecutionError, PlanError) as e:
                if isinstance(e, QueryCancelled):
                    raise
                if self._hinted:  # incomplete hints: run the real discovery
                    self._hinted = self._discovered = False
                    return self.execute(ctx)
                self._fused = False  # not fusible: keep per-operator execution
                return self.plan.execute(ctx)
            self._hinted = False
        if overflow:
            # a discovered capacity or path no longer holds: rediscover
            self._fused = None
            self._discovered = False
            return self.execute(ctx)
        return rel

    def _build(self, inputs):
        """(steady state, (relation, overflow) of its first run)."""
        t0 = time.perf_counter()
        fn = self._steady_fn()
        if inputs and inputs[0].device.type == "cuda" and not calls_host(self.plan):
            steady = _Graph(fn, inputs)
        else:
            steady = _Eager(fn, inputs)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        return steady, steady.run()

    def _steady_fn(self):
        leaf_index = {id(leaf): i for i, leaf in enumerate(self.leaves)}
        values = {}  # fixed for the life of this steady state (the clock)

        def fn(inputs: Tuple[DeviceRelation, ...]):
            tctx = _TraceCtx()
            # expression-level discovery state (string casts) reports a
            # stale table through the same flags as the operators
            prev = EC.set_flag_sink(tctx.flags, values)
            try:
                rel = _trace(self.plan, inputs, leaf_index, tctx)
            finally:
                EC.set_flag_sink(*prev)
            # no overflow guard: no flag, and nothing to read. The reference
            # reads a result-dependent False there, to wait for the result on
            # a backend whose block_until_ready returns at once; here the host
            # copy of the result waits for it, one sync fewer
            flag = torch.stack(tctx.flags).any() if tctx.flags else None
            return rel, flag

        return fn


def holds_recursion(plan: P.PhysicalPlan) -> bool:
    """Whether the plan holds a RecursiveQueryExec. Its work-table scan runs
    only inside the recursion that binds it and its iteration count is read
    on the host, so such a plan keeps per-operator execution, as the
    reference's (whose fused build fails on the work-table scan)."""
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, P.RecursiveQueryExec):
            return True
        stack.extend(p.children())
    return False


def calls_host(plan: P.PhysicalPlan) -> bool:
    """Whether an expression of the plan calls a host function (a scalar
    UDF whose body is an expr.udf.HostCall) under the active registry."""
    from ..expr import nodes as E
    from ..expr.udf import active_registry, is_host_call

    reg = active_registry()

    def expr_calls(e) -> bool:
        if isinstance(e, E.ScalarFunction):
            udf = reg.scalar(e.fname)
            if udf is not None and is_host_call(udf):
                return True
        return any(expr_calls(c) for c in e.children())

    def held(v) -> bool:
        if isinstance(v, E.Expr):
            return expr_calls(v)
        if isinstance(v, (list, tuple)):
            return any(held(x) for x in v)
        return False

    stack = [plan]
    while stack:
        p = stack.pop()
        if any(held(v) for v in vars(p).values()):
            return True
        stack.extend(p.children())
    return False


def _leaf_key(inputs) -> tuple:
    """Addresses, shapes, dtypes and dictionaries of every scan tensor."""
    key = []
    for rel in inputs:
        key.append((rel.sel.data_ptr(), tuple(rel.sel.shape)))
        for c in rel.columns:
            key.append(id(c.dictionary))
            for part in _LEAF_PARTS:
                t = getattr(c, part)
                key.append(None if t is None else
                           (t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(key)


class _Eager:
    """The CPU steady state: the walker, run eagerly on each call."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs

    def matches(self, inputs) -> bool:
        self.inputs = inputs  # eager runs read the scans as they are
        return True

    def run(self):
        rel, flag = self.fn(self.inputs)
        return rel, flag is not None and bool(flag)


class _Graph:
    """The CUDA steady state: the walker captured into one CUDA graph."""

    def __init__(self, fn, inputs):
        self.inputs = inputs  # keeps the scan tensors the graph reads alive
        self.key = _leaf_key(inputs)
        self.held: List[torch.Tensor] = []  # lookup tables the graph reads
        prev = EC.hold_tables(self.held)
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(inputs)  # warm-up: lazy initialisation, lookup tables
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                rel, self.flag = fn(inputs)
                self.buffer, self.layout = _pack(rel)
        finally:
            EC.hold_tables(prev)
        self.template = rel

    def matches(self, inputs) -> bool:
        return _leaf_key(inputs) == self.key

    def run(self):
        self.graph.replay()
        out = self.buffer.clone()  # the caller's copy: the next replay rewrites
        # the steady state's one host sync, when it has overflow guards
        overflow = self.flag is not None and bool(self.flag)
        return _unpack(self.template, out, self.layout), overflow


def _relation_tensors(rel: DeviceRelation) -> List[Optional[torch.Tensor]]:
    out = [rel.sel]
    for c in rel.columns:
        out.extend(getattr(c, part) for part in _LEAF_PARTS)
    return out


def _pack(rel: DeviceRelation):
    """Every tensor of `rel` as bytes of ONE uint8 buffer, each at a 16-byte
    aligned offset; returns (buffer, layout)."""
    pieces, layout, off = [], [], 0
    for t in _relation_tensors(rel):
        if t is None:
            layout.append(None)
            continue
        flat = t.reshape(-1)
        if flat.numel() and flat.stride(0) != 1:  # e.g. a strided 1-element view
            flat = flat.clone(memory_format=torch.contiguous_format)
        raw = (flat.view(torch.uint8) if flat.numel()
               else torch.empty(0, dtype=torch.uint8, device=t.device))
        layout.append((off, raw.numel(), t.dtype, tuple(t.shape)))
        pieces.append(raw)
        pad = -raw.numel() % _ALIGN
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8, device=t.device))
        off += raw.numel() + pad
    return torch.cat(pieces), layout


def _unpack(template: DeviceRelation, buffer: torch.Tensor, layout) -> DeviceRelation:
    """The relation `template` describes, its tensors views into `buffer`."""
    tensors = [None if spec is None else
               buffer[spec[0]:spec[0] + spec[1]].view(spec[2]).view(spec[3])
               for spec in layout]
    sel, rest = tensors[0], tensors[1:]
    cols = []
    for i, c in enumerate(template.columns):
        data, validity, lengths, elem_valid = rest[4 * i:4 * i + 4]
        cols.append(DeviceColumn(data, validity, c.dtype, c.dictionary,
                                 c.bounds, lengths, elem_valid, c.meta))
    return DeviceRelation(template.schema, tuple(cols), sel)


# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------


def _trace(p: P.PhysicalPlan, inputs, leaf_index, tctx) -> DeviceRelation:
    hit = tctx.memo.get(id(p))
    if hit is not None:
        return hit
    out = _trace_inner(p, inputs, leaf_index, tctx)
    tctx.memo[id(p)] = out
    return out


def _trace_inner(p: P.PhysicalPlan, inputs, leaf_index, tctx) -> DeviceRelation:
    from .window import WindowExec, WindowTopKExec

    if isinstance(p, _LEAVES):
        return inputs[leaf_index[id(p)]]
    if isinstance(p, (P.FilterExec, P.ProjectionExec, P.LimitExec, P.SortExec,
                      P.DistinctExec, P.UnnestExec, WindowExec)):
        return p._transform(_trace(p.input, inputs, leaf_index, tctx))
    if isinstance(p, P.UnionExec):
        return p._transform([_trace(c, inputs, leaf_index, tctx) for c in p.inputs])
    if isinstance(p, WindowTopKExec):
        rel = _trace(p.input, inputs, leaf_index, tctx)
        cap = p._last_cap
        if cap is None:
            raise ExecutionError("window top-k capacity not discovered")
        perm, rank, keep = p._phase1(rel)
        tctx.flags.append(keep.sum() > cap)
        return p._apply(rel, perm, rank, keep, cap)
    if isinstance(p, P.CompactExec):
        rel = _trace(p.input, inputs, leaf_index, tctx)
        d = p._decision
        if d is None:
            raise ExecutionError("compaction capacity not discovered")
        if d[0] == "identity":
            return rel
        tctx.flags.append(rel.sel.sum() > d[1])
        return p._apply(rel, d[1])
    if isinstance(p, AliasExec):
        rel = _trace(p.input, inputs, leaf_index, tctx)
        return DeviceRelation(p.schema, rel.columns, rel.sel)
    if isinstance(p, P.AggregateExec):
        return apply_aggregate(p, _trace(p.input, inputs, leaf_index, tctx), tctx)
    if isinstance(p, P.JoinExec):
        swapped, _, _ = join_normalize(p)
        lplan, rplan = (p.right, p.left) if swapped else (p.left, p.right)
        lrel = _trace(lplan, inputs, leaf_index, tctx)
        rrel = _trace(rplan, inputs, leaf_index, tctx)
        return apply_join(p, lrel, rrel, tctx)
    raise ExecutionError(f"cannot fuse operator {type(p).__name__}")


def apply_aggregate(p: P.AggregateExec, rel: DeviceRelation,
                    tctx: Optional[_TraceCtx] = None,
                    cached: bool = True) -> DeviceRelation:
    """p's aggregation over an already-walked input with the capacity and
    list width discovery recorded; a sorted aggregate flags more groups than
    that, and array_agg / string_agg a list longer than the width (the live
    count for the global case, the largest group for the grouped one). The
    distributed engine passes no `tctx` where its input cannot pass the
    discovered sizes (its flags are dropped), and cached=False: its dense
    domains come from the relation at hand (AggregateExec._dense_sizes)."""
    if tctx is None:
        tctx = _TraceCtx()
    width = getattr(p, "_last_width", None) if p._has_array_agg() else 0
    if width is None:
        raise ExecutionError("list width not discovered")
    if not p.group_exprs:
        if width:
            tctx.flags.append(rel.sel.sum() > width)
        if p._global_dense_ok(rel):
            return p._dense_transform(rel, [], 1, True)
        return p._global(rel)
    dense = p._dense_sizes(rel, cached)
    if dense is not None:
        return p._dense_transform(rel, *dense)
    cap = getattr(p, "_last_cap", None)
    if cap is None:
        raise ExecutionError("aggregate capacity not discovered")
    states, specs = p._phase_sort(rel)
    tctx.flags.append(states[0][-1] > cap)
    if width:
        tctx.flags.append(G.max_group_size(states[0], cap) > width)
    return p._sorted_reduce(states, specs, cap)


def join_normalize(p: P.JoinExec):
    """(swapped, normalized join type, normalized on-pairs): RIGHT flavours
    are re-expressed as LEFT joins with the sides swapped."""
    from ..logical.plan import JoinType

    jt = p.join_type
    swapped = p._swapped()
    if swapped:
        jt = {JoinType.RIGHT: JoinType.LEFT, JoinType.RIGHT_SEMI: JoinType.LEFT_SEMI,
              JoinType.RIGHT_ANTI: JoinType.LEFT_ANTI}[jt]
    on = tuple((r, l) for l, r in p.on) if swapped else p.on
    return swapped, jt, on


def apply_join(p: P.JoinExec, lrel: DeviceRelation, rrel: DeviceRelation,
               tctx: Optional[_TraceCtx] = None,
               co_cap: Optional[int] = None) -> DeviceRelation:
    """p's join over already-walked (probe, build) relations, in normalized
    order (join_normalize), on the path and expansion capacity discovery
    recorded; flags a duplicate build key under a direct join and more
    matches than the capacity. `co_cap` bounds that capacity (the
    distributed engine's per-shard joins); without `tctx` the flags are
    dropped (a broadcast join's shard probes a subset of the rows discovery
    did, as in the reference)."""
    flags = tctx.flags if tctx is not None else []
    return p.execute_rels(lrel, rrel, flags=flags, co_cap=co_cap)
