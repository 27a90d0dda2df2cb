"""Physical operators.

Port of datafusion_tpu/physical/plan.py to eager torch execution. Operators
are whole-relation transforms over capacity-padded DeviceRelations: a filter
flips selection bits, a compaction gathers live rows to the front of a
smaller power-of-two capacity, and the grouped and global aggregates either
compute dense group ids arithmetically (summing every kernel-eligible
aggregate in one pass of the dense aggregation kernel, ops/dense_agg.py) or
sort rows by their group keys (ops/groupby.py).

Ported: ScanExec, FilterExec, ProjectionExec, LimitExec, SortExec (with
fetch = TopK, and the presorted elision), CompactExec, DistinctExec,
AggregateExec's global, dense and sort-based paths (ops/groupby.py),
JoinExec (every join type, residual filters; ops/joinimpl.py), UnionExec,
ValuesExec, EmptyExec, UnnestExec and RecursiveQueryExec. The window
operators are in physical/window.py.
Aggregates the kernel cannot take (min/max, filtered or DISTINCT aggregates,
float sums, order statistics, array_agg and string_agg) go through
ops/groupby._reduce_one.

Data-dependent output sizes take one host read each when an operator
executes (discovery): a compaction's live count, a sorted aggregate's group
count, an expanding join's match total, a direct-address join's
duplicate flag, and the list width of array_agg / string_agg (the next
power of two of the largest group's size: there is no lane count to pad
to on a GPU). The decision and its application are separate methods
(CompactExec._apply, AggregateExec._sorted_reduce, JoinExec.execute_rels
with `flags`), so that a steady state (physical/fused.py) applies the
discovered decisions without a host read and checks them with device-side
overflow flags instead.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as TF

from ..common import types as T
from ..common.errors import ExecutionError, PlanError
from ..common.schema import Field, Schema
from ..data.device import (DeviceColumn, DeviceRelation, bucket_capacity,
                           empty_relation, is_integer, resolve_device,
                           to_device, torch_dtype)
from ..expr import nodes as E
from ..logical.plan import JoinType
from ..ops import dense_agg as DA
from ..ops import groupby as G
from ..ops import joinimpl as J
from ..ops import kernels as K
from ..runtime.context import ExecContext
from .expr_compiler import eval_expr, eval_predicate, unify_string_columns


def _pow2(n: int) -> int:
    """The smallest power of two >= n (>= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _scatter_any(capacity: int, idx: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """out[i] = any(flags[j] for j with idx[j] == i); idx within range."""
    acc = torch.zeros(capacity, dtype=torch.int32, device=flags.device)
    return acc.index_add_(0, idx, flags.to(torch.int32)) > 0


def _dense_int_offset(c: DeviceColumn) -> Optional[int]:
    """Interval minimum of a bounds-proven integer group key (the rebase
    that makes it a dense code); None when the column is not a dense-int
    candidate (strings/bools/floats/unbounded)."""
    if c.dtype.is_string or c.dtype.kind is T.TypeKind.BOOL \
            or c.bounds is None or not is_integer(c.data):
        return None
    return int(c.bounds[0])


class PhysicalPlan:
    schema: Schema

    def children(self) -> Tuple["PhysicalPlan", ...]:
        return ()

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        raise NotImplementedError

    def _timed(self, ctx: ExecContext, fn, *args):
        """Run one operator step, recording its host time (on a CUDA device:
        the time to enqueue its kernels) and the device bytes it holds."""
        from ..runtime.tracing import TRACER

        ctx.check_cancelled()
        t0 = time.perf_counter()
        with TRACER.span(self._line()):
            out = fn(*args)
        name = type(self).__name__
        ctx.metric(name).record(0, time.perf_counter() - t0)
        if isinstance(out, DeviceRelation):
            from ..runtime.memory import relation_bytes

            new = relation_bytes(out)
            prev = getattr(self, "_reserved_bytes", 0)
            if new > prev:
                ctx.memory_pool.try_grow(name, new - prev)
            else:
                ctx.memory_pool.shrink(name, prev - new)
            self._reserved_bytes = new
        return out

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        return "\n".join([pad + self._line()] + [c.display(indent + 1) for c in self.children()])

    def _line(self) -> str:
        return type(self).__name__


class ScanExec(PhysicalPlan):
    def __init__(self, provider, schema: Schema, projection: Optional[List[str]],
                 alias: str, filters: Tuple[E.Expr, ...] = ()):
        self.provider = provider
        self.schema = schema
        self.projection = projection
        self.alias = alias
        self.filters = tuple(filters)  # pushed-down pruning hints (inexact)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        rel = self.provider.scan_device(
            ctx, filters=self.filters + self._topk_filters(),
            projection=self.projection)
        # select/rename columns to match the (qualified, possibly projected) schema
        src = {f.name: c for f, c in zip(rel.schema.fields, rel.columns)}
        cols = [src[f.name] for f in self.schema.fields]
        return DeviceRelation(self.schema, tuple(cols), rel.sel)

    def _topk_filters(self) -> tuple:
        """Dynamic-filter pushdown: when a TopK sits directly above this scan
        (the planner attaches `_topk_hint`), the k-th key value -- computed
        once on the host from the key column alone -- becomes a range
        predicate that prunes row groups and pages before the full read
        (reference: TopK -> DynamicFilterPhysicalExpr -> scan,
        physical-plan/src/topk/mod.rs:113 + sorts/sort.rs:930). Inclusive
        bounds keep every tie, so pruning stays exact."""
        hint = getattr(self, "_topk_hint", None)
        if hint is None or self.filters:
            return ()
        cached = getattr(self, "_topk_cache", None)
        if cached is not None:
            return cached
        col, k, desc = hint
        out = ()
        ds = getattr(self.provider, "_ds", None)
        try:
            if ds is not None:
                st = ds.column_stats().get(col)
                # NULL keys may sort into the top k: bail unless null-free
                if st is not None and st.null_count == 0:
                    import numpy as np

                    arr = ds.read((), columns=[col]).column(col).to_numpy()
                    if arr.dtype.kind in "if" and len(arr) > k:
                        if desc:
                            t = arr[np.argpartition(arr, len(arr) - k)[len(arr) - k]]
                            op = E.Op.GE
                        else:
                            t = arr[np.argpartition(arr, k - 1)[k - 1]]
                            op = E.Op.LE
                        v = float(t) if arr.dtype.kind == "f" else int(t)
                        out = (E.BinaryOp(op, E.Column(col), E.lit(v)),)
        except Exception:  # noqa: BLE001 -- pruning is best-effort
            out = ()
        self._topk_cache = out
        return out

    def _line(self):
        f = f" pushdown={len(self.filters)}" if self.filters else ""
        h = " topk" if getattr(self, "_topk_hint", None) else ""
        return f"ScanExec: {self.alias}{f}{h}"


class FilterExec(PhysicalPlan):
    def __init__(self, input: PhysicalPlan, predicate: E.Expr):
        self.input = input
        self.predicate = predicate
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        return rel.with_sel(rel.sel & eval_predicate(self.predicate, rel))

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        return f"FilterExec: {self.predicate.name()}"


class ProjectionExec(PhysicalPlan):
    def __init__(self, input: PhysicalPlan, exprs: Sequence[E.Expr], schema: Schema):
        self.input = input
        self.exprs = tuple(exprs)
        self.schema = schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        cols = [eval_expr(e, rel) for e in self.exprs]
        return DeviceRelation(self.schema, tuple(cols), rel.sel)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        return f"ProjectionExec: {[e.name() for e in self.exprs]}"


class LimitExec(PhysicalPlan):
    def __init__(self, input: PhysicalPlan, skip: int = 0, fetch: Optional[int] = None):
        self.input = input
        self.skip = skip
        self.fetch = fetch
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        rank = torch.cumsum(rel.sel, 0, dtype=torch.int64)
        keep = rel.sel & (rank > self.skip)
        if self.fetch is not None:
            keep = keep & (rank <= self.skip + self.fetch)
        return rel.with_sel(keep)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        return f"LimitExec: skip={self.skip} fetch={self.fetch}"


def _column_leaves(c: DeviceColumn) -> Dict[str, torch.Tensor]:
    return {k: getattr(c, k) for k in ("data", "validity", "lengths", "elem_valid")
            if getattr(c, k) is not None}


def _with_leaves(c: DeviceColumn, leaves: Dict[str, torch.Tensor]) -> DeviceColumn:
    return DeviceColumn(leaves["data"], leaves.get("validity"), c.dtype,
                        c.dictionary, c.bounds, leaves.get("lengths"),
                        leaves.get("elem_valid"), c.meta)


class SortExec(PhysicalPlan):
    """Full multi-key sort; with fetch this is the TopK operator.
    presorted=True marks a sort whose input already emits the requested order
    (physical/ordering.py): it degenerates to identity / a rank-mask limit."""

    def __init__(self, input: PhysicalPlan, specs: Sequence[E.SortSpec],
                 fetch: Optional[int] = None, presorted: bool = False):
        self.input = input
        self.specs = tuple(specs)
        self.fetch = fetch
        self.presorted = presorted
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        if self.presorted:
            if self.fetch is None:
                return rel
            rank = torch.cumsum(rel.sel, 0, dtype=torch.int64)
            return rel.with_sel(rel.sel & (rank <= self.fetch))
        return self._transform_full(rel)

    def _transform_full(self, rel: DeviceRelation) -> DeviceRelation:
        """The sort itself, presorted or not: the chunked executor's inputs
        arrive chunk after chunk and are never globally ordered."""
        keys = []
        for s in self.specs:
            c = eval_expr(s.expr, rel)
            keys.append((c.data, c.validity, not s.asc, s.nulls_first,
                         c.sort_bounds()))
        perm = K.sort_permutation(keys, rel.sel)
        cols = [_with_leaves(c, {k: v[perm] for k, v in _column_leaves(c).items()})
                for c in rel.columns]
        ssel = rel.sel[perm]
        if self.fetch is not None:
            ssel = ssel & (torch.arange(rel.capacity, device=rel.device) < self.fetch)
        return DeviceRelation(self.schema, tuple(cols), ssel)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        keys = ", ".join(f"{s.expr.name()} {'ASC' if s.asc else 'DESC'}" for s in self.specs)
        pre = " (presorted)" if self.presorted else ""
        return f"SortExec: [{keys}] fetch={self.fetch}{pre}"


class CompactExec(PhysicalPlan):
    """Gather live rows to the front and truncate to a power-of-two capacity
    (the selection-mask model's analog of CoalesceBatchesExec). It stays an
    identity when the input is already more than 1/4 live, or small."""

    def __init__(self, input: PhysicalPlan):
        self.input = input
        self.schema = input.schema
        self._decision = None  # None | ("identity",) | ("compact", cap)

    def children(self):
        return (self.input,)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        rel = self.input.execute(ctx)
        live = int(rel.sel.sum())  # one host sync decides the capacity
        cap = bucket_capacity(max(live, 1))
        prev = self._decision
        if prev is not None and prev[0] == "compact":
            cap = max(cap, prev[1])
        if cap * 4 > rel.capacity or rel.capacity <= (1 << 15):
            self._decision = ("identity",)
            return rel
        self._decision = ("compact", cap)
        return self._timed(ctx, self._apply, rel, cap)

    def _apply(self, rel: DeviceRelation, cap: int) -> DeviceRelation:
        idx, total = K.compaction_indices(rel.sel, cap)
        cols = [_with_leaves(c, {k: v[idx] for k, v in _column_leaves(c).items()})
                for c in rel.columns]
        sel = torch.arange(cap, device=rel.device) < torch.clamp(total, max=cap)
        return DeviceRelation(self.schema, tuple(cols), sel)

    def _line(self):
        d = self._decision
        tag = "?" if d is None else (d[0] if d[0] == "identity" else f"cap={d[1]}")
        return f"CompactExec: {tag}"


class AggregateExec(PhysicalPlan):
    """Grouped / global aggregation (reference: AggregateExec,
    physical-plan/src/aggregates/mod.rs:828). The dense path covers GROUP BY
    keys with a small static domain (dictionary codes, bools, bounds-proven
    small integer ranges): group ids are computed arithmetically, every
    sum/avg/count that factors into int32-bounded columns goes through one
    dense_groupby_sums pass, and the other aggregates through
    ops/groupby._reduce_one. Any other GROUP BY sorts rows by their keys
    (ops/groupby.py)."""

    DENSE_LIMIT = 16384

    def __init__(self, input: PhysicalPlan, group_exprs: Sequence[E.Expr],
                 agg_exprs: Sequence[E.Expr], schema: Schema):
        self.input = input
        self.group_exprs = tuple(group_exprs)
        self.agg_exprs = tuple(agg_exprs)  # Alias(AggregateFunction) | AggregateFunction
        self.schema = schema

    def children(self):
        return (self.input,)

    def _agg_fns(self) -> List[E.AggregateFunction]:
        out = []
        for e in self.agg_exprs:
            a = e.expr if isinstance(e, E.Alias) else e
            if not isinstance(a, E.AggregateFunction):
                raise PlanError(f"aggregate expr must be an aggregate function: {e!r}")
            out.append(a)
        return out

    def _has_array_agg(self) -> bool:
        return any(a.fname in ("array_agg", "string_agg") for a in self._agg_fns())

    def _widen(self, width: int) -> None:
        """Record a discovered list width; it only grows across runs."""
        self._last_width = max(_pow2(width), getattr(self, "_last_width", 0))

    def _prepare(self, rel: DeviceRelation):
        """Evaluate group keys, agg args, filters; build AggSpecs."""
        from ..expr.typing import infer

        group_cols = [eval_expr(g, rel) for g in self.group_exprs]
        arg_cols: List[DeviceColumn] = []
        filter_cols: List[torch.Tensor] = []
        specs: List[G.AggSpec] = []
        arg_index: Dict = {}
        for a in self._agg_fns():
            fname = a.fname
            out_dtype, _ = infer(a, rel.schema)
            extra = None
            if fname == "count" and not a.distinct and (
                    len(a.args) == 0
                    or (isinstance(a.args[0], E.Literal)
                        and a.args[0].value is not None)):
                # count(<non-null literal>) == count(*); count(NULL) is 0 and
                # must go through the null-skipping argument path
                arg_i, fname, arg_dt = None, "count_star", None
            else:
                two_arg = fname in ("corr", "covar", "covar_pop",
                                    "covar_samp") or fname.startswith("regr_")
                key = a.args[0]
                arg_i = arg_index.get(key)
                if arg_i is None or two_arg:
                    arg = eval_expr(a.args[0], rel)
                    arg_i = len(arg_cols)
                    arg_cols.append(arg)
                    if not two_arg:
                        arg_index[key] = arg_i
                else:
                    arg = arg_cols[arg_i]
                arg_dt = arg.dtype
                if two_arg and len(a.args) > 1:
                    arg_cols.append(eval_expr(a.args[1], rel))  # y at arg_i + 1
                if fname in ("percentile_cont", "approx_percentile_cont") \
                        and len(a.args) > 1 and isinstance(a.args[1], E.Literal):
                    extra = float(a.args[1].value)
                if fname == "nth_value":
                    if len(a.args) < 2 or not isinstance(a.args[1], E.Literal):
                        raise PlanError("nth_value requires a literal n")
                    extra = float(a.args[1].value)
                if fname == "array_agg":  # the list width discovery found
                    extra = getattr(self, "_last_width", None)
                if fname == "string_agg":
                    delim = ","
                    if len(a.args) > 1 and isinstance(a.args[1], E.Literal) \
                            and a.args[1].value is not None:
                        delim = str(a.args[1].value)
                    extra = (delim, getattr(self, "_last_width", None) or 0)
            filt_i = None
            if a.filter is not None:
                filt_i = len(filter_cols)
                filter_cols.append(eval_predicate(a.filter, rel))
            order_arg = None
            order_desc = False
            aorder = getattr(a, "order_by", ())
            if aorder:
                # agg(x ORDER BY y [DESC]): the order expression rides the
                # arg column list and keys this spec's sort bucket
                if len(aorder) > 1:
                    raise PlanError(
                        "aggregate ORDER BY supports a single sort key")
                if a.distinct:
                    # reference rule: DISTINCT requires order == argument
                    if aorder[0].expr != a.args[0] or not aorder[0].asc:
                        raise PlanError(
                            "DISTINCT aggregate ORDER BY must match the "
                            "argument (ascending)")
                elif fname in ("array_agg", "string_agg", "first_value",
                               "last_value", "any_value", "nth_value"):
                    order_arg = len(arg_cols)
                    arg_cols.append(eval_expr(aorder[0].expr, rel))
                    order_desc = not aorder[0].asc
                # order-insensitive aggregates: ORDER BY is a no-op
            specs.append(G.AggSpec(fname, arg_i, a.distinct, out_dtype,
                                   arg_dt, filt_i, extra, order_arg,
                                   order_desc,
                                   getattr(a, "ignore_nulls", False)))
        return group_cols, arg_cols, filter_cols, specs

    def _phase_sort(self, rel: DeviceRelation):
        """(one sorted state per order-arg bucket, the specs): each DISTINCT
        or order-statistic argument sorts by (keys, its arg); the group
        segmentation is identical across buckets."""
        group_cols, arg_cols, filter_cols, specs = self._prepare(rel)
        return (G.phase_sort_multi(group_cols, arg_cols, filter_cols, rel.sel,
                                   specs), specs)

    def _dense_eligible(self) -> bool:
        """The dense and global-dense paths take no DISTINCT, order-sensitive
        or scan-based aggregate, and no aggregate UDF (its monoid scan needs
        the sorted path's segments): the kernel is never handed one."""
        from ..expr.udf import active_registry

        reg = active_registry()
        return not any(a.distinct or a.fname in G._ORDER_SENSITIVE
                       or a.fname in G.DENSE_UNSUPPORTED
                       or getattr(a, "order_by", ())
                       or reg.aggregate(a.fname) is not None
                       for a in self._agg_fns())

    def _global_dense_ok(self, rel: DeviceRelation) -> bool:
        """A no-GROUP-BY aggregate takes the one-group kernel path when some
        sum/avg argument factors into int32-bounded columns. Decided once per
        plan from static metadata, by evaluating the arguments eagerly once."""
        cached = getattr(self, "_global_dense", None)
        if cached is None:
            cached = self._dense_eligible() and any(
                afn.fname in ("sum", "avg") and afn.args
                and self._i32_factors(afn.args[0], rel) is not None
                for afn in self._agg_fns())
            self._global_dense = cached
        return cached

    def _global(self, rel: DeviceRelation) -> DeviceRelation:
        _, arg_cols, filter_cols, specs = self._prepare(rel)
        outs, out_sel = G.global_aggregate(arg_cols, filter_cols, rel.sel,
                                           specs, 128)
        cols = [self._coerce_out(c, f) for c, f in zip(outs, self.schema.fields)]
        return DeviceRelation(self.schema, tuple(cols), out_sel)

    @staticmethod
    def _coerce_out(c: DeviceColumn, f: Field) -> DeviceColumn:
        data = c.data
        if c.dtype != f.dtype and data.dtype != torch_dtype(f.dtype):
            data = data.to(torch_dtype(f.dtype))
        return DeviceColumn(data, c.validity, f.dtype, c.dictionary,
                            c.bounds, c.lengths, c.elem_valid, c.meta)

    def _dense_sizes(self, rel: DeviceRelation, cached: bool = True):
        """(per-key domain sizes, their product) when every group key has a
        small static domain, else None. Cached on the node: the keys'
        dictionaries and bounds are static metadata of the plan's inputs.
        With cached=False it is computed from `rel` and not kept: the
        distributed engine's exchanged relations carry bounds widened to
        take 0 (parallel/distributed.columns_like)."""
        if not cached:
            return self._dense_domain(rel)
        hit = getattr(self, "_dense", False)
        if hit is not False:
            return hit
        self._dense = self._dense_domain(rel)
        return self._dense

    def _dense_domain(self, rel: DeviceRelation):
        if not self._dense_eligible():
            return None
        sizes = []
        for g in self.group_exprs:
            c = eval_expr(g, rel)
            if c.validity is not None:
                return None
            if c.dtype.is_string and c.dictionary is not None:
                sizes.append(max(c.dictionary.size, 1))
            elif c.dtype.kind is T.TypeKind.BOOL:
                sizes.append(2)
            elif _dense_int_offset(c) is not None:
                lo, hi = int(c.bounds[0]), int(c.bounds[1])
                if hi - lo + 1 <= 0:
                    return None
                sizes.append(hi - lo + 1)
            else:
                return None
        total = 1
        for s in sizes:
            total *= s
        if sizes and total <= self.DENSE_LIMIT:
            return sizes, total
        return None

    def _i32_factors(self, e_arg, rel):
        """Express an aggregate argument as a product of <=2 columns whose
        static bounds fit int32 (what the dense kernel takes exactly).
        Returns (a, b_or_None) DeviceColumns or None."""
        c = eval_expr(e_arg, rel)
        if not (c.dtype.is_decimal or c.dtype.is_integer) or c.validity is not None:
            return None
        if c.fits_i32():
            return (c, None)
        ea = e_arg.expr if isinstance(e_arg, E.Alias) else e_arg
        if isinstance(ea, E.BinaryOp) and ea.op is E.Op.MUL:
            l = eval_expr(ea.left, rel)
            r = eval_expr(ea.right, rel)
            if (l.dtype.is_decimal or l.dtype.is_integer) and \
                    (r.dtype.is_decimal or r.dtype.is_integer):
                if l.fits_i32() and r.fits_i32():
                    return (l, r)
                lf = self._i32_factors(ea.left, rel)
                if lf is not None and lf[1] is None and r.fits_i32():
                    return (lf[0], r)
                rf = self._i32_factors(ea.right, rel)
                if rf is not None and rf[1] is None and l.fits_i32():
                    return (l, rf[0])
        return None

    @staticmethod
    def dense_seg(group_cols, sel, sizes, ngroups):
        """Arithmetic dense group ids from small-domain key codes; dead rows
        map to the out-of-range id `ngroups`. Returns (seg, strides)."""
        seg = torch.zeros(sel.shape[0], dtype=torch.int32, device=sel.device)
        strides = []
        stride = 1
        for c, size in zip(reversed(group_cols), reversed(sizes)):
            strides.append(stride)
            code = c.data.to(torch.int32)
            off = _dense_int_offset(c)
            if off:
                code = code - off
            seg = seg + code * stride
            stride *= size
        strides = list(reversed(strides))
        return torch.where(sel, seg, ngroups).to(torch.int32), strides

    @staticmethod
    def dense_keys(group_cols, sizes, strides, ngroups):
        """Decode group key columns from the dense group-id enumeration."""
        if not group_cols:
            return []
        iota_g = torch.arange(ngroups, dtype=torch.int32,
                              device=group_cols[0].data.device)
        out_keys = []
        for c, size, st in zip(group_cols, sizes, strides):
            code = (iota_g // st) % size
            if c.dtype.kind is T.TypeKind.BOOL:
                data = code > 0
                b = None
            else:
                data = code.to(c.data.dtype)
                off = _dense_int_offset(c)
                if off:
                    data = data + off
                b = (int(off or 0), int(off or 0) + int(size) - 1)
            out_keys.append(DeviceColumn(data, None, c.dtype, c.dictionary,
                                         bounds=b))
        return out_keys

    @staticmethod
    def _kernel_factor(c: DeviceColumn) -> torch.Tensor:
        """A factor column as the kernel reads it: int32 or int64 as stored,
        narrower integer and bool codes widened to int32."""
        d = c.data
        return d if d.dtype in (torch.int32, torch.int64) else d.to(torch.int32)

    def _dense_transform(self, rel: DeviceRelation, sizes, ngroups,
                         global_one_row=False) -> DeviceRelation:
        group_cols, arg_cols, filter_cols, specs = self._prepare(rel)
        seg, strides = self.dense_seg(group_cols, rel.sel, sizes, ngroups)

        pairs = []
        slots = {}  # spec index -> ("count", None) | (fname, pair index)
        for i, (spec, afn) in enumerate(zip(specs, self._agg_fns())):
            if spec.filter is not None or spec.distinct:
                continue
            if spec.fname in ("count", "count_star"):
                if spec.arg is None or arg_cols[spec.arg].validity is None:
                    slots[i] = ("count", None)
                continue
            if spec.fname in ("sum", "avg") and afn.args:
                fac = self._i32_factors(afn.args[0], rel)
                if fac is not None:
                    slots[i] = (spec.fname, len(pairs))
                    pairs.append((self._kernel_factor(fac[0]),
                                  None if fac[1] is None
                                  else self._kernel_factor(fac[1])))

        if slots:
            # the kernel takes at most MAX_PAIRS pairs a launch (ClickBench
            # q29 sums 90 columns): one launch per chunk, the same counts
            chunks = [pairs[i:i + DA.MAX_PAIRS]
                      for i in range(0, len(pairs), DA.MAX_PAIRS)] or [[]]
            parts = [DA.dense_groupby_sums(seg, rel.sel, c, ngroups) for c in chunks]
            counts = parts[0][1]
            sums = parts[0][0] if len(parts) == 1 else torch.cat([p[0] for p in parts], 1)
        else:  # no aggregate the kernel takes: counts for out_sel only
            counts = K.segment_count(seg, rel.sel, ngroups)
        # a global (no GROUP BY) aggregate emits its one row even over empty
        # input (count=0, sums NULL) -- SQL semantics, unlike grouped output
        out_sel = (torch.ones(1, dtype=torch.bool, device=rel.device)
                   if global_one_row else counts > 0)
        has_rows = (counts > 0) & out_sel
        out_keys = self.dense_keys(group_cols, sizes, strides, ngroups)
        is_start = torch.zeros(rel.capacity, dtype=torch.bool, device=rel.device)
        out_aggs = []
        for i, spec in enumerate(specs):
            if i not in slots:
                # the general reduction over the dense ids (scatters)
                out_aggs.append(G._reduce_one(
                    spec, arg_cols, filter_cols, rel.sel, seg, is_start, None,
                    ngroups, counts, out_sel))
                continue
            kind, j = slots[i]
            if kind == "count":
                out_aggs.append(DeviceColumn(counts, None, T.INT64))
                continue
            ssum = sums[:, j]
            if kind == "sum":
                out_aggs.append(DeviceColumn(ssum, has_rows, spec.out_dtype))
                continue
            # avg: exact int64 sum / count in float64
            arg = arg_cols[spec.arg]
            cntf = torch.clamp(counts, min=1).to(torch.float64)
            if arg.dtype.is_decimal and spec.out_dtype.is_decimal:
                num = ssum.to(torch.float64) * (
                    10.0 ** (spec.out_dtype.scale - arg.dtype.scale))
                out_aggs.append(DeviceColumn(torch.trunc(num / cntf).to(torch.int64),
                                             has_rows, spec.out_dtype))
                continue
            scale = 10.0 ** arg.dtype.scale if arg.dtype.is_decimal else 1.0
            a = (ssum.to(torch.float64) / scale) / cntf
            out_aggs.append(DeviceColumn(a, has_rows, T.FLOAT64))
        cols = [self._coerce_out(c, f)
                for c, f in zip(out_keys + out_aggs, self.schema.fields)]
        return DeviceRelation(self.schema, tuple(cols), out_sel)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self.execute_rel(ctx, self.input.execute(ctx))

    def execute_rel(self, ctx: ExecContext, rel: DeviceRelation) -> DeviceRelation:
        """Aggregate an already-computed input relation (execute(), and the
        chunked executor's materialized fallback)."""
        if not self.group_exprs:
            if self._has_array_agg():
                self._widen(int(rel.sel.sum()))  # one host read: the list width
            if self._global_dense_ok(rel):
                return self._timed(ctx, self._dense_transform, rel, [], 1, True)
            return self._timed(ctx, self._global, rel)
        dense = self._dense_sizes(rel)
        if dense is not None:
            sizes, ngroups = dense
            return self._timed(ctx, self._dense_transform, rel, sizes, ngroups)
        return self._timed(ctx, self._sorted, rel)

    def _sorted(self, rel: DeviceRelation) -> DeviceRelation:
        """The sort path: one host read of the group count sizes the output;
        the capacity bucket only grows across runs of this plan."""
        states, specs = self._phase_sort(rel)
        num_groups = int(states[0][-1])
        cap = max(bucket_capacity(max(num_groups, 1)), getattr(self, "_last_cap", 0))
        self._last_cap = cap
        if self._has_array_agg():
            # a second host read: the largest group sizes the list width
            self._widen(int(G.max_group_size(states[0], cap)))
            specs = self._with_width(specs)
        return self._sorted_reduce(states, specs, cap)

    def _with_width(self, specs):
        """specs with the list width recorded since they were made."""
        import dataclasses

        w = self._last_width
        return [dataclasses.replace(s, extra=w) if s.fname == "array_agg" else
                dataclasses.replace(s, extra=(s.extra[0], w)) if s.fname == "string_agg"
                else s for s in specs]

    def _sorted_reduce(self, states, specs, cap: int) -> DeviceRelation:
        """The sort path's reduction into `cap` output slots (groups past
        `cap` are dropped: callers size it from the group count)."""
        out_keys, out_aggs, out_sel = G.phase_reduce_multi(states, specs, cap)
        cols = [self._coerce_out(c, f)
                for c, f in zip(list(out_keys) + list(out_aggs), self.schema.fields)]
        return DeviceRelation(self.schema, tuple(cols), out_sel)

    def _line(self):
        return (f"AggregateExec: group=[{', '.join(e.name() for e in self.group_exprs)}] "
                f"aggs=[{', '.join(e.name() for e in self.agg_exprs)}]")


class DistinctExec(PhysicalPlan):
    """SELECT DISTINCT: sort rows by every column; the first row of each run
    survives. Emits rows ascending by its columns, NULLs last."""

    def __init__(self, input: PhysicalPlan):
        self.input = input
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        keys = [(c.data, c.validity, False, False, c.sort_bounds())
                for c in rel.columns]
        payload = []
        for c in rel.columns:
            payload.append(c.data)
            if c.validity is not None:
                payload.append(c.validity)
        sorted_payload, ssel = K.sort_rows(keys, payload, rel.sel)
        cols = []
        it = iter(sorted_payload)
        for c in rel.columns:
            data = next(it)
            validity = next(it) if c.validity is not None else None
            cols.append(DeviceColumn(data, validity, c.dtype, c.dictionary))
        _, is_start, _ = K.segments_from_sorted_keys(
            [c.data for c in cols], [c.validity for c in cols], ssel)
        return DeviceRelation(self.schema, tuple(cols), is_start)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))


def unified_keys(on, lrel: DeviceRelation, rrel: DeviceRelation):
    """The join key columns of both sides, (probe keys, build keys), each
    string key pair on one dictionary: equal strings get equal codes, so
    they join, and hash to one shard when both sides are exchanged."""
    lkeys = [eval_expr(l, lrel) for l, _ in on]
    rkeys = [eval_expr(r, rrel) for _, r in on]
    for i in range(len(lkeys)):
        if lkeys[i].dtype.is_string or rkeys[i].dtype.is_string:
            lkeys[i], rkeys[i] = unify_string_columns(lkeys[i], rkeys[i])
    return lkeys, rkeys


class JoinExec(PhysicalPlan):
    """Equi-join (+ residual filter) for every join type; see
    ops/joinimpl.py. RIGHT flavours run as the mirrored LEFT ones (probe =
    the right input). Each execution takes one path, kept in `self.path`:
      direct           -- INNER/LEFT over a proven-dense key domain whose
                          build side has unique keys (one host read of the
                          duplicate flag);
      sort-merge       -- phase 1 counts matches, one host read of their
                          total sizes the expansion; `direct-dup` first when
                          the direct attempt found duplicate build keys;
      range            -- the same expansion over a single-inequality match;
      semi-direct      -- SEMI/ANTI existence bitmap over a dense domain;
      minmax           -- SEMI/ANTI whose residual is one comparison, as a
                          per-key min/max over a dense domain;
      semi-sort-merge / semi-range -- SEMI/ANTI from phase-1 counts.
    Other filtered SEMI/ANTI joins expand (sort-merge / range)."""

    _RANGE_MIRROR = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
    _MINMAX_OPS = {E.Op.LT: "lt", E.Op.LE: "le", E.Op.GT: "gt",
                   E.Op.GE: "ge", E.Op.NEQ: "neq"}
    _MINMAX_MIRROR = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le",
                      "neq": "neq"}
    DIRECT_DOMAIN_LIMIT = 1 << 26  # max direct-address table slots

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 on: Sequence[Tuple[E.Expr, E.Expr]], join_type: JoinType,
                 filter: Optional[E.Expr], schema: Schema,
                 range_on: Optional[Tuple[E.Expr, E.Expr, str]] = None):
        self.left = left
        self.right = right
        self.on = tuple(on)
        self.join_type = join_type
        self.filter = filter
        self.schema = schema
        # single range predicate `left_expr OP right_expr` driving the
        # piecewise merge path (ops/joinimpl.range_join_phase1)
        self.range_on = range_on
        self._last_co = 0  # expansion capacity: only grows across runs
        # direct-address state: info -> build side had unique keys when
        # last tried (a False skips the attempt afterwards)
        self._direct_ok: Dict = {}
        self.path: Optional[str] = None

    def children(self):
        return (self.left, self.right)

    def _swapped(self) -> bool:
        return self.join_type in (JoinType.RIGHT, JoinType.RIGHT_SEMI,
                                  JoinType.RIGHT_ANTI)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        lplan, rplan = ((self.right, self.left) if self._swapped()
                        else (self.left, self.right))
        lrel = lplan.execute(ctx)
        rrel = rplan.execute(ctx)
        return self._timed(ctx, self.execute_rels, lrel, rrel)

    def execute_rels(self, lrel: DeviceRelation, rrel: DeviceRelation,
                     flags: Optional[list] = None,
                     direct_bytes: Optional[int] = None,
                     co_cap: Optional[int] = None) -> DeviceRelation:
        """Run the join over (probe, build) relations, probe = left after
        RIGHT-flavour mirroring. With `flags` (a steady state,
        physical/fused.py) no host read is made: the path and capacity
        discovered by earlier runs are applied, and a 0-d bool tensor that is
        True when they no longer hold is appended to `flags`.
        `direct_bytes` caps the table of a direct-address path (the key
        domain sizes it, not the inputs: a bool a slot for semi-direct, 20
        bytes for minmax, 8 for direct); a path whose table would pass it
        is not taken. The chunked executor, which bounds what sits on the
        card by its budget, passes one. `co_cap` (with `flags`) bounds the
        expansion capacity below the discovered one: the distributed engine's
        per-shard outputs are about n times smaller, and the flag guards
        the bound. Each run outside a steady state records the (probe,
        build) capacities in `_last_input_caps`, which the distributed
        engine's CollectLeft-or-Partitioned choice reads."""
        if flags is None:
            self._last_input_caps = (lrel.capacity, rrel.capacity)
        jt = self.join_type
        swapped = self._swapped()
        if swapped:
            jt = {JoinType.RIGHT: JoinType.LEFT,
                  JoinType.RIGHT_SEMI: JoinType.LEFT_SEMI,
                  JoinType.RIGHT_ANTI: JoinType.LEFT_ANTI}[jt]
        on = tuple((r, l) for l, r in self.on) if swapped else self.on
        rng = self.range_on
        if swapped and rng is not None:
            rng = (rng[1], rng[0], self._RANGE_MIRROR[rng[2]])
        keys = info = None
        if rng is None:
            keys = unified_keys(on, lrel, rrel)
            if on:
                info = J.direct_domain(keys[0], keys[1], self.DIRECT_DOMAIN_LIMIT)

        def within(slot_bytes):
            """info, when its table of slot_bytes a slot fits direct_bytes."""
            if info is None or direct_bytes is None \
                    or (info[1] + 1) * slot_bytes <= direct_bytes:
                return info
            return None

        semi = jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)
        if semi and self.filter is None:
            return self._run_semi(lrel, rrel, keys, rng, within(1), None)
        if semi and within(20) is not None:
            mm = self._residual_minmax(lrel, rrel)
            if mm is not None:
                return self._run_semi(lrel, rrel, keys, rng, within(20), mm)
        return self._run_expand(lrel, rrel, jt, swapped, keys, rng, within(8), flags,
                                co_cap)

    def _residual_minmax(self, lrel, rrel):
        """(probe_col_expr, build_col_expr, op) when the residual filter is
        ONE comparison between a probe-side and a build-side column (TPC-H
        Q21's l2.l_suppkey <> l1.l_suppkey); None otherwise."""
        f = self.filter
        if not isinstance(f, E.BinaryOp) or f.op not in self._MINMAX_OPS:
            return None

        def side(e):
            if not isinstance(e, E.Column):
                return None
            try:
                inl = lrel.schema.find(e.flat_name) is not None
            except Exception:  # noqa: BLE001 -- ambiguous name
                inl = False
            try:
                inr = rrel.schema.find(e.flat_name) is not None
            except Exception:  # noqa: BLE001 -- ambiguous name
                inr = False
            if inl == inr:
                return None
            return "l" if inl else "r"

        sl, sr = side(f.left), side(f.right)
        op = self._MINMAX_OPS[f.op]
        if sl == "l" and sr == "r":
            return f.left, f.right, op
        if sl == "r" and sr == "l":
            return f.right, f.left, self._MINMAX_MIRROR[op]
        return None

    @staticmethod
    def _phase1(lrel, rrel, keys, rng):
        if rng is not None:
            le, re_, op = rng
            return J.range_join_phase1(eval_expr(le, lrel), eval_expr(re_, rrel),
                                       op, lrel.sel, rrel.sel)
        return J.join_phase1(keys[0], keys[1], lrel.sel, rrel.sel)

    def _run_semi(self, lrel, rrel, keys, rng, info, minmax):
        """SEMI/ANTI without expansion: existence from a per-key min/max
        (`minmax`: the residual's one comparison), a dense bitmap, or the
        phase-1 match counts."""
        if minmax is not None:
            pe, be, op = minmax
            spans, domain = info
            ex = J.join_exists_minmax(keys[0], keys[1], lrel.sel, rrel.sel,
                                      spans, domain, eval_expr(pe, lrel),
                                      eval_expr(be, rrel), op)
            self.path = "minmax"
        elif info is not None:
            spans, domain = info
            ex = J.join_direct_exists(keys[0], keys[1], lrel.sel, rrel.sel,
                                      spans, domain)
            self.path = "semi-direct"
        else:
            _, _, cnt, _ = self._phase1(lrel, rrel, keys, rng)
            ex = cnt > 0
            self.path = "semi-range" if rng is not None else "semi-sort-merge"
        anti = self.join_type in (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)
        return DeviceRelation(self.schema, lrel.columns,
                              lrel.sel & (~ex if anti else ex))

    def _run_expand(self, lrel, rrel, jt, swapped, keys, rng, info, flags=None,
                    co_cap=None):
        tried = None
        if jt in (JoinType.INNER, JoinType.LEFT) and info is not None \
                and self._direct_ok.get(info) is not False:
            if flags is not None and info not in self._direct_ok:
                raise ExecutionError("direct join not discovered")
            out, dup = self._direct_impl(lrel, rrel, keys, jt, swapped, info)
            if flags is not None:
                flags.append(dup)  # a duplicate build key: rediscover
                self.path = "direct"
                return out
            ok = not bool(dup)  # host read
            self._direct_ok[info] = ok
            if ok:
                self.path = "direct"
                return out
            tried = "direct-dup"
        perm, lo, cnt, total = self._phase1(lrel, rrel, keys, rng)
        if flags is not None:
            co = self._last_co
            if not co:
                raise ExecutionError("join capacity not discovered")
            if co_cap is not None:
                co = min(co, co_cap)
            flags.append(total > co)
        else:
            co = max(bucket_capacity(max(int(total), 1)), self._last_co)  # host read
            self._last_co = co
        path = "range" if rng is not None else "sort-merge"
        self.path = path if tried is None else f"{tried},{path}"
        return self._expand_impl(lrel, rrel, perm, lo, cnt, jt, swapped, co)

    def _direct_impl(self, lrel, rrel, keys, jt, swapped, info):
        """Direct-address INNER/LEFT join: the output keeps the probe's
        capacity and order. Returns (relation, dup flag)."""
        spans, domain = info
        lcols = list(lrel.columns)
        # INNER output masks unmatched rows through sel: no NULL extension
        nullx = jt is not JoinType.INNER
        rcols, matched, dup = J.join_direct_gather(
            keys[0], keys[1], lrel.sel, rrel.sel, spans, domain,
            list(rrel.columns), null_unmatched=nullx)
        block = DeviceRelation(
            self._block_schema(lrel, rrel, swapped),
            tuple(rcols + lcols) if swapped else tuple(lcols + rcols), matched)
        final = matched
        if self.filter is not None:
            final = final & eval_predicate(self.filter, block)
        if jt is JoinType.INNER:
            return DeviceRelation(self.schema, block.columns, final), dup
        # LEFT: every live probe row survives; a failed match or residual
        # NULL-extends the build columns
        dead_b = ~final
        rcols2 = []
        for c in rcols:
            v = c.validity if c.validity is not None else torch.ones_like(dead_b)
            ne = dead_b.view((-1,) + (1,) * (c.data.ndim - 1))
            rcols2.append(DeviceColumn(
                torch.where(ne, torch.zeros_like(c.data), c.data), v & ~dead_b,
                c.dtype, c.dictionary, None, c.lengths, c.elem_valid, c.meta))
        cols = tuple(rcols2 + lcols) if swapped else tuple(lcols + rcols2)
        return DeviceRelation(self.schema, cols, lrel.sel), dup

    def _expand_impl(self, lrel, rrel, perm, lo, cnt, jt, swapped, co):
        """Matched pairs (by probe row, then build rows in key order), the
        residual, then the unmatched probe rows (LEFT/FULL) and unmatched
        build rows (FULL) as NULL-extended blocks."""
        probe_row, build_row, out_valid = K.join_expand(perm, lo, cnt, co)
        lcols = J.gather_columns(list(lrel.columns), probe_row, out_valid)
        rcols = J.gather_columns(list(rrel.columns), build_row, out_valid)
        block_schema = self._block_schema(lrel, rrel, swapped)
        block = DeviceRelation(
            block_schema,
            tuple(rcols + lcols) if swapped else tuple(lcols + rcols), out_valid)
        sel_matched = out_valid
        if self.filter is not None:
            sel_matched = sel_matched & eval_predicate(self.filter, block)
        block = block.with_sel(sel_matched)

        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            # filtered semi/anti: any passing match per probe row
            any_pass = _scatter_any(lrel.capacity, probe_row, sel_matched)
            keep = any_pass if jt is JoinType.LEFT_SEMI else ~any_pass
            return DeviceRelation(self.schema, lrel.columns, lrel.sel & keep)

        blocks = [block]
        if jt in (JoinType.LEFT, JoinType.FULL):
            unmatched = lrel.sel & ~_scatter_any(lrel.capacity, probe_row, sel_matched)
            rcols2 = J.gather_columns(
                list(rrel.columns),
                torch.zeros(lrel.capacity, dtype=torch.int64, device=lrel.device),
                unmatched, null_extend=torch.ones_like(unmatched))
            lcols2 = list(lrel.columns)
            blocks.append(DeviceRelation(
                block_schema,
                tuple(rcols2 + lcols2) if swapped else tuple(lcols2 + rcols2),
                unmatched))
        if jt is JoinType.FULL:
            unmatched_b = rrel.sel & ~_scatter_any(rrel.capacity, build_row, sel_matched)
            lcols3 = J.gather_columns(
                list(lrel.columns),
                torch.zeros(rrel.capacity, dtype=torch.int64, device=rrel.device),
                unmatched_b, null_extend=torch.ones_like(unmatched_b))
            rcols3 = list(rrel.columns)
            blocks.append(DeviceRelation(
                block_schema,
                tuple(rcols3 + lcols3) if swapped else tuple(lcols3 + rcols3),
                unmatched_b))
        return concat_relations(blocks, self.schema)

    def _block_schema(self, lrel, rrel, swapped):
        """Schema of an expansion block: the full (original-left,
        original-right) column set, wider than self.schema for semi/anti
        joins, so that residual filters see both sides."""
        lsch, rsch = (rrel.schema, lrel.schema) if swapped else (lrel.schema, rrel.schema)
        return lsch.join(rsch)

    def _line(self):
        on = ", ".join(f"{l.name()}={r.name()}" for l, r in self.on)
        if self.range_on is not None:
            le, re_, op = self.range_on
            sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">="}[op]
            return (f"JoinExec: {self.join_type.value} "
                    f"range=[{le.name()} {sym} {re_.name()}] (piecewise merge)")
        return f"JoinExec: {self.join_type.value} on=[{on}]"


def concat_relations(rels: List[DeviceRelation], schema: Schema) -> DeviceRelation:
    """Concatenate relations (the blocks of an outer join, the inputs of a
    UNION). String columns are re-encoded onto one merged dictionary when
    theirs differ."""
    out_cols = []
    for i, f in enumerate(schema.fields):
        cols = [r.columns[i] for r in rels]
        if f.dtype.is_list:
            out_cols.append(_concat_lists(cols, f.dtype))
            continue
        if f.dtype.is_string:
            from .expr_compiler import unify_many_string_columns

            cols = unify_many_string_columns(cols)
        data = torch.cat([c.data for c in cols])
        want = torch_dtype(f.dtype)
        if data.dtype != want:
            data = data.to(want)
        validity = None
        if any(c.validity is not None for c in cols):
            validity = torch.cat([c.valid() for c in cols])
        out_cols.append(DeviceColumn(data, validity, f.dtype, cols[0].dictionary))
    return DeviceRelation(schema, tuple(out_cols), torch.cat([r.sel for r in rels]))


def _pad_width(t: torch.Tensor, dims) -> torch.Tensor:
    """t zero-padded at the end of each axis past the first to `dims`."""
    amount = []
    for d in reversed(range(1, t.ndim)):
        amount += [0, dims[d - 1] - t.shape[d]]
    return TF.pad(t, amount) if any(amount) else t


def _concat_lists(cols: List[DeviceColumn], dtype: T.DataType) -> DeviceColumn:
    """List columns one after another: each padded to the widest, string
    elements on one merged dictionary; validity, lengths and slot masks kept
    apart (a NULL list, an empty list and a NULL element stay distinct)."""
    if dtype.elem.is_string:
        from .expr_compiler import unify_many_string_columns

        flat = unify_many_string_columns(
            [DeviceColumn(c.data.reshape(-1), None, T.STRING, c.dictionary)
             for c in cols])
        cols = [DeviceColumn(fc.data.reshape(c.data.shape), c.validity, c.dtype,
                             fc.dictionary, None, c.lengths, c.elem_valid)
                for c, fc in zip(cols, flat)]
    shape = [max(c.data.shape[d] for c in cols) for d in range(1, cols[0].data.ndim)]
    data = torch.cat([_pad_width(c.data, shape) for c in cols])
    if not dtype.elem.is_list:
        data = data.to(torch_dtype(dtype.elem))
    ev = torch.cat([_pad_width(c.slot_valid(), shape[:1]) for c in cols])
    validity = None
    if any(c.validity is not None for c in cols):
        validity = torch.cat([c.valid() for c in cols])
    return DeviceColumn(data, validity, dtype, cols[0].dictionary, None,
                        torch.cat([c.list_lengths() for c in cols]), ev)


class UnionExec(PhysicalPlan):
    """UNION ALL: the inputs' relations one after another (capacities add
    up; each input keeps its selection mask)."""

    def __init__(self, inputs: Sequence[PhysicalPlan], schema: Schema):
        self.inputs = list(inputs)
        self.schema = schema

    def children(self):
        return tuple(self.inputs)

    def _transform(self, rels: Sequence[DeviceRelation]) -> DeviceRelation:
        return concat_relations(list(rels), self.schema)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        rels = [p.execute(ctx) for p in self.inputs]
        return self._timed(ctx, self._transform, rels)


class UnnestExec(PhysicalPlan):
    """Explode list expressions to rows (reference: UnnestExec,
    physical-plan/src/unnest.rs:65). The output capacity is capacity x the
    widest list: input row i owns slots [i * w, (i + 1) * w), its live slots
    masked by its list lengths, so the explode is one reshape and repeats.
    Zip semantics: a row expands to its longest list, a NULL or empty list
    contributes no row, a shorter list pads with NULL, and the passthrough
    columns repeat."""

    def __init__(self, input: PhysicalPlan, unnest_exprs: Sequence[E.Expr],
                 schema: Schema):
        self.input = input
        self.unnest_exprs = tuple(unnest_exprs)
        self.schema = schema

    def children(self):
        return (self.input,)

    def _transform(self, rel: DeviceRelation) -> DeviceRelation:
        cols = [eval_expr(e, rel) for e in self.unnest_exprs]
        w = max(max(c.width for c in cols), 1)
        cap = rel.capacity
        dev = rel.device
        maxlen = None
        for c in cols:
            eff = torch.where(c.valid(), c.list_lengths(), 0)
            maxlen = eff if maxlen is None else torch.maximum(maxlen, eff)
        slot = torch.arange(w, dtype=torch.int32, device=dev).repeat(cap)
        sel = K.repeat_rows(rel.sel, w) & (slot < K.repeat_rows(maxlen, w))
        out_cols = [_with_leaves(c, {k: K.repeat_rows(v, w)
                                     for k, v in _column_leaves(c).items()})
                    for c in rel.columns]
        for c, f in zip(cols, self.schema.fields[len(rel.columns):]):
            data = c.data if c.data.ndim > 1 else c.data[:, None]
            data, sv = _pad_width(data, [w]), _pad_width(c.slot_valid(), [w])
            ev = (sv & c.valid()[:, None]).reshape(cap * w)
            out_cols.append(DeviceColumn(data.reshape(cap * w), ev, f.dtype,
                                         c.dictionary))
        return DeviceRelation(self.schema, tuple(out_cols), sel)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        return self._timed(ctx, self._transform, self.input.execute(ctx))

    def _line(self):
        return f"UnnestExec: {', '.join(e.name() for e in self.unnest_exprs)}"


class RecursiveQueryExec(PhysicalPlan):
    """Host-driven fixpoint loop for WITH RECURSIVE (reference:
    RecursiveQueryExec, physical-plan/src/recursive_query.rs:66). The
    iteration count is data-dependent, so the loop runs on the host: the
    static arm first, then the recursive arm against the previous step's
    rows (bound to the work table) until a step has no live row, one host
    read of the live count per step. The steps are kept in a list and
    concatenated once at the end; the reference concatenates its
    accumulator every step, which gives the same rows in the same order."""

    MAX_ITERATIONS = 100

    def __init__(self, static_plan: PhysicalPlan, recursive_plan: PhysicalPlan,
                 work_table, schema: Schema, name: str):
        self.static_plan = static_plan
        self.recursive_plan = recursive_plan
        self.work_table = work_table
        self.schema = schema
        self.name = name
        self.iterations: Optional[int] = None  # steps run by the last execute

    def children(self):
        return (self.static_plan, self.recursive_plan)

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        work = self.static_plan.execute(ctx)
        steps = [work]
        try:
            for i in range(self.MAX_ITERATIONS):
                ctx.check_cancelled()
                if int(work.sel.sum()) == 0:  # host read
                    self.iterations = i
                    if len(steps) == 1:
                        return work
                    return concat_relations(steps, self.schema)
                self.work_table._rel = work
                work = self.recursive_plan.execute(ctx)
                steps.append(work)
        finally:
            self.work_table._rel = None
        raise ExecutionError(
            f"recursive CTE {self.name!r} exceeded "
            f"{self.MAX_ITERATIONS} iterations")

    def _line(self):
        return f"RecursiveQueryExec: {self.name}"


class _ConstantLeaf(PhysicalPlan):
    """A leaf whose relation is made from the plan alone: made once per
    device and kept, so every execution (and a CUDA graph captured over it)
    reads the same tensors and dictionaries."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._rels: Dict[str, DeviceRelation] = {}  # device -> relation

    def execute(self, ctx: ExecContext) -> DeviceRelation:
        device = resolve_device(ctx.device)
        key = str(device)
        if key not in self._rels:
            self._rels[key] = self._make(device)
        return self._rels[key]

    def _make(self, device) -> DeviceRelation:
        raise NotImplementedError


class ValuesExec(_ConstantLeaf):
    def __init__(self, schema: Schema, rows: List[List[E.Literal]]):
        super().__init__(schema)
        self.rows = rows

    def _make(self, device) -> DeviceRelation:
        from ..data.table import Table

        data = {f.name: [r[i].value for r in self.rows]
                for i, f in enumerate(self.schema.fields)}
        t = Table.from_pydict(data, {f.name: f.dtype for f in self.schema.fields})
        rel = to_device(t, device=device)
        return DeviceRelation(self.schema, rel.columns, rel.sel)


class EmptyExec(_ConstantLeaf):
    """No rows, or (one_row) the one row of a FROM-less SELECT, every column
    NULL."""

    def __init__(self, schema: Schema, one_row: bool = True):
        super().__init__(schema)
        self.one_row = one_row

    def _make(self, device) -> DeviceRelation:
        rel = empty_relation(self.schema, device)
        if self.one_row:
            rel = rel.with_sel(torch.arange(rel.capacity, device=rel.device) == 0)
        return rel
