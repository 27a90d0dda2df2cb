"""Physical operators.

Port of datafusion_tpu/physical/plan.py to eager torch execution. Operators
are whole-relation transforms over capacity-padded DeviceRelations: a filter
flips selection bits, a compaction gathers live rows to the front of a
smaller power-of-two capacity, and the grouped and global aggregates compute
dense group ids arithmetically and sum every aggregate in one pass of the
dense aggregation kernel (ops/dense_agg.py).

Ported: ScanExec, FilterExec, ProjectionExec, LimitExec, SortExec (with
fetch = TopK, and the presorted elision), CompactExec, and AggregateExec's
global and dense paths. The sort-based grouping path, and aggregates the
kernel cannot take (min/max, filtered or DISTINCT aggregates, floats), need
ops/groupby.py's phase_sort/_reduce_one, which are ROADMAP queue 1 item 5;
they raise NotImplementedError.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Field, Schema
from ..data.device import (DeviceColumn, DeviceRelation, bucket_capacity,
                           is_integer, torch_dtype)
from ..expr import nodes as E
from ..ops import dense_agg as DA
from ..ops import groupby as G
from ..ops import kernels as K
from ..runtime.context import ExecContext
from .expr_compiler import eval_expr, eval_predicate

_GROUPING_ITEM = "ROADMAP queue 1, item 5 'ops/groupby.py -- sort-based grouping'"


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
        rel = self.provider.scan_device(ctx, filters=self.filters,
                                        projection=self.projection)
        # select/rename columns to match the (qualified, possibly projected) schema
        src = {f.name: c for f, c in zip(rel.schema.fields, rel.columns)}
        cols = [src[f.name] for f in self.schema.fields]
        return DeviceRelation(self.schema, tuple(cols), rel.sel)

    def _line(self):
        f = f" pushdown={len(self.filters)}" if self.filters else ""
        return f"ScanExec: {self.alias}{f}"


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
    small integer ranges): group ids are computed arithmetically and every
    sum/avg/count goes through one dense_groupby_sums pass."""

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

    def _prepare(self, rel: DeviceRelation):
        """Evaluate agg args and filters; build AggSpecs."""
        from ..expr.typing import infer

        arg_cols: List[DeviceColumn] = []
        filter_cols: List[torch.Tensor] = []
        specs: List[G.AggSpec] = []
        arg_index: Dict = {}
        for a in self._agg_fns():
            fname = a.fname
            out_dtype, _ = infer(a, rel.schema)
            if fname == "count" and not a.distinct and (
                    len(a.args) == 0
                    or (isinstance(a.args[0], E.Literal)
                        and a.args[0].value is not None)):
                # count(<non-null literal>) == count(*); count(NULL) is 0 and
                # must go through the null-skipping argument path
                arg_i, fname, arg_dt = None, "count_star", None
            else:
                key = a.args[0]
                arg_i = arg_index.get(key)
                if arg_i is None:
                    arg_i = arg_index[key] = len(arg_cols)
                    arg_cols.append(eval_expr(key, rel))
                arg_dt = arg_cols[arg_i].dtype
            filt_i = None
            if a.filter is not None:
                filt_i = len(filter_cols)
                filter_cols.append(eval_predicate(a.filter, rel))
            specs.append(G.AggSpec(fname, arg_i, a.distinct, out_dtype, arg_dt,
                                   filt_i))
        return arg_cols, filter_cols, specs

    def _dense_eligible(self) -> bool:
        from ..expr.udf import active_registry

        return not any(a.distinct or a.fname in G._ORDER_SENSITIVE
                       or a.fname in G.DENSE_UNSUPPORTED
                       or getattr(a, "order_by", ())
                       or active_registry().aggregate(a.fname) is not None
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

    @staticmethod
    def _coerce_out(c: DeviceColumn, f: Field) -> DeviceColumn:
        data = c.data
        if c.dtype != f.dtype and data.dtype != torch_dtype(f.dtype):
            data = data.to(torch_dtype(f.dtype))
        return DeviceColumn(data, c.validity, f.dtype, c.dictionary,
                            c.bounds, c.lengths, c.elem_valid, c.meta)

    def _dense_sizes(self, rel: DeviceRelation):
        """(per-key domain sizes, their product) when every group key has a
        small static domain, else None. Cached on the node: the keys'
        dictionaries and bounds are static metadata of the plan's inputs."""
        cached = getattr(self, "_dense", False)
        if cached is not False:
            return cached
        self._dense = None
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
            self._dense = (sizes, total)
        return self._dense

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
        group_cols = [eval_expr(g, rel) for g in self.group_exprs]
        arg_cols, _, specs = self._prepare(rel)
        seg, strides = self.dense_seg(group_cols, rel.sel, sizes, ngroups)

        pairs = []
        slots = {}  # spec index -> ("count", None) | (fname, pair index)
        for i, (spec, afn) in enumerate(zip(specs, self._agg_fns())):
            fac = None
            if spec.filter is None and not spec.distinct:
                if spec.fname in ("count", "count_star") and (
                        spec.arg is None or arg_cols[spec.arg].validity is None):
                    slots[i] = ("count", None)
                    continue
                if spec.fname in ("sum", "avg") and afn.args:
                    fac = self._i32_factors(afn.args[0], rel)
            if fac is None:
                raise NotImplementedError(
                    f"aggregate {afn.name()} does not factor into the dense "
                    f"kernel; its general reduction (ops/groupby._reduce_one) "
                    f"is not ported yet ({_GROUPING_ITEM})")
            slots[i] = (spec.fname, len(pairs))
            pairs.append((self._kernel_factor(fac[0]),
                          None if fac[1] is None else self._kernel_factor(fac[1])))

        if slots:
            sums, counts = DA.dense_groupby_sums(seg, rel.sel, pairs, ngroups)
        else:  # group keys only (SELECT DISTINCT-like GROUP BY)
            counts = K.segment_count(seg, rel.sel, ngroups)
        # a global (no GROUP BY) aggregate emits its one row even over empty
        # input (count=0, sums NULL) -- SQL semantics, unlike grouped output
        out_sel = (torch.ones(1, dtype=torch.bool, device=rel.device)
                   if global_one_row else counts > 0)
        has_rows = (counts > 0) & out_sel
        out_keys = self.dense_keys(group_cols, sizes, strides, ngroups)
        out_aggs = []
        for i, spec in enumerate(specs):
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
        rel = self.input.execute(ctx)
        if not self.group_exprs:
            if not self._global_dense_ok(rel):
                raise NotImplementedError(
                    f"global aggregate {self._line()} has no sum/avg that "
                    f"factors into the dense kernel; the general global "
                    f"reduction (ops/groupby.global_aggregate) is not ported "
                    f"yet ({_GROUPING_ITEM})")
            return self._timed(ctx, self._dense_transform, rel, [], 1, True)
        dense = self._dense_sizes(rel)
        if dense is None:
            raise NotImplementedError(
                f"{self._line()}: the group keys have no small static domain; "
                f"sort-based grouping is not ported yet ({_GROUPING_ITEM})")
        sizes, ngroups = dense
        return self._timed(ctx, self._dense_transform, rel, sizes, ngroups)

    def _line(self):
        return (f"AggregateExec: group=[{', '.join(e.name() for e in self.group_exprs)}] "
                f"aggs=[{', '.join(e.name() for e in self.agg_exprs)}]")
