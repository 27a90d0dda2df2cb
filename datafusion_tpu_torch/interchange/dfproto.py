# Verbatim copy of datafusion_tpu/interchange/dfproto.py; host-only, kept in step with the original.
"""DataFusion protobuf logical-plan interchange.

The reference serializes logical plans with prost over
`proto-models/proto/datafusion.proto` (producer/consumer:
`datafusion/proto/src/logical_plan/{to_proto,from_proto}.rs`).  This module
speaks that wire format directly — `plan_to_proto_bytes` emits a
`LogicalPlanNode` the reference can decode, and `plan_from_proto_bytes`
ingests plans the reference frontend serialized, re-binding table scans to
this engine's catalog (the same re-binding convention as the substrait
consumer, interchange/substrait.py).

Covered node set (the reference's DefaultLogicalExtensionCodec core):
Projection/Selection/Aggregate/Join/CrossJoin/Sort/Limit/Distinct/Union/
SubqueryAlias/EmptyRelation/Values/Window/ListingScan/CustomScan/ViewScan/
Repartition(pass-through)/Explain/Analyze(pass-through); exprs: column,
alias, literal, chained binary ops, is-null family, not, negative, between,
case, cast/try_cast, in-list, like/ilike, sort, window, and every
aggregate/scalar function via the UDF envelopes (modern DataFusion encodes
ALL builtins as scalar_udf_expr/aggregate_udf_expr by name).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..common import types as T
from ..common.errors import PlanError
from ..expr import nodes as E
from ..logical import plan as L
from .proto import common_pb2 as C
from .proto import plan_pb2 as P

# --------------------------------------------------------------------------
# arrow types
# --------------------------------------------------------------------------

_SIMPLE_TO_PB = {
    T.TypeKind.BOOL: "BOOL",
    T.TypeKind.INT8: "INT8",
    T.TypeKind.INT16: "INT16",
    T.TypeKind.INT32: "INT32",
    T.TypeKind.INT64: "INT64",
    T.TypeKind.FLOAT32: "FLOAT32",
    T.TypeKind.FLOAT64: "FLOAT64",
    T.TypeKind.STRING: "UTF8",
    T.TypeKind.DATE32: "DATE32",
}


def type_to_pb(t: T.DataType) -> C.ArrowType:
    out = C.ArrowType()
    k = t.kind
    if k in _SIMPLE_TO_PB:
        getattr(out, _SIMPLE_TO_PB[k]).SetInParent()
        return out
    if k is T.TypeKind.TIMESTAMP:
        out.TIMESTAMP.time_unit = C.TimeUnit.Microsecond
        return out
    if k is T.TypeKind.DECIMAL:
        out.DECIMAL128.precision = t.precision or 38
        out.DECIMAL128.scale = t.scale
        return out
    if k is T.TypeKind.LIST:
        out.LIST.field_type.name = "item"
        out.LIST.field_type.arrow_type.CopyFrom(type_to_pb(t.elem))
        out.LIST.field_type.nullable = True
        return out
    if k is T.TypeKind.NULL:
        out.NONE.SetInParent()
        return out
    raise PlanError(f"proto: unsupported type {t}")


def type_from_pb(a: C.ArrowType) -> T.DataType:
    which = a.WhichOneof("arrow_type_enum")
    simple = {
        "BOOL": T.BOOL, "INT8": T.INT8, "INT16": T.INT16, "INT32": T.INT32,
        "INT64": T.INT64, "UINT8": T.INT16, "UINT16": T.INT32,
        "UINT32": T.INT64, "UINT64": T.INT64, "FLOAT32": T.FLOAT32,
        "FLOAT64": T.FLOAT64, "UTF8": T.STRING, "LARGE_UTF8": T.STRING,
        "UTF8_VIEW": T.STRING, "DATE32": T.DATE32, "DATE64": T.DATE32,
        "NONE": T.DataType(T.TypeKind.NULL),
    }
    if which in simple:
        return simple[which]
    if which == "TIMESTAMP":
        return T.TIMESTAMP
    if which == "DECIMAL128":
        return T.decimal(a.DECIMAL128.precision, a.DECIMAL128.scale)
    if which == "DECIMAL64":
        return T.decimal(a.DECIMAL64.precision, a.DECIMAL64.scale)
    if which == "LIST":
        return T.list_of(type_from_pb(a.LIST.field_type.arrow_type))
    if which == "DICTIONARY":
        return type_from_pb(a.DICTIONARY.value)
    raise PlanError(f"proto: unsupported arrow type {which!r}")


# --------------------------------------------------------------------------
# scalar values
# --------------------------------------------------------------------------

def scalar_to_pb(value, t: T.DataType) -> C.ScalarValue:
    out = C.ScalarValue()
    if value is None:
        out.null_value.CopyFrom(type_to_pb(t if t.kind is not T.TypeKind.NULL
                                           else T.INT64))
        return out
    k = t.kind
    if k is T.TypeKind.BOOL:
        out.bool_value = bool(value)
    elif k is T.TypeKind.STRING:
        out.utf8_value = str(value)
    elif k is T.TypeKind.INT8:
        out.int8_value = int(value)
    elif k is T.TypeKind.INT16:
        out.int16_value = int(value)
    elif k is T.TypeKind.INT32:
        out.int32_value = int(value)
    elif k is T.TypeKind.INT64:
        out.int64_value = int(value)
    elif k is T.TypeKind.FLOAT32:
        out.float32_value = float(value)
    elif k is T.TypeKind.FLOAT64:
        out.float64_value = float(value)
    elif k is T.TypeKind.DATE32:
        from ..utils import dates as DU

        v = value if isinstance(value, int) else int(DU.date_str_to_days(str(value)))
        out.date_32_value = v
    elif k is T.TypeKind.TIMESTAMP:
        import numpy as np

        v = value if isinstance(value, int) else int(
            np.datetime64(str(value), "us").astype(np.int64))
        out.timestamp_value.time_unit = C.TimeUnit.Microsecond
        out.timestamp_value.timestamp_value = v
    elif k is T.TypeKind.DECIMAL:
        raw = int(round(float(value) * 10 ** t.scale))
        out.decimal128_value.value = raw.to_bytes(16, "big", signed=True)
        out.decimal128_value.p = t.precision or 38
        out.decimal128_value.s = t.scale
    elif k is T.TypeKind.INTERVAL_DAYS:
        out.interval_daytime_value.days = int(value)
        out.interval_daytime_value.milliseconds = 0
    elif k is T.TypeKind.INTERVAL_MONTHS:
        out.interval_yearmonth_value = int(value)
    else:
        raise PlanError(f"proto: unsupported literal type {t}")
    return out


def scalar_from_pb(s: C.ScalarValue):
    """-> (python value, DataType)."""
    which = s.WhichOneof("value")
    if which is None or which == "null_value":
        t = type_from_pb(s.null_value) if which else T.DataType(T.TypeKind.NULL)
        return None, t
    if which == "bool_value":
        return bool(s.bool_value), T.BOOL
    if which in ("utf8_value", "large_utf8_value", "utf8_view_value"):
        return str(getattr(s, which)), T.STRING
    ints = {"int8_value": T.INT8, "int16_value": T.INT16,
            "int32_value": T.INT32, "int64_value": T.INT64,
            "uint8_value": T.INT16, "uint16_value": T.INT32,
            "uint32_value": T.INT64, "uint64_value": T.INT64}
    if which in ints:
        return int(getattr(s, which)), ints[which]
    if which == "float32_value":
        return float(s.float32_value), T.FLOAT32
    if which == "float64_value":
        return float(s.float64_value), T.FLOAT64
    if which == "date_32_value":
        return int(s.date_32_value), T.DATE32
    if which == "timestamp_value":
        v = int(s.timestamp_value.timestamp_value)
        unit = s.timestamp_value.time_unit
        scale = {C.TimeUnit.Second: 1_000_000, C.TimeUnit.Millisecond: 1_000,
                 C.TimeUnit.Microsecond: 1, C.TimeUnit.Nanosecond: 0}[unit]
        return (v // 1000 if scale == 0 else v * scale), T.TIMESTAMP
    if which == "decimal128_value":
        d = s.decimal128_value
        raw = int.from_bytes(d.value, "big", signed=True)
        return raw / (10 ** d.s), T.decimal(int(d.p), int(d.s))
    if which == "interval_daytime_value":
        iv = s.interval_daytime_value
        return int(iv.days), T.INTERVAL_DAYS
    if which == "interval_yearmonth_value":
        return int(s.interval_yearmonth_value), T.INTERVAL_MONTHS
    raise PlanError(f"proto: unsupported scalar {which!r}")


# --------------------------------------------------------------------------
# expressions
# --------------------------------------------------------------------------

_OP_TO_NAME = {
    E.Op.AND: "And", E.Op.OR: "Or", E.Op.EQ: "Eq", E.Op.NEQ: "NotEq",
    E.Op.LT: "Lt", E.Op.LE: "LtEq", E.Op.GT: "Gt", E.Op.GE: "GtEq",
    E.Op.ADD: "Plus", E.Op.SUB: "Minus", E.Op.MUL: "Multiply",
    E.Op.DIV: "Divide", E.Op.MOD: "Modulo",
}
_NAME_TO_OP = {v: k for k, v in _OP_TO_NAME.items()}

_AGG_NAMES = {
    "count", "sum", "avg", "min", "max", "median", "stddev", "stddev_pop",
    "stddev_samp", "var", "var_pop", "var_samp", "variance", "corr", "covar",
    "covar_pop", "covar_samp", "first_value", "last_value", "nth_value",
    "array_agg", "string_agg", "bit_and", "bit_or", "bit_xor", "bool_and",
    "bool_or", "approx_distinct", "approx_median", "approx_percentile_cont",
    "percentile_cont", "grouping", "any_value", "regr_slope", "regr_intercept",
    "regr_count", "regr_r2", "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy",
    "regr_sxy",
}


class _ExprCodec:
    def to_pb(self, e: E.Expr) -> P.LogicalExprNode:
        out = P.LogicalExprNode()
        if isinstance(e, E.Column):
            out.column.name = e.cname
            if e.qualifier:
                out.column.relation.relation = e.qualifier
            return out
        if isinstance(e, E.Alias):
            out.alias.expr.CopyFrom(self.to_pb(e.expr))
            out.alias.alias = e.aname
            return out
        if isinstance(e, E.Literal):
            out.literal.CopyFrom(scalar_to_pb(e.value, e.dtype))
            return out
        if isinstance(e, E.BinaryOp):
            # linearize same-op chains left-innermost-first like the reference
            ops = [e.right]
            cur = e.left
            while isinstance(cur, E.BinaryOp) and cur.op is e.op:
                ops.append(cur.right)
                cur = cur.left
            ops.append(cur)
            out.binary_expr.op = _OP_TO_NAME[e.op]
            for x in reversed(ops):
                out.binary_expr.operands.add().CopyFrom(self.to_pb(x))
            return out
        if isinstance(e, E.IsNull):
            out.is_null_expr.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.Not):
            out.not_expr.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.Negative):
            out.negative.expr.CopyFrom(self.to_pb(e.expr))
            return out
        if isinstance(e, E.Between):
            out.between.expr.CopyFrom(self.to_pb(e.expr))
            out.between.negated = e.negated
            out.between.low.CopyFrom(self.to_pb(e.low))
            out.between.high.CopyFrom(self.to_pb(e.high))
            return out
        if isinstance(e, E.Case):
            if e.operand is not None:
                out.case_.expr.CopyFrom(self.to_pb(e.operand))
            for w, t in e.branches:
                wt = out.case_.when_then_expr.add()
                wt.when_expr.CopyFrom(self.to_pb(w))
                wt.then_expr.CopyFrom(self.to_pb(t))
            if e.else_expr is not None:
                out.case_.else_expr.CopyFrom(self.to_pb(e.else_expr))
            return out
        if isinstance(e, E.Cast):
            out.cast.expr.CopyFrom(self.to_pb(e.expr))
            out.cast.arrow_type.CopyFrom(type_to_pb(e.dtype))
            return out
        if isinstance(e, E.InList):
            out.in_list.expr.CopyFrom(self.to_pb(e.expr))
            out.in_list.negated = e.negated
            for v in e.values:
                out.in_list.list.add().CopyFrom(self.to_pb(v))
            return out
        if isinstance(e, E.Like):
            tgt = out.ilike if e.case_insensitive else out.like
            tgt.negated = e.negated
            tgt.expr.CopyFrom(self.to_pb(e.expr))
            tgt.pattern.CopyFrom(self.to_pb(e.pattern))
            tgt.escape_char = ""
            return out
        if isinstance(e, E.SortSpec):
            raise PlanError("proto: SortSpec must be encoded via sort_to_pb")
        if isinstance(e, E.AggregateFunction):
            n = out.aggregate_udf_expr
            n.fun_name = e.fname
            n.distinct = e.distinct
            for a in e.args:
                n.args.add().CopyFrom(self.to_pb(a))
            if e.filter is not None:
                n.filter.CopyFrom(self.to_pb(e.filter))
            return out
        if isinstance(e, E.WindowFunction):
            n = out.window_expr
            if e.fname in _AGG_NAMES:
                n.udaf = e.fname
            else:
                n.udwf = e.fname
            for a in e.args:
                n.exprs.add().CopyFrom(self.to_pb(a))
            for p in e.partition_by:
                n.partition_by.add().CopyFrom(self.to_pb(p))
            for s in e.order_by:
                n.order_by.add().CopyFrom(self.sort_to_pb(s))
            if e.filter is not None:
                n.filter.CopyFrom(self.to_pb(e.filter))
            if e.frame is not None:
                self._frame_to_pb(e.frame, n.window_frame)
            else:
                # the reference always carries a frame: default RANGE
                # UNBOUNDED PRECEDING..CURRENT ROW
                n.window_frame.window_frame_units = P.WindowFrameUnits.RANGE
                n.window_frame.start_bound.window_frame_bound_type = \
                    P.WindowFrameBoundType.PRECEDING
                n.window_frame.bound.window_frame_bound_type = \
                    P.WindowFrameBoundType.CURRENT_ROW
            return out
        if isinstance(e, E.ScalarFunction):
            n = out.scalar_udf_expr
            n.fun_name = e.fname
            for a in e.args:
                n.args.add().CopyFrom(self.to_pb(a))
            return out
        raise PlanError(f"proto: cannot serialize expr {type(e).__name__}")

    def sort_to_pb(self, s: E.SortSpec) -> P.SortExprNode:
        out = P.SortExprNode()
        out.expr.CopyFrom(self.to_pb(s.expr))
        out.asc = s.asc
        out.nulls_first = s.nulls_first
        return out

    def _frame_to_pb(self, f: E.WindowFrame, out: P.WindowFrame) -> None:
        out.window_frame_units = {
            "rows": P.WindowFrameUnits.ROWS,
            "range": P.WindowFrameUnits.RANGE,
            "groups": P.WindowFrameUnits.GROUPS,
        }[f.units]

        def bound(kind: str, offset, tgt: P.WindowFrameBound):
            if kind == "current_row":
                tgt.window_frame_bound_type = P.WindowFrameBoundType.CURRENT_ROW
            elif kind in ("preceding", "unbounded_preceding"):
                tgt.window_frame_bound_type = P.WindowFrameBoundType.PRECEDING
            else:
                tgt.window_frame_bound_type = P.WindowFrameBoundType.FOLLOWING
            if offset is not None and not kind.startswith("unbounded"):
                t = T.INT64 if isinstance(offset, int) else T.FLOAT64
                tgt.bound_value.CopyFrom(scalar_to_pb(offset, t))

        bound(f.start_kind, f.start_offset, out.start_bound)
        bound(f.end_kind, f.end_offset, out.bound)

    # -- decoding ----------------------------------------------------------

    def from_pb(self, n: P.LogicalExprNode) -> E.Expr:
        which = n.WhichOneof("ExprType")
        if which == "column":
            q = n.column.relation.relation or None
            return E.Column(n.column.name, q)
        if which == "alias":
            return E.Alias(self.from_pb(n.alias.expr), n.alias.alias)
        if which == "literal":
            v, t = scalar_from_pb(n.literal)
            return E.Literal(v, t)
        if which == "binary_expr":
            b = n.binary_expr
            op = _NAME_TO_OP.get(b.op)
            operands = [self.from_pb(x) for x in b.operands]
            if op is None:
                if b.op == "StringConcat":
                    return E.ScalarFunction("concat", tuple(operands))
                if b.op in ("RegexMatch", "RegexIMatch"):
                    return E.ScalarFunction("regexp_like", tuple(operands))
                raise PlanError(f"proto: unsupported operator {b.op!r}")
            cur = operands[0]
            for x in operands[1:]:
                cur = E.BinaryOp(op, cur, x)
            return cur
        if which == "is_null_expr":
            return E.IsNull(self.from_pb(n.is_null_expr.expr))
        if which == "is_not_null_expr":
            return E.Not(E.IsNull(self.from_pb(n.is_not_null_expr.expr)))
        if which == "not_expr":
            return E.Not(self.from_pb(n.not_expr.expr))
        if which == "negative":
            return E.Negative(self.from_pb(n.negative.expr))
        if which == "between":
            return E.Between(self.from_pb(n.between.expr),
                             self.from_pb(n.between.low),
                             self.from_pb(n.between.high), n.between.negated)
        if which == "case_":
            c = n.case_
            operand = self.from_pb(c.expr) if c.HasField("expr") else None
            branches = tuple((self.from_pb(wt.when_expr),
                              self.from_pb(wt.then_expr))
                             for wt in c.when_then_expr)
            els = self.from_pb(c.else_expr) if c.HasField("else_expr") else None
            return E.Case(operand, branches, els)
        if which in ("cast", "try_cast"):
            c = getattr(n, which)
            return E.Cast(self.from_pb(c.expr), type_from_pb(c.arrow_type))
        if which == "in_list":
            return E.InList(self.from_pb(n.in_list.expr),
                            tuple(self.from_pb(x) for x in n.in_list.list),
                            n.in_list.negated)
        if which in ("like", "ilike"):
            l = getattr(n, which)
            return E.Like(self.from_pb(l.expr), self.from_pb(l.pattern),
                          l.negated, which == "ilike")
        if which == "aggregate_udf_expr":
            a = n.aggregate_udf_expr
            filt = self.from_pb(a.filter) if a.HasField("filter") else None
            return E.AggregateFunction(
                a.fun_name.lower(),
                tuple(self.from_pb(x) for x in a.args), a.distinct, filt)
        if which == "scalar_udf_expr":
            s = n.scalar_udf_expr
            return E.ScalarFunction(s.fun_name.lower(),
                                    tuple(self.from_pb(x) for x in s.args))
        if which == "window_expr":
            w = n.window_expr
            fname = (w.udaf or w.udwf).lower()
            frame = None
            if w.HasField("window_frame"):
                frame = self._frame_from_pb(w.window_frame)
            filt = self.from_pb(w.filter) if w.HasField("filter") else None
            return E.WindowFunction(
                fname, tuple(self.from_pb(x) for x in w.exprs),
                tuple(self.from_pb(x) for x in w.partition_by),
                tuple(self.sort_from_pb(x) for x in w.order_by),
                frame, filt)
        raise PlanError(f"proto: unsupported expr {which!r}")

    def sort_from_pb(self, s: P.SortExprNode) -> E.SortSpec:
        return E.SortSpec(self.from_pb(s.expr), s.asc, s.nulls_first)

    def _frame_from_pb(self, f: P.WindowFrame) -> Optional[E.WindowFrame]:
        units = {P.WindowFrameUnits.ROWS: "rows",
                 P.WindowFrameUnits.RANGE: "range",
                 P.WindowFrameUnits.GROUPS: "groups"}[f.window_frame_units]

        def bound(b: P.WindowFrameBound, preceding_dir: str):
            t = b.window_frame_bound_type
            if t == P.WindowFrameBoundType.CURRENT_ROW:
                return "current_row", None
            kind = ("preceding" if t == P.WindowFrameBoundType.PRECEDING
                    else "following")
            if b.HasField("bound_value"):
                v, _ = scalar_from_pb(b.bound_value)
                if v is not None:
                    return kind, v
            return "unbounded_" + kind, None

        sk, so = bound(f.start_bound, "preceding")
        if f.HasField("bound"):
            ek, eo = bound(f.bound, "following")
        else:
            ek, eo = "current_row", None
        if (units, sk, so, ek, eo) == ("range", "unbounded_preceding", None,
                                       "current_row", None):
            return None  # the default frame; our IR leaves it implicit
        return E.WindowFrame(units, sk, so, ek, eo)


# --------------------------------------------------------------------------
# plans
# --------------------------------------------------------------------------

_JT_TO_PB = {
    L.JoinType.INNER: C.JoinType.INNER, L.JoinType.LEFT: C.JoinType.LEFT,
    L.JoinType.RIGHT: C.JoinType.RIGHT, L.JoinType.FULL: C.JoinType.FULL,
    L.JoinType.LEFT_SEMI: C.JoinType.LEFTSEMI,
    L.JoinType.LEFT_ANTI: C.JoinType.LEFTANTI,
    L.JoinType.RIGHT_SEMI: C.JoinType.RIGHTSEMI,
    L.JoinType.RIGHT_ANTI: C.JoinType.RIGHTANTI,
}
_JT_FROM_PB = {v: k for k, v in _JT_TO_PB.items()}


class _PlanCodec:
    def __init__(self, catalog=None):
        self.catalog = catalog
        self.exprs = _ExprCodec()

    # -- encoding ----------------------------------------------------------

    def to_pb(self, p: L.LogicalPlan) -> P.LogicalPlanNode:
        out = P.LogicalPlanNode()
        ec = self.exprs
        if isinstance(p, L.TableScan):
            n = out.custom_scan
            n.table_name.bare.table = p.name
            if p.projection is not None:
                n.projection.columns.extend(p.projection)
            for field in p.source.schema().fields:
                f = n.schema.columns.add()
                f.name = field.name
                f.arrow_type.CopyFrom(type_to_pb(field.dtype))
                f.nullable = field.nullable
            for flt in p.filters:
                n.filters.add().CopyFrom(ec.to_pb(flt))
            return out
        if isinstance(p, L.Projection):
            out.projection.input.CopyFrom(self.to_pb(p.input))
            for e in p.proj_exprs:
                out.projection.expr.add().CopyFrom(ec.to_pb(e))
            return out
        if isinstance(p, L.Filter):
            out.selection.input.CopyFrom(self.to_pb(p.input))
            out.selection.expr.CopyFrom(ec.to_pb(p.predicate))
            return out
        if isinstance(p, L.Aggregate):
            out.aggregate.input.CopyFrom(self.to_pb(p.input))
            for e in p.group_exprs:
                out.aggregate.group_expr.add().CopyFrom(ec.to_pb(e))
            for e in p.aggr_exprs:
                out.aggregate.aggr_expr.add().CopyFrom(ec.to_pb(e))
            return out
        if isinstance(p, L.Join):
            if p.join_type is L.JoinType.CROSS:
                out.cross_join.left.CopyFrom(self.to_pb(p.left))
                out.cross_join.right.CopyFrom(self.to_pb(p.right))
                return out
            n = out.join
            n.left.CopyFrom(self.to_pb(p.left))
            n.right.CopyFrom(self.to_pb(p.right))
            n.join_type = _JT_TO_PB[p.join_type]
            n.join_constraint = C.JoinConstraint.ON
            for lk, rk in p.on:
                n.left_join_key.add().CopyFrom(ec.to_pb(lk))
                n.right_join_key.add().CopyFrom(ec.to_pb(rk))
            if p.filter is not None:
                n.filter.CopyFrom(ec.to_pb(p.filter))
            return out
        if isinstance(p, L.Sort):
            out.sort.input.CopyFrom(self.to_pb(p.input))
            for s in p.sort_specs:
                out.sort.expr.add().CopyFrom(ec.sort_to_pb(s))
            out.sort.fetch = -1 if p.fetch is None else p.fetch
            return out
        if isinstance(p, L.Limit):
            out.limit.input.CopyFrom(self.to_pb(p.input))
            out.limit.skip = p.skip
            out.limit.fetch = -1 if p.fetch is None else p.fetch
            return out
        if isinstance(p, L.Distinct):
            out.distinct.input.CopyFrom(self.to_pb(p.input))
            return out
        if isinstance(p, L.Union):
            if not p.all:
                inner = P.LogicalPlanNode()
                for c in p.inputs:
                    inner.union.inputs.add().CopyFrom(self.to_pb(c))
                out.distinct.input.CopyFrom(inner)
                return out
            for c in p.inputs:
                out.union.inputs.add().CopyFrom(self.to_pb(c))
            return out
        if isinstance(p, L.SubqueryAlias):
            out.subquery_alias.input.CopyFrom(self.to_pb(p.input))
            out.subquery_alias.alias.bare.table = p.alias
            return out
        if isinstance(p, L.EmptyRelation):
            out.empty_relation.produce_one_row = p.produce_one_row
            return out
        if isinstance(p, L.Values):
            out.values.n_cols = len(p.schema)
            for row in p.rows:
                for lit in row:
                    out.values.values_list.add().CopyFrom(self.exprs.to_pb(lit))
            return out
        if isinstance(p, L.Window):
            out.window.input.CopyFrom(self.to_pb(p.input))
            for e in p.window_exprs:
                out.window.window_expr.add().CopyFrom(ec.to_pb(e))
            return out
        raise PlanError(f"proto: cannot serialize plan {type(p).__name__}")

    # -- decoding ----------------------------------------------------------

    def _bind_table(self, tref, schema_pb=None) -> L.LogicalPlan:
        which = tref.WhichOneof("table_reference_enum")
        name = {"bare": lambda: tref.bare.table,
                "partial": lambda: tref.partial.table,
                "full": lambda: tref.full.table}[which]()
        provider = self.catalog.get(name) if self.catalog is not None else None
        if provider is None:
            raise PlanError(f"proto: table {name!r} not found in catalog")
        return L.TableScan(name, provider)

    def from_pb(self, n: P.LogicalPlanNode) -> L.LogicalPlan:
        which = n.WhichOneof("LogicalPlanType")
        ec = self.exprs
        if which in ("listing_scan", "custom_scan", "view_scan",
                     "cte_work_table_scan"):
            body = getattr(n, which)
            scan = self._bind_table(body.table_name)
            cols = list(body.projection.columns) if body.HasField("projection") \
                else None
            filters = tuple(ec.from_pb(f) for f in getattr(body, "filters", ()))
            plan: L.LogicalPlan = L.TableScan(scan.name, scan.source,
                                              projection=cols or None)
            for f in filters:
                plan = L.Filter(plan, f)
            return plan
        if which == "projection":
            inp = self.from_pb(n.projection.input)
            exprs = [ec.from_pb(e) for e in n.projection.expr]
            plan = L.Projection(inp, exprs)
            if n.projection.HasField("alias"):
                plan = L.SubqueryAlias(plan, n.projection.alias)
            return plan
        if which == "selection":
            return L.Filter(self.from_pb(n.selection.input),
                            ec.from_pb(n.selection.expr))
        if which == "aggregate":
            return L.Aggregate(
                self.from_pb(n.aggregate.input),
                [ec.from_pb(e) for e in n.aggregate.group_expr],
                [ec.from_pb(e) for e in n.aggregate.aggr_expr])
        if which == "join":
            j = n.join
            left = self.from_pb(j.left)
            right = self.from_pb(j.right)
            jt = _JT_FROM_PB.get(j.join_type)
            if jt is None:
                raise PlanError(f"proto: unsupported join type {j.join_type}")
            on = [(ec.from_pb(l), ec.from_pb(r))
                  for l, r in zip(j.left_join_key, j.right_join_key)]
            filt = ec.from_pb(j.filter) if j.HasField("filter") else None
            return L.Join(left, right, on, jt, filt)
        if which == "cross_join":
            return L.Join(self.from_pb(n.cross_join.left),
                          self.from_pb(n.cross_join.right), [],
                          L.JoinType.CROSS)
        if which == "sort":
            specs = [ec.sort_from_pb(s) for s in n.sort.expr]
            fetch = None if n.sort.fetch < 0 else int(n.sort.fetch)
            return L.Sort(self.from_pb(n.sort.input), specs, fetch)
        if which == "limit":
            fetch = None if n.limit.fetch < 0 else int(n.limit.fetch)
            return L.Limit(self.from_pb(n.limit.input),
                           max(0, int(n.limit.skip)), fetch)
        if which == "distinct":
            return L.Distinct(self.from_pb(n.distinct.input))
        if which == "union":
            return L.Union([self.from_pb(c) for c in n.union.inputs], all=True)
        if which == "subquery_alias":
            alias = n.subquery_alias.alias
            aname = {"bare": lambda: alias.bare.table,
                     "partial": lambda: alias.partial.table,
                     "full": lambda: alias.full.table}[
                alias.WhichOneof("table_reference_enum")]()
            return L.SubqueryAlias(self.from_pb(n.subquery_alias.input), aname)
        if which == "empty_relation":
            return L.EmptyRelation(n.empty_relation.produce_one_row)
        if which == "values":
            ncols = int(n.values.n_cols)
            lits = [ec.from_pb(e) for e in n.values.values_list]
            rows = [lits[i:i + ncols] for i in range(0, len(lits), ncols)]
            from ..common.schema import Field, Schema

            fields = []
            for i in range(ncols):
                col = [r[i] for r in rows if isinstance(r[i], E.Literal)]
                t = next((c.dtype for c in col
                          if c.dtype.kind is not T.TypeKind.NULL), T.INT64)
                fields.append(Field(f"column{i + 1}", t, True))
            return L.Values(Schema(fields), rows)
        if which == "window":
            return L.Window(self.from_pb(n.window.input),
                            [ec.from_pb(e) for e in n.window.window_expr])
        if which in ("repartition", "explain", "analyze"):
            return self.from_pb(getattr(n, which).input)
        raise PlanError(f"proto: unsupported plan node {which!r}")


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def plan_to_proto(plan: L.LogicalPlan) -> P.LogicalPlanNode:
    return _PlanCodec().to_pb(plan)


def plan_to_proto_bytes(plan: L.LogicalPlan) -> bytes:
    return plan_to_proto(plan).SerializeToString()


def plan_from_proto(node: P.LogicalPlanNode, catalog) -> L.LogicalPlan:
    return _PlanCodec(catalog).from_pb(node)


def plan_from_proto_bytes(data: bytes, catalog) -> L.LogicalPlan:
    node = P.LogicalPlanNode()
    try:
        node.ParseFromString(data)
    except Exception as exc:  # noqa: BLE001 -- protobuf DecodeError
        raise PlanError(f"invalid LogicalPlanNode bytes: {exc}") from exc
    return plan_from_proto(node, catalog)
