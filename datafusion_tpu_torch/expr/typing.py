# Verbatim copy of datafusion_tpu/expr/typing.py; host-only, kept in step with the original.
"""Expression type inference (reference capability: Expr::get_type +
type_coercion, datafusion/expr/src/expr_schema.rs)."""
from __future__ import annotations

from typing import Tuple

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from . import nodes as E


def infer(e: E.Expr, schema: Schema) -> Tuple[T.DataType, bool]:
    """Return (dtype, nullable) of expression over schema."""
    if isinstance(e, E.Column):
        f = schema.field(e.flat_name)
        return f.dtype, f.nullable
    if isinstance(e, E.Literal):
        return e.dtype, e.value is None
    if isinstance(e, E.Alias):
        return infer(e.expr, schema)
    if isinstance(e, E.SortSpec):
        return infer(e.expr, schema)
    if isinstance(e, E.Cast):
        _, n = infer(e.expr, schema)
        return e.dtype, n or e.safe
    if isinstance(e, E.Not):
        _, n = infer(e.expr, schema)
        return T.BOOL, n
    if isinstance(e, E.Negative):
        return infer(e.expr, schema)
    if isinstance(e, E.IsNull):
        return T.BOOL, False
    if isinstance(e, (E.InList, E.Between, E.Like, E.Exists, E.InSubquery)):
        return T.BOOL, True
    if isinstance(e, E.BinaryOp):
        lt, ln = infer(e.left, schema)
        rt, rn = infer(e.right, schema)
        nullable = ln or rn
        if e.op.is_comparison or e.op.is_logic:
            return T.BOOL, nullable
        return arith_result(e.op, lt, rt), nullable
    if isinstance(e, E.Case):
        dt = None
        nullable = e.else_expr is None
        for _, then in e.branches:
            t, n = infer(then, schema)
            nullable = nullable or n
            dt = t if dt is None or dt.kind is T.TypeKind.NULL else (
                T.common_numeric_type(dt, t) if (dt.is_numeric and t.is_numeric and dt != t) else dt
            )
        if e.else_expr is not None:
            t, n = infer(e.else_expr, schema)
            nullable = nullable or n
            if dt is None or dt.kind is T.TypeKind.NULL:
                dt = t
            elif dt.is_numeric and t.is_numeric and dt != t:
                dt = T.common_numeric_type(dt, t)
        return dt if dt is not None else T.NULL, nullable
    if isinstance(e, E.ScalarSubquery):
        sub_schema = e.plan.schema  # LogicalPlan
        if len(sub_schema) != 1:
            raise PlanError("scalar subquery must return one column")
        return sub_schema.fields[0].dtype, True
    if isinstance(e, E.AggregateFunction):
        return aggregate_result(e, schema)
    if isinstance(e, E.WindowFunction):
        return window_result(e, schema)
    if isinstance(e, E.ScalarFunction):
        return scalar_fn_result(e, schema)
    raise PlanError(f"cannot infer type of {e!r}")


def _as_decimal(t: T.DataType):
    """Integer types viewed as decimals for result-type math (reference:
    coerce_numeric_type_to_decimal128, expr-common type_coercion/binary.rs:
    the spark convention i8->(3,0) i16->(5,0) i32->(10,0) i64->(20,0))."""
    if t.is_decimal:
        return t
    k = T.TypeKind
    p = {k.INT8: 3, k.INT16: 5, k.INT32: 10, k.INT64: 20}.get(t.kind)
    return T.decimal(p, 0) if p is not None else None


def _dec_arith(op: E.Op, lt: T.DataType, rt: T.DataType):
    """Decimal arithmetic result type (reference: arrow-rs decimal kernels
    as exercised by decimal.slt; precision capped at 38)."""
    ld, rd = _as_decimal(lt), _as_decimal(rt)
    if ld is None or rd is None:
        return None
    p1, s1, p2, s2 = ld.precision, ld.scale, rd.precision, rd.scale
    if op in (E.Op.ADD, E.Op.SUB):
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    elif op is E.Op.MUL:
        s = s1 + s2
        p = p1 + p2 + 1
    elif op is E.Op.DIV:
        s = s1 + 4
        p = p1 + s2 + 4
    elif op is E.Op.MOD:
        s = max(s1, s2)
        p = min(p1 - s1, p2 - s2) + s
    else:
        return None
    return T.decimal(min(max(p, s), 38), min(s, 38))


def arith_result(op: E.Op, lt: T.DataType, rt: T.DataType) -> T.DataType:
    if op is E.Op.DIV:
        if lt.is_integer and rt.is_integer:
            return T.common_numeric_type(lt, rt)
        if (lt.is_decimal or rt.is_decimal) and not (lt.is_float or rt.is_float):
            d = _dec_arith(op, lt, rt)
            if d is not None:
                return d
        return T.FLOAT64
    # date/interval arithmetic
    if lt.kind is T.TypeKind.DATE32 and rt.kind in (
            T.TypeKind.INTERVAL_DAYS, T.TypeKind.INTERVAL_US):
        return T.DATE32
    if lt.kind is T.TypeKind.TIMESTAMP and rt.kind in (T.TypeKind.INTERVAL_US,
                                                       T.TypeKind.INTERVAL_DAYS):
        return T.TIMESTAMP
    if lt.kind is T.TypeKind.TIME and rt.kind is T.TypeKind.INTERVAL_US:
        return T.TIME
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.INTERVAL_MONTHS:
        return T.DATE32
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.DATE32 and op is E.Op.SUB:
        return T.INT32  # day difference
    if (lt.is_decimal or rt.is_decimal) and not (lt.is_float or rt.is_float):
        d = _dec_arith(op, lt, rt)
        if d is not None:
            return d
    return T.common_numeric_type(lt, rt)


def aggregate_result(e: E.AggregateFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    f = e.fname
    from .udf import active_registry

    udaf = active_registry().aggregate(f)
    if udaf is not None:
        return udaf.return_type, udaf.nullable
    if f in ("count", "approx_distinct", "regr_count"):
        return T.INT64, False
    if not e.args:
        raise PlanError(f"{f} requires arguments")
    at, _ = infer(e.args[0], schema)
    if f == "sum":
        if at.is_integer:
            return T.INT64, True
        if at.is_decimal:
            # reference: Decimal128(min(p+10, 38), s) (sum.rs out type)
            return T.decimal(min(at.precision + 10, 38), at.scale), True
        return T.FLOAT64, True
    if f in ("avg", "mean") and at.is_decimal:
        # reference: Decimal128(min(p+4, 38), min(s+4, 38)) (avg.rs)
        return T.decimal(min(at.precision + 4, 38), min(at.scale + 4, 38)), True
    if f in ("median", "approx_median") and at.is_decimal:
        return at, True  # reference: median returns the input type
    if f in ("avg", "mean", "median", "approx_median", "stddev", "stddev_pop",
             "stddev_samp", "var", "var_pop", "var_samp", "corr", "covar",
             "covar_pop", "covar_samp", "approx_percentile_cont",
             "percentile_cont", "regr_slope", "regr_intercept", "regr_r2",
             "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy", "regr_sxy"):
        return T.FLOAT64, True
    if f in ("min", "max", "first_value", "last_value", "any_value",
             "nth_value"):
        return at, True
    if f in ("bit_and", "bit_or", "bit_xor"):
        return at, True
    if f in ("bool_and", "bool_or"):
        return T.BOOL, True
    if f == "string_agg":
        return T.STRING, True
    if f == "array_agg":
        return T.list_of(at), True
    raise PlanError(f"unknown aggregate function {f!r}")


def window_result(e: E.WindowFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    f = e.fname
    from .udf import active_registry

    reg = active_registry()
    udwf = reg.window(f) or reg.aggregate(f)
    if udwf is not None:
        return udwf.return_type, udwf.nullable
    if f in ("row_number", "rank", "dense_rank", "ntile", "count"):
        return T.INT64, False
    if f in ("percent_rank", "cume_dist"):
        return T.FLOAT64, False
    if f in ("lead", "lag", "first_value", "last_value", "nth_value", "min", "max"):
        return infer(e.args[0], schema)[0], True
    if f == "sum":
        at, _ = infer(e.args[0], schema)
        if at.is_integer:
            return T.INT64, True
        if at.is_decimal:
            return T.decimal(min(at.precision + 10, 38), at.scale), True
        return T.FLOAT64, True
    if f == "avg":
        at, _ = infer(e.args[0], schema)
        if at.is_decimal:
            return (T.decimal(min(at.precision + 4, 38),
                              min(at.scale + 4, 38)), True)
        return T.FLOAT64, True
    raise PlanError(f"unknown window function {f!r}")


_FN_TYPES = {}


def scalar_fn_result(e: E.ScalarFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    from .udf import active_registry

    udf = active_registry().scalar(e.fname)
    if udf is not None:
        return udf.return_type, udf.nullable
    from ..physical.functions import scalar_function_type  # late import

    return scalar_function_type(e, schema)
