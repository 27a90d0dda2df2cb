# Verbatim copy of datafusion_tpu/expr/nodes.py; host-only, kept in step with the original.
"""Logical expression IR.

Capability analog of the reference's `Expr` enum (datafusion/expr/src/expr.rs:326):
columns, literals, binary/unary ops, CASE, CAST, IN, BETWEEN, LIKE, scalar and
aggregate and window function calls, subquery expressions, aliases.  Kept as
frozen dataclasses so expressions hash/compare structurally (needed for
common-subexpression work and GROUP BY key matching).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from ..common import types as T


class Expr:
    """Base class. Subclasses are frozen dataclasses."""

    def children(self) -> Tuple["Expr", ...]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Expr):
                out.append(v)
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, Expr):
                        out.append(x)
                    elif isinstance(x, tuple):  # CASE branches: ((when, then), ...)
                        out.extend(y for y in x if isinstance(y, Expr))
        return tuple(out)

    def name(self) -> str:
        """Output column name when this expr appears unaliased in a SELECT
        list (reference: Expr::schema_name)."""
        return _display(self)

    # -- sugar used by the DataFrame API and tests -----------------------
    def _wrap(self, other) -> "Expr":
        return other if isinstance(other, Expr) else lit(other)

    def __add__(self, o):
        return BinaryOp(Op.ADD, self, self._wrap(o))

    def __radd__(self, o):
        return BinaryOp(Op.ADD, self._wrap(o), self)

    def __sub__(self, o):
        return BinaryOp(Op.SUB, self, self._wrap(o))

    def __rsub__(self, o):
        return BinaryOp(Op.SUB, self._wrap(o), self)

    def __mul__(self, o):
        return BinaryOp(Op.MUL, self, self._wrap(o))

    def __rmul__(self, o):
        return BinaryOp(Op.MUL, self._wrap(o), self)

    def __truediv__(self, o):
        return BinaryOp(Op.DIV, self, self._wrap(o))

    def __mod__(self, o):
        return BinaryOp(Op.MOD, self, self._wrap(o))

    def __gt__(self, o):
        return BinaryOp(Op.GT, self, self._wrap(o))

    def __ge__(self, o):
        return BinaryOp(Op.GE, self, self._wrap(o))

    def __lt__(self, o):
        return BinaryOp(Op.LT, self, self._wrap(o))

    def __le__(self, o):
        return BinaryOp(Op.LE, self, self._wrap(o))

    def eq(self, o):
        return BinaryOp(Op.EQ, self, self._wrap(o))

    def ne(self, o):
        return BinaryOp(Op.NEQ, self, self._wrap(o))

    def __and__(self, o):
        return BinaryOp(Op.AND, self, self._wrap(o))

    def __or__(self, o):
        return BinaryOp(Op.OR, self, self._wrap(o))

    def __invert__(self):
        return Not(self)

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def cast(self, dtype: T.DataType) -> "Expr":
        return Cast(self, dtype)

    def is_null(self) -> "Expr":
        return IsNull(self)

    def is_not_null(self) -> "Expr":
        return Not(IsNull(self))

    def sort(self, asc: bool = True, nulls_first: Optional[bool] = None) -> "SortSpec":
        return SortSpec(self, asc, nulls_first if nulls_first is not None else not asc)


class Op(enum.Enum):
    ADD = "+"
    SUB = "-"
    MUL = "*"
    DIV = "/"
    MOD = "%"
    EQ = "="
    NEQ = "<>"
    LT = "<"
    LE = "<="
    GT = ">"
    GE = ">="
    AND = "AND"
    OR = "OR"

    @property
    def is_comparison(self) -> bool:
        return self in (Op.EQ, Op.NEQ, Op.LT, Op.LE, Op.GT, Op.GE)

    @property
    def is_logic(self) -> bool:
        return self in (Op.AND, Op.OR)

    @property
    def is_arith(self) -> bool:
        return self in (Op.ADD, Op.SUB, Op.MUL, Op.DIV, Op.MOD)


def _d(cls):
    return dataclasses.dataclass(frozen=True, eq=True)(cls)


@_d
class Column(Expr):
    cname: str
    qualifier: Optional[str] = None

    @property
    def flat_name(self) -> str:
        return f"{self.qualifier}.{self.cname}" if self.qualifier else self.cname


@_d
class Literal(Expr):
    value: object  # python scalar; None = NULL
    dtype: T.DataType


@_d
class BinaryOp(Expr):
    op: Op
    left: Expr
    right: Expr


@_d
class Not(Expr):
    expr: Expr


@_d
class Negative(Expr):
    expr: Expr


@_d
class IsNull(Expr):
    expr: Expr


@_d
class Cast(Expr):
    expr: Expr
    dtype: T.DataType
    # try_cast yields NULL instead of error on failure
    safe: bool = False


@_d
class Case(Expr):
    # CASE [operand] WHEN w THEN t ... [ELSE e] END
    operand: Optional[Expr]
    branches: Tuple[Tuple[Expr, Expr], ...]
    else_expr: Optional[Expr]


@_d
class InList(Expr):
    expr: Expr
    values: Tuple[Expr, ...]
    negated: bool = False


@_d
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False


@_d
class Like(Expr):
    expr: Expr
    pattern: Expr  # must be a string literal for now
    negated: bool = False
    case_insensitive: bool = False


@_d
class ScalarFunction(Expr):
    fname: str  # lowercase
    args: Tuple[Expr, ...]


@_d
class Lambda(Expr):
    """`x -> body` / `(x, i) -> body` argument of a higher-order nested
    function (reference: lambda Expr variant + functions-nested
    array_transform/filter/any_match)."""
    params: Tuple[str, ...]
    body: Expr


@_d
class AggregateFunction(Expr):
    fname: str  # lowercase: count, sum, avg, min, max, ...
    args: Tuple[Expr, ...]
    distinct: bool = False
    filter: Optional[Expr] = None
    # agg(x ORDER BY y [DESC], ...) for order-sensitive aggregates
    # (reference: Expr::AggregateFunction params.order_by)
    order_by: Tuple["SortSpec", ...] = ()
    # first_value(x IGNORE NULLS): params.null_treatment
    ignore_nulls: bool = False


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """Window frame clause (reference: datafusion/expr/src/window_frame.rs —
    WindowFrame { units, start_bound, end_bound }).

    units: 'rows' | 'range' | 'groups'.
    Bound kinds: 'unbounded_preceding' | 'preceding' | 'current_row' |
    'following' | 'unbounded_following'; offset is the literal bound value
    (int for ROWS/GROUPS, number for RANGE) or None."""

    units: str
    start_kind: str
    start_offset: Optional[object] = None
    end_kind: str = "current_row"
    end_offset: Optional[object] = None


@_d
class WindowFunction(Expr):
    fname: str
    args: Tuple[Expr, ...]
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple["SortSpec", ...] = ()
    frame: Optional[WindowFrame] = None
    # aggregate FILTER (WHERE ...) clause (reference: Expr::WindowFunction
    # params.filter, datafusion/expr/src/expr.rs); aggregate-family only
    filter: Optional[Expr] = None
    # IGNORE NULLS (lead/lag/first_value/last_value/nth_value; reference:
    # params.null_treatment NullTreatment::IgnoreNulls)
    ignore_nulls: bool = False


@_d
class Alias(Expr):
    expr: Expr
    aname: str
    # output-field relation qualifier: lets optimizer rewrites that move a
    # column to a differently-aliased relation restore the original qualified
    # name (reference: Expr::Alias carries an optional relation --
    # expr/src/expr.rs Alias { relation, .. })
    qualifier: Optional[str] = None


@_d
class SortSpec(Expr):
    expr: Expr
    asc: bool = True
    nulls_first: bool = False


# -- subquery expressions (decorrelated by the optimizer) -------------------


@_d
class ScalarSubquery(Expr):
    plan: object  # LogicalPlan


@_d
class Exists(Expr):
    plan: object
    negated: bool = False


@_d
class InSubquery(Expr):
    expr: Expr
    plan: object
    negated: bool = False


@_d
class Placeholder(Expr):
    pid: str


# ---------------------------------------------------------------------------


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    if dtype is None:
        if value is None:
            dtype = T.NULL
        elif isinstance(value, bool):
            dtype = T.BOOL
        elif isinstance(value, int):
            dtype = T.INT64
        elif isinstance(value, float):
            dtype = T.FLOAT64
        elif isinstance(value, str):
            dtype = T.STRING
        else:
            raise TypeError(f"cannot infer literal type of {value!r}")
    return Literal(value, dtype)


def col(name: str) -> Column:
    if "." in name:
        q, c = name.split(".", 1)
        return Column(c, q)
    return Column(name)


def _display(e: Expr) -> str:
    if isinstance(e, Column):
        return e.cname
    if isinstance(e, Alias):
        return e.aname
    if isinstance(e, Literal):
        return str(e.value)
    if isinstance(e, BinaryOp):
        return f"{_display(e.left)} {e.op.value} {_display(e.right)}"
    if isinstance(e, AggregateFunction):
        inner = ", ".join(_display(a) for a in e.args) or "*"
        d = "DISTINCT " if e.distinct else ""
        ob = " ORDER BY " + ", ".join(
            f"{_display(s.expr)} {'ASC' if s.asc else 'DESC'}"
            for s in e.order_by) if e.order_by else ""
        nt = " IGNORE NULLS" if e.ignore_nulls else ""
        return f"{e.fname}({d}{inner}{ob}{nt})"
    if isinstance(e, ScalarFunction):
        return f"{e.fname}({', '.join(_display(a) for a in e.args)})"
    if isinstance(e, Lambda):
        ps = e.params[0] if len(e.params) == 1 else "(" + ", ".join(e.params) + ")"
        return f"{ps} -> {_display(e.body)}"
    if isinstance(e, WindowFunction):
        args = ", ".join(_display(a) for a in e.args)
        pb = " PARTITION BY " + ", ".join(_display(p) for p in e.partition_by) if e.partition_by else ""
        ob = " ORDER BY " + ", ".join(
            f"{_display(s.expr)} {'ASC' if s.asc else 'DESC'}" for s in e.order_by
        ) if e.order_by else ""
        fr = ""
        if e.frame is not None:
            def _b(kind, off):
                return {"unbounded_preceding": "UNBOUNDED PRECEDING",
                        "current_row": "CURRENT ROW",
                        "unbounded_following": "UNBOUNDED FOLLOWING",
                        "preceding": f"{off} PRECEDING",
                        "following": f"{off} FOLLOWING"}[kind]
            fr = (f" {e.frame.units.upper()} BETWEEN "
                  f"{_b(e.frame.start_kind, e.frame.start_offset)} AND "
                  f"{_b(e.frame.end_kind, e.frame.end_offset)}")
        return f"{e.fname}({args}) OVER ({pb.strip()}{ob}{fr})"
    if isinstance(e, Cast):
        return _display(e.expr)
    if isinstance(e, Not):
        return f"NOT {_display(e.expr)}"
    if isinstance(e, Negative):
        return f"(- {_display(e.expr)})"
    if isinstance(e, IsNull):
        return f"{_display(e.expr)} IS NULL"
    if isinstance(e, Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(_display(e.operand))
        for w, t in e.branches:
            parts.append(f"WHEN {_display(w)} THEN {_display(t)}")
        if e.else_expr is not None:
            parts.append(f"ELSE {_display(e.else_expr)}")
        parts.append("END")
        return " ".join(parts)
    if isinstance(e, Between):
        neg = "NOT " if e.negated else ""
        return f"{_display(e.expr)} {neg}BETWEEN {_display(e.low)} AND {_display(e.high)}"
    if isinstance(e, InList):
        inner = ", ".join(_display(v) for v in e.values)
        neg = "NOT " if e.negated else ""
        return f"{_display(e.expr)} {neg}IN ({inner})"
    if isinstance(e, Like):
        neg = "NOT " if e.negated else ""
        return f"{_display(e.expr)} {neg}LIKE {_display(e.pattern)}"
    if isinstance(e, ScalarSubquery):
        return "(subquery)"
    if isinstance(e, (Exists, InSubquery)):
        return "(subquery)"
    if isinstance(e, SortSpec):
        return _display(e.expr)
    return type(e).__name__


def map_expr(e: Expr, fn) -> Expr:
    """Bottom-up rewrite: apply fn to each node after rewriting children."""
    def rec(x: Expr) -> Expr:
        if isinstance(x, BinaryOp):
            x = BinaryOp(x.op, rec(x.left), rec(x.right))
        elif isinstance(x, Not):
            x = Not(rec(x.expr))
        elif isinstance(x, Negative):
            x = Negative(rec(x.expr))
        elif isinstance(x, IsNull):
            x = IsNull(rec(x.expr))
        elif isinstance(x, Cast):
            x = Cast(rec(x.expr), x.dtype, x.safe)
        elif isinstance(x, Case):
            x = Case(
                rec(x.operand) if x.operand is not None else None,
                tuple((rec(w), rec(t)) for w, t in x.branches),
                rec(x.else_expr) if x.else_expr is not None else None,
            )
        elif isinstance(x, InList):
            x = InList(rec(x.expr), tuple(rec(v) for v in x.values), x.negated)
        elif isinstance(x, Between):
            x = Between(rec(x.expr), rec(x.low), rec(x.high), x.negated)
        elif isinstance(x, Like):
            x = Like(rec(x.expr), rec(x.pattern), x.negated, x.case_insensitive)
        elif isinstance(x, ScalarFunction):
            x = ScalarFunction(x.fname, tuple(rec(a) for a in x.args))
        elif isinstance(x, AggregateFunction):
            x = AggregateFunction(
                x.fname,
                tuple(rec(a) for a in x.args),
                x.distinct,
                rec(x.filter) if x.filter is not None else None,
                tuple(SortSpec(rec(s.expr), s.asc, s.nulls_first)
                      for s in x.order_by),
                x.ignore_nulls,
            )
        elif isinstance(x, WindowFunction):
            x = WindowFunction(
                x.fname,
                tuple(rec(a) for a in x.args),
                tuple(rec(p) for p in x.partition_by),
                tuple(SortSpec(rec(s.expr), s.asc, s.nulls_first) for s in x.order_by),
                x.frame,
                rec(x.filter) if x.filter is not None else None,
                x.ignore_nulls,
            )
        elif isinstance(x, Alias):
            x = Alias(rec(x.expr), x.aname, x.qualifier)
        elif isinstance(x, SortSpec):
            x = SortSpec(rec(x.expr), x.asc, x.nulls_first)
        elif isinstance(x, InSubquery):
            x = InSubquery(rec(x.expr), x.plan, x.negated)
        return fn(x)

    return rec(e)


def collect_columns(e: Expr) -> set:
    """Free column references (lambda parameters are bound, not free)."""
    out = set()

    def visit(x: Expr, bound=frozenset()):
        if isinstance(x, Column):
            if not (x.qualifier is None and x.cname in bound):
                out.add(x)
            return
        if isinstance(x, Lambda):
            visit(x.body, bound | frozenset(x.params))
            return
        for c in x.children():
            visit(c, bound)

    visit(e)
    return out


def contains_aggregate(e: Expr) -> bool:
    if isinstance(e, AggregateFunction):
        return True
    return any(contains_aggregate(c) for c in e.children())


def contains_window(e: Expr) -> bool:
    if isinstance(e, WindowFunction):
        return True
    return any(contains_window(c) for c in e.children())
