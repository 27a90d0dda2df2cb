# Verbatim copy of datafusion_tpu/sql/unparser.py; host-only, kept in step with the original.
"""LogicalPlan -> SQL text (capability analog of the reference's Unparser,
datafusion/sql/src/unparser/{mod.rs:57, plan.rs:99, expr.rs:85}; used there
for query federation). Round-trip property: unparsed SQL re-plans to an
equivalent plan over the same catalog."""
from __future__ import annotations

from typing import List

from ..common import types as T
from ..common.errors import PlanError
from ..expr import nodes as E
from ..logical import plan as L


def expr_to_sql(e: E.Expr) -> str:
    if isinstance(e, E.Column):
        return f"{e.qualifier}.{_q(e.cname)}" if e.qualifier else _q(e.cname)
    if isinstance(e, E.Literal):
        return _literal_sql(e)
    if isinstance(e, E.Alias):
        return f"{expr_to_sql(e.expr)} AS {_q(e.aname)}"
    if isinstance(e, E.BinaryOp):
        return f"({expr_to_sql(e.left)} {e.op.value} {expr_to_sql(e.right)})"
    if isinstance(e, E.Not):
        return f"(NOT {expr_to_sql(e.expr)})"
    if isinstance(e, E.Negative):
        return f"(- {expr_to_sql(e.expr)})"
    if isinstance(e, E.IsNull):
        return f"({expr_to_sql(e.expr)} IS NULL)"
    if isinstance(e, E.Cast):
        return f"CAST({expr_to_sql(e.expr)} AS {_type_sql(e.dtype)})"
    if isinstance(e, E.Case):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(expr_to_sql(e.operand))
        for w, t in e.branches:
            parts.append(f"WHEN {expr_to_sql(w)} THEN {expr_to_sql(t)}")
        if e.else_expr is not None:
            parts.append(f"ELSE {expr_to_sql(e.else_expr)}")
        parts.append("END")
        return "(" + " ".join(parts) + ")"
    if isinstance(e, E.InList):
        inner = ", ".join(expr_to_sql(v) for v in e.values)
        neg = "NOT " if e.negated else ""
        return f"({expr_to_sql(e.expr)} {neg}IN ({inner}))"
    if isinstance(e, E.Between):
        neg = "NOT " if e.negated else ""
        return (f"({expr_to_sql(e.expr)} {neg}BETWEEN {expr_to_sql(e.low)}"
                f" AND {expr_to_sql(e.high)})")
    if isinstance(e, E.Like):
        neg = "NOT " if e.negated else ""
        op = "ILIKE" if e.case_insensitive else "LIKE"
        return f"({expr_to_sql(e.expr)} {neg}{op} {expr_to_sql(e.pattern)})"
    if isinstance(e, E.ScalarFunction):
        if e.fname == "extract":
            part = e.args[0].value
            return f"EXTRACT({part} FROM {expr_to_sql(e.args[1])})"
        args = ", ".join(expr_to_sql(a) for a in e.args)
        return f"{e.fname}({args})"
    if isinstance(e, E.AggregateFunction):
        if e.fname == "count" and not e.args:
            return "count(*)"
        d = "DISTINCT " if e.distinct else ""
        args = ", ".join(expr_to_sql(a) for a in e.args)
        s = f"{e.fname}({d}{args})"
        if e.filter is not None:
            s += f" FILTER (WHERE {expr_to_sql(e.filter)})"
        return s
    if isinstance(e, E.WindowFunction):
        args = ", ".join(expr_to_sql(a) for a in e.args)
        filt = (f" FILTER (WHERE {expr_to_sql(e.filter)})"
                if e.filter is not None else "")
        over = []
        if e.partition_by:
            over.append("PARTITION BY " + ", ".join(expr_to_sql(p) for p in e.partition_by))
        if e.order_by:
            over.append("ORDER BY " + ", ".join(_sort_sql(s) for s in e.order_by))
        if e.frame is not None:
            def _b(kind, off):
                return {"unbounded_preceding": "UNBOUNDED PRECEDING",
                        "current_row": "CURRENT ROW",
                        "unbounded_following": "UNBOUNDED FOLLOWING",
                        "preceding": f"{off} PRECEDING",
                        "following": f"{off} FOLLOWING"}[kind]
            over.append(f"{e.frame.units.upper()} BETWEEN "
                        f"{_b(e.frame.start_kind, e.frame.start_offset)} AND "
                        f"{_b(e.frame.end_kind, e.frame.end_offset)}")
        return f"{e.fname}({args}){filt} OVER ({' '.join(over)})"
    if isinstance(e, E.SortSpec):
        return _sort_sql(e)
    raise PlanError(f"cannot unparse expr {type(e).__name__}")


def _sort_sql(s: E.SortSpec) -> str:
    d = "ASC" if s.asc else "DESC"
    nf = "NULLS FIRST" if s.nulls_first else "NULLS LAST"
    return f"{expr_to_sql(s.expr)} {d} {nf}"


def _q(name: str) -> str:
    if name.replace("_", "").isalnum() and not name[0].isdigit() and " " not in name:
        ok = all(c.isalnum() or c == "_" for c in name)
        if ok:
            return name
    return '"' + name.replace('"', '""') + '"'


def _literal_sql(e: E.Literal) -> str:
    if e.value is None:
        return "NULL"
    t = e.dtype
    if t.is_string:
        return "'" + str(e.value).replace("'", "''") + "'"
    if t.kind is T.TypeKind.BOOL:
        return "TRUE" if e.value else "FALSE"
    if t.kind is T.TypeKind.DATE32:
        import numpy as np

        if isinstance(e.value, (int,)):
            return f"DATE '{np.datetime64(e.value, 'D')}'"
        return f"DATE '{e.value}'"
    if t.kind is T.TypeKind.INTERVAL_DAYS:
        return f"INTERVAL '{e.value}' DAY"
    if t.kind is T.TypeKind.INTERVAL_MONTHS:
        return f"INTERVAL '{e.value}' MONTH"
    if t.kind is T.TypeKind.INTERVAL_US:
        return f"INTERVAL '{e.value}' MICROSECOND"
    return str(e.value)


def _type_sql(t: T.DataType) -> str:
    k = t.kind
    m = {
        T.TypeKind.BOOL: "BOOLEAN", T.TypeKind.INT8: "TINYINT",
        T.TypeKind.INT16: "SMALLINT", T.TypeKind.INT32: "INT",
        T.TypeKind.INT64: "BIGINT", T.TypeKind.FLOAT32: "REAL",
        T.TypeKind.FLOAT64: "DOUBLE", T.TypeKind.DATE32: "DATE",
        T.TypeKind.TIMESTAMP: "TIMESTAMP", T.TypeKind.STRING: "VARCHAR",
    }
    if k is T.TypeKind.DECIMAL:
        return f"DECIMAL({t.precision}, {t.scale})"
    if k in m:
        return m[k]
    raise PlanError(f"cannot unparse type {t}")


# ---------------------------------------------------------------------------


def _strip_quals(e: E.Expr) -> E.Expr:
    """Re-express column refs by bare output name (valid when the source is a
    synthetic derived table or when referencing the current SELECT list)."""
    return E.map_expr(e, lambda x: E.Column(x.cname) if isinstance(x, E.Column) else x)


def plan_to_sql(p: L.LogicalPlan) -> str:
    return _relation_sql(p)


def _relation_sql(p: L.LogicalPlan) -> str:
    """Render a plan as a SELECT statement."""
    if isinstance(p, L.Projection):
        src = p.input
        where = ""
        if isinstance(src, L.Filter):
            where = f" WHERE {expr_to_sql(src.predicate)}"
            src = src.input
        frm = _from_sql(src)
        exprs = p.proj_exprs
        if frm.endswith("AS _t"):
            exprs = [_strip_quals(e) for e in exprs]
        items = ", ".join(expr_to_sql(e) for e in exprs)
        return f"SELECT {items} FROM {frm}{where}"
    if isinstance(p, L.Distinct):
        inner = _relation_sql(p.input)
        if inner.startswith("SELECT "):
            return "SELECT DISTINCT " + inner[len("SELECT "):]
        return f"SELECT DISTINCT * FROM {_from_sql(p.input)}"
    if isinstance(p, L.Sort):
        # sort keys reference the SELECT list outputs: render bare
        keys = ", ".join(_sort_sql(E.SortSpec(_strip_quals(sp.expr), sp.asc, sp.nulls_first))
                         for sp in p.sort_specs)
        base = _relation_sql(p.input)
        s = f"{base} ORDER BY {keys}"
        if p.fetch is not None:
            s += f" LIMIT {p.fetch}"
        return s
    if isinstance(p, L.Limit):
        base = _relation_sql(p.input)
        s = base
        if p.fetch is not None:
            s += f" LIMIT {p.fetch}"
        if p.skip:
            s += f" OFFSET {p.skip}"
        return s
    if isinstance(p, L.Aggregate):
        items = [expr_to_sql(e) for e in p.group_exprs]
        items += [expr_to_sql(e) for e in p.aggr_exprs]
        src = p.input
        where = ""
        if isinstance(src, L.Filter):
            where = f" WHERE {expr_to_sql(src.predicate)}"
            src = src.input
        sql = f"SELECT {', '.join(items) or '*'} FROM {_from_sql(src)}{where}"
        if p.group_exprs:
            sql += " GROUP BY " + ", ".join(expr_to_sql(e) for e in p.group_exprs)
        return sql
    if isinstance(p, L.Filter):
        return f"SELECT * FROM {_from_sql(p.input)} WHERE {expr_to_sql(p.predicate)}"
    if isinstance(p, L.Union):
        op = " UNION ALL " if p.all else " UNION "
        return op.join(f"({_relation_sql(i)})" for i in p.inputs)
    if isinstance(p, L.Window):
        frm = _from_sql(p.input)
        if frm.endswith("AS _t"):
            base_cols = [_q(f.name) for f in p.input.schema.fields]
            wins = [expr_to_sql(_strip_quals(e)) for e in p.window_exprs]
        else:
            base_cols = [f"{f.qualifier}.{_q(f.name)}" if f.qualifier else _q(f.name)
                         for f in p.input.schema.fields]
            wins = [expr_to_sql(e) for e in p.window_exprs]
        return f"SELECT {', '.join(base_cols + wins)} FROM {frm}"
    return f"SELECT * FROM {_from_sql(p)}"


def _from_sql(p: L.LogicalPlan) -> str:
    """Render a plan as a FROM-clause relation."""
    if isinstance(p, L.TableScan):
        if p.alias and p.alias != p.name:
            return f"{p.name} AS {p.alias}"
        return p.name
    if isinstance(p, L.SubqueryAlias):
        return f"({_relation_sql(p.input)}) AS {p.alias}"
    if isinstance(p, L.Join):
        left = _from_sql(p.left)
        right = _from_sql(p.right)
        jt = {
            L.JoinType.INNER: "JOIN", L.JoinType.LEFT: "LEFT JOIN",
            L.JoinType.RIGHT: "RIGHT JOIN", L.JoinType.FULL: "FULL JOIN",
            L.JoinType.CROSS: "CROSS JOIN",
        }.get(p.join_type)
        if jt is None:
            raise PlanError(f"cannot unparse join type {p.join_type}")
        if p.join_type is L.JoinType.CROSS or not p.on:
            return f"{left} CROSS JOIN {right}"
        conds = [f"{expr_to_sql(l)} = {expr_to_sql(r)}" for l, r in p.on]
        if p.filter is not None:
            conds.append(expr_to_sql(p.filter))
        return f"{left} {jt} {right} ON {' AND '.join(conds)}"
    if isinstance(p, L.Filter):
        # filter under a FROM position: wrap as derived table
        return f"({_relation_sql(p)}) AS _t"
    return f"({_relation_sql(p)}) AS _t"
