# Verbatim copy of datafusion_tpu/optimizer/simplify.py; host-only, kept in step with the original.
"""Expression simplification / constant folding.

Capability analog of the reference's ExprSimplifier
(datafusion/optimizer/src/simplify_expressions/): folds literal-only subtrees
at plan time (notably date +/- interval arithmetic, so device kernels only see
pre-computed date literals), flattens double negation, prunes trivial
boolean identities."""
from __future__ import annotations

import numpy as np

from ..common import types as T
from ..expr import nodes as E
from ..utils import dates as DU


def _lit_date_days(l: E.Literal) -> int:
    if isinstance(l.value, (int, np.integer)):
        return int(l.value)
    return DU.date_str_to_days(str(l.value))


def fold_expr(e: E.Expr) -> E.Expr:
    return E.map_expr(e, _fold_node)


def _split(e: E.Expr, op: E.Op) -> list:
    if isinstance(e, E.BinaryOp) and e.op is op:
        return _split(e.left, op) + _split(e.right, op)
    return [e]


def _join(parts: list, op: E.Op) -> E.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = E.BinaryOp(op, out, p)
    return out


def _factor_or(e: E.BinaryOp):
    """(A AND X) OR (A AND Y) -> A AND (X OR Y). Sound in Kleene 3VL
    (AND/OR distribute). The reference does the same common-factor
    extraction in ExprSimplifier (simplify_expressions/); it is what lets
    disjunctive correlated predicates (TPC-DS q41) decorrelate."""
    disjuncts = [_split(d, E.Op.AND) for d in _split(e, E.Op.OR)]
    if len(disjuncts) < 2:
        return None
    common = [c for c in disjuncts[0]
              if all(c in d for d in disjuncts[1:])]
    if not common:
        return None
    rests = []
    for d in disjuncts:
        seen = list(common)
        rest = []
        for c in d:
            if c in seen:
                seen.remove(c)
            else:
                rest.append(c)
        if not rest:
            # this disjunct is exactly the common factor: A OR (A AND Y) = A
            return _join(common, E.Op.AND)
        rests.append(_join(rest, E.Op.AND))
    return E.BinaryOp(E.Op.AND, _join(common, E.Op.AND),
                      _join(rests, E.Op.OR))


def _fold_node(e: E.Expr) -> E.Expr:
    if isinstance(e, E.BinaryOp) and e.op.is_comparison \
            and isinstance(e.left, E.Literal) and isinstance(e.right, E.Literal):
        l, r = e.left, e.right
        if l.value is None or r.value is None:
            return E.Literal(None, T.BOOL)  # 3VL: NULL cmp x = NULL
        comparable = (
            (l.dtype.is_numeric and r.dtype.is_numeric)
            or (l.dtype.is_string and r.dtype.is_string)
            or (l.dtype.kind == r.dtype.kind))
        if comparable:
            try:
                lv, rv = l.value, r.value
                v = {E.Op.EQ: lv == rv, E.Op.NEQ: lv != rv,
                     E.Op.LT: lv < rv, E.Op.LE: lv <= rv,
                     E.Op.GT: lv > rv, E.Op.GE: lv >= rv}[e.op]
                return E.Literal(bool(v), T.BOOL)
            except Exception:
                return e
        return e
    if isinstance(e, E.BinaryOp) and isinstance(e.left, E.Literal) and isinstance(e.right, E.Literal):
        l, r = e.left, e.right
        # date +/- interval
        if l.dtype.kind is T.TypeKind.DATE32 and r.dtype.kind is T.TypeKind.INTERVAL_DAYS:
            days = _lit_date_days(l)
            d = int(r.value) if e.op is E.Op.ADD else -int(r.value)
            return E.Literal(days + d, T.DATE32)
        if l.dtype.kind is T.TypeKind.DATE32 and r.dtype.kind is T.TypeKind.INTERVAL_MONTHS:
            days = _lit_date_days(l)
            m = int(r.value) if e.op is E.Op.ADD else -int(r.value)
            out = DU.add_months(np.array([days], np.int32), np.array([m], np.int64))
            return E.Literal(int(np.asarray(out)[0]), T.DATE32)
        if l.dtype.is_decimal and r.dtype.is_decimal and l.value is not None and r.value is not None \
                and e.op in (E.Op.ADD, E.Op.SUB):
            s = max(l.dtype.scale, r.dtype.scale)
            li = int(round(float(l.value) * 10 ** s))
            ri = int(round(float(r.value) * 10 ** s))
            v = li + ri if e.op is E.Op.ADD else li - ri
            return E.Literal(v / 10 ** s, T.decimal(38, s))
        if l.dtype.is_numeric and r.dtype.is_numeric and l.value is not None and r.value is not None:
            try:
                lv, rv = l.value, r.value
                if e.op is E.Op.ADD:
                    v = lv + rv
                elif e.op is E.Op.SUB:
                    v = lv - rv
                elif e.op is E.Op.MUL:
                    v = lv * rv
                elif e.op is E.Op.DIV:
                    if rv == 0:
                        return e
                    v = lv / rv if (isinstance(lv, float) or isinstance(rv, float)) else lv // rv
                else:
                    return e
                if isinstance(v, float):
                    return E.Literal(v, T.FLOAT64)
                return E.Literal(v, T.INT64)
            except Exception:
                return e
    if isinstance(e, E.BinaryOp) and e.op.is_logic:
        # 3VL-sound short circuits: x AND FALSE = FALSE, x AND TRUE = x,
        # x OR TRUE = TRUE, x OR FALSE = x (even when x is NULL)
        for a, b in ((e.left, e.right), (e.right, e.left)):
            if isinstance(a, E.Literal) and a.value is not None:
                if e.op is E.Op.AND:
                    return b if a.value else E.Literal(False, T.BOOL)
                return E.Literal(True, T.BOOL) if a.value else b
    if isinstance(e, E.Not) and isinstance(e.expr, E.Literal) \
            and e.expr.dtype.kind is T.TypeKind.BOOL:
        v = e.expr.value
        return E.Literal(None if v is None else not v, T.BOOL)
    if isinstance(e, E.Not) and isinstance(e.expr, E.Not):
        return e.expr.expr
    if isinstance(e, E.BinaryOp) and e.op is E.Op.OR:
        out = _factor_or(e)
        if out is not None:
            return out
    if isinstance(e, E.Cast) and isinstance(e.expr, E.Literal):
        l = e.expr
        if e.dtype.kind is T.TypeKind.DATE32 and l.dtype.is_string:
            return E.Literal(DU.date_str_to_days(str(l.value)), T.DATE32)
        if e.dtype == l.dtype:
            return l
    return e
