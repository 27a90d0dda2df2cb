# Verbatim copy of datafusion_tpu/optimizer/cost.py; host-only, kept in step with the original.
"""Plan cardinality estimation for cost-based join ordering.

Capability analog of the reference's statistics propagation + join
cardinality model (datafusion/physical-plan/src/joins/utils.rs
estimate_join_statistics, common/src/stats.rs).  Estimates drive ONLY
ordering decisions; execution uses exact capacity discovery, so estimation
errors cost performance, never correctness.

Formulas (classic System-R style):
- equi-join:   |L JOIN R| = |L|*|R| / max(ndv(lk), ndv(rk)) per key pair
- semi-join:   |L SEMI R| = |L| * min(1, ndv(rk)/ndv(lk))
- anti-join:   |L ANTI R| = |L| - |L SEMI R| (floored at 1)
- filters:     1/ndv for equality, range fraction via min/max, 0.3 default
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..common.stats import ColumnStatistics, Statistics
from ..expr import nodes as E
from ..logical import plan as L

ColKey = Tuple[Optional[str], str]

DEFAULT_SEL = 0.3
EQ_SEL = 0.1
LIKE_SEL = 0.25


@dataclasses.dataclass
class PlanEst:
    rows: float
    cols: Dict[ColKey, ColumnStatistics]

    def col(self, c: E.Column) -> Optional[ColumnStatistics]:
        hit = self.cols.get((c.qualifier, c.cname))
        if hit is not None:
            return hit
        if c.qualifier is None:
            matches = [v for (q, n), v in self.cols.items() if n == c.cname]
            if len(matches) == 1:
                return matches[0]
        else:  # qualified lookup may see an unqualified propagated column
            return self.cols.get((None, c.cname))
        return None

    def scaled(self, frac: float) -> "PlanEst":
        rows = max(1.0, self.rows * frac)
        return PlanEst(rows, {k: v.scaled(frac, rows)
                              for k, v in self.cols.items()})


def _lit_ordinal(e: E.Expr) -> Optional[float]:
    if isinstance(e, E.Literal) and e.value is not None:
        try:
            return float(e.value)
        except (TypeError, ValueError):
            return None
    return None


def _ndv(est: PlanEst, c: E.Column) -> Optional[float]:
    s = est.col(c)
    return None if s is None or s.ndv is None else max(s.ndv, 1.0)


def selectivity(e: E.Expr, est: PlanEst) -> float:
    """Fraction of rows satisfying predicate `e` (clamped to [1e-7, 1])."""
    return max(1e-7, min(1.0, _sel(e, est)))


def _sel(e: E.Expr, est: PlanEst) -> float:
    if isinstance(e, E.Literal):
        if e.value is True:
            return 1.0
        if e.value in (False, None):
            return 0.0
        return DEFAULT_SEL
    if isinstance(e, E.Alias):
        return _sel(e.expr, est)
    if isinstance(e, E.Not):
        return 1.0 - _sel(e.expr, est)
    if isinstance(e, E.BinaryOp):
        if e.op is E.Op.AND:
            return _sel(e.left, est) * _sel(e.right, est)
        if e.op is E.Op.OR:
            a, b = _sel(e.left, est), _sel(e.right, est)
            return a + b - a * b
        col, lit, op = _col_lit(e)
        if col is not None:
            return _cmp_sel(col, lit, op, est)
        if e.op is E.Op.EQ:
            return EQ_SEL
        if e.op is E.Op.NEQ:
            return 1.0 - EQ_SEL
        if e.op in (E.Op.LT, E.Op.LE, E.Op.GT, E.Op.GE):
            return DEFAULT_SEL
        return DEFAULT_SEL
    if isinstance(e, E.Between):
        s = _between_sel(e, est)
        return 1.0 - s if e.negated else s
    if isinstance(e, E.InList):
        s = _inlist_sel(e, est)
        return 1.0 - s if e.negated else s
    if isinstance(e, E.Like):
        return 1.0 - LIKE_SEL if e.negated else LIKE_SEL
    if isinstance(e, E.IsNull):
        if isinstance(e.expr, E.Column):
            s = est.col(e.expr)
            if s is not None and est.rows > 0:
                return min(1.0, s.null_count / est.rows)
        return 0.05
    return DEFAULT_SEL


def _col_lit(e: E.BinaryOp):
    """Normalize `col op lit` / `lit op col` to (col, lit_ordinal, op)."""
    flip = {E.Op.LT: E.Op.GT, E.Op.LE: E.Op.GE, E.Op.GT: E.Op.LT,
            E.Op.GE: E.Op.LE, E.Op.EQ: E.Op.EQ, E.Op.NEQ: E.Op.NEQ}
    left, right, op = e.left, e.right, e.op
    if isinstance(left, E.Cast):
        left = left.expr
    if isinstance(right, E.Cast):
        right = right.expr
    if isinstance(left, E.Column) and isinstance(right, E.Literal):
        return left, right, op
    if isinstance(right, E.Column) and isinstance(left, E.Literal) and op in flip:
        return right, left, flip[op]
    return None, None, None


def _cmp_sel(col: E.Column, lit: E.Literal, op: E.Op, est: PlanEst) -> float:
    s = est.col(col)
    if op is E.Op.EQ:
        d = _ndv(est, col)
        return 1.0 / d if d else EQ_SEL
    if op is E.Op.NEQ:
        d = _ndv(est, col)
        return 1.0 - (1.0 / d if d else EQ_SEL)
    v = _lit_ordinal(lit)
    if s is None or v is None or s.min_value is None or s.max_value is None:
        return DEFAULT_SEL
    span = s.max_value - s.min_value
    if span <= 0:
        return 1.0 if s.min_value == v else DEFAULT_SEL
    if op in (E.Op.LT, E.Op.LE):
        return (v - s.min_value) / span
    if op in (E.Op.GT, E.Op.GE):
        return (s.max_value - v) / span
    return DEFAULT_SEL


def _between_sel(e: E.Between, est: PlanEst) -> float:
    col = e.expr.expr if isinstance(e.expr, E.Cast) else e.expr
    if not isinstance(col, E.Column):
        return DEFAULT_SEL
    s = est.col(col)
    lo, hi = _lit_ordinal(e.low), _lit_ordinal(e.high)
    if (s is None or lo is None or hi is None or s.min_value is None
            or s.max_value is None or s.max_value <= s.min_value):
        return DEFAULT_SEL
    return max(0.0, (min(hi, s.max_value) - max(lo, s.min_value))
               / (s.max_value - s.min_value))


def _inlist_sel(e: E.InList, est: PlanEst) -> float:
    col = e.expr.expr if isinstance(e.expr, E.Cast) else e.expr
    if isinstance(col, E.Column):
        d = _ndv(est, col)
        if d:
            return min(1.0, len(e.values) / d)
    return min(1.0, len(e.values) * EQ_SEL)


# ---------------------------------------------------------------------------
# plan-level estimation
# ---------------------------------------------------------------------------


def estimate(plan: L.LogicalPlan, _memo=None) -> PlanEst:
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(plan))
    if hit is not None:
        return hit
    out = _estimate(plan, _memo)
    _memo[id(plan)] = out
    return out


def _scan_est(p: L.TableScan) -> PlanEst:
    try:
        st = p.source.statistics()
    except Exception:
        return PlanEst(1000.0, {})
    if not isinstance(st, Statistics):
        # foreign providers (FFI plugins) may return arbitrary objects;
        # stats are advisory, so degrade to the default estimate
        rows = None
        try:
            rows = float(st.get("num_rows")) if isinstance(st, dict) else None
        except Exception:
            rows = None
        return PlanEst(rows if rows else 1000.0, {})
    cols: Dict[ColKey, ColumnStatistics] = {}
    for f in p.schema.fields:
        cs = st.columns.get(f.name)
        if cs is not None:
            if getattr(cs, "_ndv_exact", True) is False:
                exact = st.ndv(f.name)
                if exact is not None:
                    cs = dataclasses.replace(cs, ndv=exact)
            cols[(f.qualifier, f.name)] = cs
    est = PlanEst(max(1.0, st.num_rows), cols)
    for flt in p.filters:
        est = est.scaled(selectivity(flt, est))
    return est


def _estimate(p: L.LogicalPlan, memo) -> PlanEst:
    if isinstance(p, L.TableScan):
        return _scan_est(p)
    if isinstance(p, L.EmptyRelation):
        return PlanEst(1.0 if p.produce_one_row else 0.0, {})
    if isinstance(p, L.Values):
        return PlanEst(float(max(len(p.rows), 1)), {})
    if isinstance(p, L.Filter):
        inp = estimate(p.input, memo)
        return inp.scaled(selectivity(p.predicate, inp))
    if isinstance(p, L.Projection):
        inp = estimate(p.input, memo)
        cols: Dict[ColKey, ColumnStatistics] = {}
        for f, e in zip(p.schema.fields, p.proj_exprs):
            src = e.expr if isinstance(e, E.Alias) else e
            if isinstance(src, E.Column):
                s = inp.col(src)
                if s is not None:
                    cols[(f.qualifier, f.name)] = s
        return PlanEst(inp.rows, cols)
    if isinstance(p, L.SubqueryAlias):
        inp = estimate(p.input, memo)
        cols = {}
        for f in p.schema.fields:
            for (q, n), v in inp.cols.items():
                if n == f.name:
                    cols[(f.qualifier, f.name)] = v
                    break
        return PlanEst(inp.rows, cols)
    if isinstance(p, L.Aggregate):
        inp = estimate(p.input, memo)
        if not p.group_exprs:
            return PlanEst(1.0, {})
        groups = 1.0
        for g in p.group_exprs:
            src = g.expr if isinstance(g, E.Alias) else g
            if isinstance(src, E.Column):
                d = _ndv(inp, src)
                groups *= d if d else 100.0
            else:
                groups *= 100.0
        rows = max(1.0, min(inp.rows, groups))
        cols = {}
        for f, g in zip(p.schema.fields, p.group_exprs):
            src = g.expr if isinstance(g, E.Alias) else g
            if isinstance(src, E.Column):
                s = inp.col(src)
                if s is not None:
                    cols[(f.qualifier, f.name)] = dataclasses.replace(
                        s, ndv=min(rows, s.ndv) if s.ndv else s.ndv)
        return PlanEst(rows, cols)
    if isinstance(p, L.Sort):
        inp = estimate(p.input, memo)
        if p.fetch is not None:
            return PlanEst(min(inp.rows, float(p.fetch)), inp.cols)
        return inp
    if isinstance(p, L.Limit):
        inp = estimate(p.input, memo)
        rows = inp.rows - p.skip
        if p.fetch is not None:
            rows = min(rows, float(p.fetch))
        return PlanEst(max(0.0, rows), inp.cols)
    if isinstance(p, L.Distinct):
        inp = estimate(p.input, memo)
        return PlanEst(max(1.0, inp.rows * 0.5), inp.cols)
    if isinstance(p, L.Union):
        ests = [estimate(c, memo) for c in p.inputs]
        return PlanEst(sum(e.rows for e in ests), ests[0].cols if ests else {})
    if isinstance(p, L.Window):
        inp = estimate(p.input, memo)
        return PlanEst(inp.rows, inp.cols)
    if isinstance(p, L.Unnest):
        inp = estimate(p.input, memo)
        return PlanEst(inp.rows * 3.0, inp.cols)
    if isinstance(p, L.Join):
        return _join_est(p, memo)
    return PlanEst(1000.0, {})


def join_cardinality(left: PlanEst, right: PlanEst, on, join_type) -> PlanEst:
    """Estimated output of one join step; merged column stats."""
    cols = dict(left.cols)
    cols.update(right.cols)
    if join_type is L.JoinType.CROSS or not on:
        return PlanEst(max(1.0, left.rows * right.rows), cols)
    semi_frac = 1.0
    dl_prod = dr_prod = 1.0
    for lk, rk in on:
        dl = _ndv(left, lk) if isinstance(lk, E.Column) else None
        dr = _ndv(right, rk) if isinstance(rk, E.Column) else None
        dl = dl or max(left.rows, 1.0)
        dr = dr or max(right.rows, 1.0)
        dl_prod *= dl
        dr_prod *= dr
        semi_frac = min(semi_frac, min(1.0, dr / dl))
    # Composite keys: the independence assumption (divide by every key's ndv)
    # wildly underestimates FK-composite joins (lineitem x partsupp: 2.4k
    # estimated vs 6M true).  A side's per-key ndv product is only a valid
    # composite ndv while it fits that side's row count; an overflowing
    # product means the keys are correlated, so fall back to the other
    # side's (or, failing both, the row counts themselves).
    l_valid = dl_prod <= max(left.rows, 1.0)
    r_valid = dr_prod <= max(right.rows, 1.0)
    if l_valid and r_valid:
        divisor = max(dl_prod, dr_prod, 1.0)
    elif l_valid:
        divisor = max(dl_prod, 1.0)
    elif r_valid:
        divisor = max(dr_prod, 1.0)
    else:
        # both overflow: keys correlated on both sides. Divide by the larger
        # side's joint key ndv, upper-bounded per side by min(per-key ndv
        # product, rows). A pure FK -> composite-PK join (lineitem x
        # partsupp) then estimates ~the PK side's rows, while a reduced
        # chain joining a fact table on two keys (TPC-H Q5's
        # (o_orderkey, s_suppkey) against lineitem) keeps its reduction
        # instead of degenerating to "no reduction at all".
        bound_l = min(dl_prod, max(left.rows, 1.0))
        bound_r = min(dr_prod, max(right.rows, 1.0))
        divisor = max(bound_l, bound_r, 1.0)
    rows = left.rows * right.rows / divisor
    if join_type is L.JoinType.LEFT_SEMI:
        return PlanEst(max(1.0, left.rows * semi_frac), dict(left.cols))
    if join_type is L.JoinType.LEFT_ANTI:
        return PlanEst(max(1.0, left.rows * (1.0 - semi_frac)),
                       dict(left.cols))
    rows = max(1.0, rows)
    if join_type is L.JoinType.LEFT:
        rows = max(rows, left.rows)
    elif join_type is L.JoinType.RIGHT:
        rows = max(rows, right.rows)
    elif join_type is L.JoinType.FULL:
        rows = max(rows, left.rows + right.rows)
    return PlanEst(rows, cols)


def _join_est(p: L.Join, memo) -> PlanEst:
    left = estimate(p.left, memo)
    right = estimate(p.right, memo)
    out = join_cardinality(left, right, p.on, p.join_type)
    if p.filter is not None:
        out = out.scaled(selectivity(p.filter, out))
    return out
