"""Physical planner: LogicalPlan -> PhysicalPlan.

Port of datafusion_tpu/physical/planner.py for the node kinds this package
executes: scans, filters (a rank filter over a window as a per-partition
top-k), projections, aggregates, DISTINCT, sorts, limits, aliases, joins
(cross joins and scalar subqueries as joins on a constant key, one
inequality between the sides as a range join), UNION ALL, VALUES, empty
relations, windows, UNNEST and recursive queries."""
from __future__ import annotations

from ..common.errors import PlanError
from ..data.device import DeviceRelation
from ..expr import nodes as E
from ..logical import plan as L
from . import plan as P

class AliasExec(P.PhysicalPlan):
    """Schema-renaming passthrough (SubqueryAlias)."""

    def __init__(self, input: P.PhysicalPlan, schema):
        self.input = input
        self.schema = schema

    def children(self):
        return (self.input,)

    def execute(self, ctx):
        rel = self.input.execute(ctx)
        return DeviceRelation(self.schema, rel.columns, rel.sel)


def create_physical_plan(plan: L.LogicalPlan, _memo=None) -> P.PhysicalPlan:
    """LogicalPlan -> PhysicalPlan. Shared logical sub-plans (CTEs referenced
    more than once) map to ONE physical operator instance."""
    top = _memo is None
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(plan))
    if hit is not None:
        return hit
    out = _create(plan, _memo)
    _memo[id(plan)] = out
    if top:
        from .sanity import validate_plan

        validate_plan(out)
    return out


def _create(plan: L.LogicalPlan, _memo) -> P.PhysicalPlan:
    def child(p):
        return create_physical_plan(p, _memo)

    if isinstance(plan, L.TableScan):
        node: P.PhysicalPlan = P.ScanExec(plan.source, plan.schema,
                                          plan.projection, plan.alias,
                                          plan.filters)
        for f in plan.filters:
            node = P.FilterExec(node, f)
        return node
    if isinstance(plan, L.Projection):
        return P.ProjectionExec(child(plan.input), plan.proj_exprs, plan.schema)
    if isinstance(plan, L.Filter):
        from .window import rewrite_window_topk

        f = P.FilterExec(child(plan.input), plan.predicate)
        tk = rewrite_window_topk(f)
        return tk if tk is not None else f
    if isinstance(plan, L.Aggregate):
        _reject_list_keys(plan.group_exprs, plan.input.schema, "GROUP BY")
        inp = child(plan.input)
        if plan.group_exprs:
            inp = _maybe_compact(inp)
        return P.AggregateExec(inp, plan.group_exprs, plan.aggr_exprs, plan.schema)
    if isinstance(plan, L.Sort):
        _reject_list_keys([s_.expr for s_ in plan.sort_specs],
                          plan.input.schema, "ORDER BY")
        inp = child(plan.input)
        from .ordering import ordering_satisfies

        if ordering_satisfies(inp, plan.sort_specs):
            s = P.SortExec(inp, plan.sort_specs, plan.fetch, presorted=True)
        else:
            s = P.SortExec(_maybe_compact(inp), plan.sort_specs, plan.fetch)
        _attach_topk_hint(s)
        return s
    if isinstance(plan, L.Limit):
        return P.LimitExec(child(plan.input), plan.skip, plan.fetch)
    if isinstance(plan, L.Join):
        left = child(plan.left)
        right = child(plan.right)
        if plan.join_type is L.JoinType.CROSS or not plan.on:
            return _cross_join(left, right, plan)
        _reject_list_keys([l for l, _ in plan.on], plan.left.schema, "join keys")
        return P.JoinExec(_maybe_compact(left), _maybe_compact(right), plan.on,
                          plan.join_type, plan.filter, plan.schema)
    if isinstance(plan, L.SubqueryAlias):
        return AliasExec(child(plan.input), plan.schema)
    if isinstance(plan, L.Distinct):
        _reject_list_keys([E.Column(f.name, f.qualifier)
                           for f in plan.input.schema.fields],
                          plan.input.schema, "DISTINCT")
        return P.DistinctExec(_maybe_compact(child(plan.input)))
    if isinstance(plan, L.Union):
        return P.UnionExec([child(p) for p in plan.inputs], plan.schema)
    if isinstance(plan, L.Values):
        return P.ValuesExec(plan.schema, plan.rows)
    if isinstance(plan, L.EmptyRelation):
        return P.EmptyExec(plan.schema, plan.produce_one_row)
    if isinstance(plan, L.Window):
        from .window import WindowExec

        return WindowExec(_maybe_compact(child(plan.input)), plan.window_exprs,
                          plan.schema)
    if isinstance(plan, L.Unnest):
        return P.UnnestExec(child(plan.input), plan.unnest_exprs, plan.schema)
    if isinstance(plan, L.RecursiveQuery):
        return P.RecursiveQueryExec(child(plan.static_plan),
                                    child(plan.recursive_plan),
                                    plan.work_table, plan.schema, plan.name)
    raise PlanError(f"no physical plan for {type(plan).__name__}")


def _attach_topk_hint(s: P.SortExec) -> None:
    """When a TopK (Sort with fetch) sits over a bare scan chain, record
    (key column, k, desc) on the ScanExec so its provider can push the k-th
    key value back into pruning (ScanExec._topk_filters; reference:
    topk/mod.rs:113 DynamicFilterPhysicalExpr). Inclusive thresholds keep
    ties, so a weaker first-key-only bound stays exact for multi-key sorts.
    FilterExec aborts the walk: a post-filter k-th value is deeper than the
    unfiltered one, and an unfiltered threshold could prune qualifying
    rows."""
    if s.fetch is None or not (0 < s.fetch <= (1 << 16)) or not s.specs:
        return
    e = s.specs[0].expr
    if isinstance(e, E.Alias):
        e = e.expr
    if not isinstance(e, E.Column):
        return
    name = e.cname
    node = s.input
    while name is not None:
        if isinstance(node, (P.CompactExec, AliasExec)):
            node = node.input
            continue
        if isinstance(node, P.ProjectionExec):
            mapped = None
            for f, pe in zip(node.schema.fields, node.exprs):
                if f.name != name:
                    continue
                base = pe.expr if isinstance(pe, E.Alias) else pe
                mapped = base.cname if isinstance(base, E.Column) else None
                break
            name = mapped
            node = node.input
            continue
        break
    if name is None or not isinstance(node, P.ScanExec):
        return
    if name not in {f.name for f in node.schema.fields}:
        return
    node._topk_hint = (name, int(s.fetch), not s.specs[0].asc)


def _maybe_compact(p: P.PhysicalPlan) -> P.PhysicalPlan:
    """Wrap a grouped aggregate's, sort's or join's input in CompactExec when
    the subtree can produce a sparse selection mask (filters, joins other
    than FULL, top-k, limits, unnest). Execution turns the node into identity when
    the input is in fact dense."""
    if _sparse_producer(p):
        return P.CompactExec(p)
    return p


def _sparse_producer(p: P.PhysicalPlan) -> bool:
    if isinstance(p, (P.FilterExec, P.LimitExec, P.UnnestExec)):
        return True
    if isinstance(p, P.JoinExec):
        # semi/anti only mask; INNER/LEFT direct-address joins keep the
        # probe's capacity with a (often sparse) mask
        return p.join_type is not L.JoinType.FULL
    if isinstance(p, P.SortExec):
        return p.fetch is not None
    if isinstance(p, (P.ProjectionExec, AliasExec)):
        return _sparse_producer(p.input)
    return False


def _reject_list_keys(exprs, schema, where: str):
    """Sort/group keys must be flat values: list columns have no total order
    in the engine."""
    from ..expr.typing import infer

    for e in exprs:
        dt, _ = infer(e, schema)
        if dt.is_list:
            raise PlanError(
                f"list-typed expression {e.name()!r} cannot be used in "
                f"{where}; unnest it first")


_RANGE_OPS = {E.Op.LT: "lt", E.Op.LE: "le", E.Op.GT: "gt", E.Op.GE: "ge"}


def _extract_range_predicate(plan: L.Join):
    """Split the join filter into (left_expr, right_expr, op) for ONE
    inequality comparing a left-side expression against a right-side one,
    plus the residual conjuncts. Returns (range_on, residual) or
    (None, None) without a filter."""
    from ..optimizer.decorrelate import conjoin, split_conjuncts

    if plan.filter is None:
        return None, None
    lsch, rsch = plan.left.schema, plan.right.schema

    def only_in(e, schema):
        cols = E.collect_columns(e)
        if not cols:
            return False
        try:
            return all(schema.find(c.flat_name) is not None for c in cols)
        except Exception:  # noqa: BLE001 -- ambiguous name
            return False

    range_on = None
    rest = []
    for conj in split_conjuncts(plan.filter):
        if range_on is None and isinstance(conj, E.BinaryOp) \
                and conj.op in _RANGE_OPS:
            l, r = conj.left, conj.right
            if only_in(l, lsch) and only_in(r, rsch):
                range_on = (l, r, _RANGE_OPS[conj.op])
                continue
            if only_in(r, lsch) and only_in(l, rsch):
                mirror = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
                range_on = (r, l, mirror[_RANGE_OPS[conj.op]])
                continue
        rest.append(conj)
    return range_on, conjoin(rest)


def _cross_join(left: P.PhysicalPlan, right: P.PhysicalPlan, plan: L.Join) -> P.PhysicalPlan:
    """Cross join as an equi-join on a constant key (both sides key 1): the
    expansion produces the cartesian product and any filter is a residual.
    A filter holding one inequality between the sides takes the range join
    instead, unless one side is provably one row (TPC-H Q11's and Q22's
    scalar subqueries), where the constant-key join is cheaper."""
    jt = plan.join_type if plan.join_type is not L.JoinType.CROSS else L.JoinType.INNER
    range_on, residual = _extract_range_predicate(plan)
    if range_on is not None and not (_single_row(plan.left) or
                                     _single_row(plan.right)):
        return P.JoinExec(left, right, [], jt, residual, plan.schema,
                          range_on=range_on)
    one = E.lit(1)
    return P.JoinExec(left, right, [(one, one)], jt, plan.filter, plan.schema)


def _single_row(p: L.LogicalPlan) -> bool:
    """Provably at most one row: an ungrouped aggregate, a one-row VALUES,
    a one-row empty relation or LIMIT 1."""
    while isinstance(p, (L.Projection, L.SubqueryAlias)):
        p = p.input
    if isinstance(p, L.Aggregate):
        return len(p.group_exprs) == 0
    if isinstance(p, L.Values):
        return len(p.rows) == 1
    if isinstance(p, L.EmptyRelation):
        return bool(getattr(p, "produce_one_row", False))
    if isinstance(p, L.Limit):
        return p.fetch is not None and p.fetch <= 1
    return False
