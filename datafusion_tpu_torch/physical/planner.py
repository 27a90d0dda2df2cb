"""Physical planner: LogicalPlan -> PhysicalPlan.

Port of datafusion_tpu/physical/planner.py for the node kinds this package
executes: scans, filters, projections, aggregates, DISTINCT, sorts, limits
and aliases. Every other node kind raises NotImplementedError naming the ROADMAP
item that ports it, so an unsupported query fails at planning time instead
of returning a wrong answer."""
from __future__ import annotations

from ..common.errors import PlanError
from ..data.device import DeviceRelation
from ..expr import nodes as E
from ..logical import plan as L
from . import plan as P

# logical node kind -> the ROADMAP item (queue 1) that ports its operator
_NOT_PORTED = {
    L.Join: "item 6 'Joins'",
    L.Window: "item 8 'physical/window.py'",
    L.Unnest: "item 9 'Function and nested-type breadth'",
    L.Union: "item 12 'Remaining surface'",
    L.Values: "item 12 'Remaining surface'",
    L.EmptyRelation: "item 12 'Remaining surface'",
    L.RecursiveQuery: "item 12 'Remaining surface'",
}


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
        return P.FilterExec(child(plan.input), plan.predicate)
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
            return P.SortExec(inp, plan.sort_specs, plan.fetch, presorted=True)
        return P.SortExec(_maybe_compact(inp), plan.sort_specs, plan.fetch)
    if isinstance(plan, L.Limit):
        return P.LimitExec(child(plan.input), plan.skip, plan.fetch)
    if isinstance(plan, L.SubqueryAlias):
        return AliasExec(child(plan.input), plan.schema)
    if isinstance(plan, L.Distinct):
        _reject_list_keys([E.Column(f.name, f.qualifier)
                           for f in plan.input.schema.fields],
                          plan.input.schema, "DISTINCT")
        return P.DistinctExec(_maybe_compact(child(plan.input)))
    for kind, item in _NOT_PORTED.items():
        if isinstance(plan, kind):
            raise NotImplementedError(
                f"{type(plan).__name__} is not ported to datafusion_tpu_torch "
                f"yet (ROADMAP queue 1, {item})")
    raise PlanError(f"no physical plan for {type(plan).__name__}")


def _maybe_compact(p: P.PhysicalPlan) -> P.PhysicalPlan:
    """Wrap a grouped aggregate's or sort's input in CompactExec when the
    subtree can produce a sparse selection mask (filters, top-k, limits).
    Execution turns the node into identity when the input is in fact dense."""
    if _sparse_producer(p):
        return P.CompactExec(p)
    return p


def _sparse_producer(p: P.PhysicalPlan) -> bool:
    if isinstance(p, (P.FilterExec, P.LimitExec)):
        return True
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
