# Verbatim copy of datafusion_tpu/optimizer/dedup.py; host-only, kept in step with the original.
"""Common sub-plan deduplication (CTE compute-once restoration).

Structurally identical sub-plans are unified to ONE shared object so the
physical planner's identity memo (physical/planner.py) plans them once and
the fused executor computes them once.  This is the engine's analog of the
reference keeping CTE work areas shared (datafusion/optimizer/src/
common_subexpr_eliminate.rs works at the expression level; here whole
sub-plans are deduplicated, which is what matters for a fused one-program
execution model).

Why a separate pass: rules like decorrelation lift subquery bodies out of
expressions into join inputs.  The lifted body is a copy whose object
identity has diverged from the in-tree CTE sub-plan (expression-embedded
plans are not reachable by transform_up's identity memo), so TPC-H Q15's
`revenue` view would otherwise be computed twice.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..logical import plan as L


def _node_key(p: L.LogicalPlan):
    """Salient non-child attributes of one node.  Expressions are frozen
    dataclasses (structural eq/hash); subquery expressions embed plans that
    compare by identity, which conservatively prevents dedup of un-lifted
    subqueries."""
    if isinstance(p, L.TableScan):
        return (p.name, id(p.source),
                tuple(p.projection) if p.projection is not None else None,
                tuple(p.filters), p.alias)
    if isinstance(p, L.EmptyRelation):
        return (p.produce_one_row,)
    if isinstance(p, L.Values):
        return (id(p),)  # literal rows: cheap, never worth unifying
    if isinstance(p, L.Projection):
        return (p.proj_exprs,)
    if isinstance(p, L.Filter):
        return (p.predicate,)
    if isinstance(p, L.Aggregate):
        return (p.group_exprs, p.aggr_exprs)
    if isinstance(p, L.Sort):
        return (p.sort_specs, p.fetch)
    if isinstance(p, L.Limit):
        return (p.skip, p.fetch)
    if isinstance(p, L.Join):
        return (p.on, p.join_type, p.filter)
    if isinstance(p, L.SubqueryAlias):
        return (p.alias,)
    if isinstance(p, L.Distinct):
        return ()
    if isinstance(p, L.Union):
        return (p.all,)
    if isinstance(p, L.Unnest):
        return (p.unnest_exprs, p.names)
    if isinstance(p, L.Window):
        return (p.window_exprs,)
    return (id(p),)  # unknown node: never deduplicate


def dedup_subplans(plan: L.LogicalPlan) -> L.LogicalPlan:
    table: Dict[Tuple, L.LogicalPlan] = {}
    memo: Dict[int, Tuple[Tuple, L.LogicalPlan]] = {}

    def fp(p: L.LogicalPlan) -> Tuple[Tuple, L.LogicalPlan]:
        hit = memo.get(id(p))
        if hit is not None:
            return hit
        child_keys = []
        new_children = []
        changed = False
        for c in p.children():
            ck, nc = fp(c)
            child_keys.append(ck)
            new_children.append(nc)
            changed = changed or nc is not c
        schema_sig = tuple((f.qualifier, f.name, repr(f.dtype))
                           for f in p.schema.fields)
        try:
            key = (type(p).__name__, tuple(child_keys), _node_key(p),
                   schema_sig)
            hash(key)
        except TypeError:  # unhashable attribute: identity key, no dedup
            key = (type(p).__name__, tuple(child_keys), id(p), schema_sig)
        known = table.get(key)
        if known is None:
            known = p.with_children(new_children) if changed else p
            table[key] = known
        out = (key, known)
        memo[id(p)] = out
        return out

    return fp(plan)[1]


def dedup_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    return dedup_subplans(plan)
