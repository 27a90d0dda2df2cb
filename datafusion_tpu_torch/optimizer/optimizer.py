# Verbatim copy of datafusion_tpu/optimizer/optimizer.py; host-only, kept in step with the original.
"""Logical optimizer driver.

Capability analog of the reference's Analyzer + Optimizer
(datafusion/optimizer/src/{analyzer/mod.rs:88, optimizer.rs:255}): a fixed
sequence of rewrite rules applied until fixpoint (bounded passes).  Rules are
plain functions LogicalPlan -> LogicalPlan."""
from __future__ import annotations

from typing import Callable, List

from ..expr import nodes as E
from ..logical import plan as L
from .simplify import fold_expr


def _name_preserving(fn: Callable[[E.Expr], E.Expr]) -> Callable[[E.Expr], E.Expr]:
    """Wrap a rewrite so output-defining exprs keep their original column
    name (the reference's rule invariant: optimizer rules must not change a
    plan's output schema — optimizer/src/optimizer.rs name preservation;
    rewritten exprs get re-aliased to the old name)."""

    def wrapped(e: E.Expr) -> E.Expr:
        ne = fn(e)
        if ne is not e and ne.name() != e.name():
            return E.Alias(ne, e.name())
        return ne

    return wrapped


def rewrite_exprs(plan: L.LogicalPlan, fn: Callable[[E.Expr], E.Expr]) -> L.LogicalPlan:
    """Apply an expression rewrite to every expression of one plan node."""
    if isinstance(plan, L.Projection):
        nfn = _name_preserving(fn)
        return L.Projection(plan.input, [nfn(e) for e in plan.proj_exprs])
    if isinstance(plan, L.Filter):
        return L.Filter(plan.input, fn(plan.predicate))
    if isinstance(plan, L.Aggregate):
        nfn = _name_preserving(fn)
        return L.Aggregate(plan.input, [nfn(e) for e in plan.group_exprs],
                           [nfn(e) for e in plan.aggr_exprs])
    if isinstance(plan, L.Sort):
        specs = []
        for s in plan.sort_specs:
            ns = fn(s)
            specs.append(ns if isinstance(ns, E.SortSpec) else E.SortSpec(ns, s.asc, s.nulls_first))
        return L.Sort(plan.input, specs, plan.fetch)
    if isinstance(plan, L.Join):
        on = [(fn(l), fn(r)) for l, r in plan.on]
        filt = fn(plan.filter) if plan.filter is not None else None
        return L.Join(plan.left, plan.right, on, plan.join_type, filt)
    if isinstance(plan, L.Window):
        nfn = _name_preserving(fn)
        return L.Window(plan.input, [nfn(e) for e in plan.window_exprs])
    if isinstance(plan, L.TableScan) and plan.filters:
        return L.TableScan(plan.name, plan.source, plan.projection,
                           [fn(f) for f in plan.filters], plan.alias)
    return plan


def simplify_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    return L.transform_up(plan, lambda p: rewrite_exprs(p, fold_expr))


def optimize(plan: L.LogicalPlan, catalog=None, options=None) -> L.LogicalPlan:
    """Run the rule sequence; each rule group is gated by its config flag
    (reference: OptimizerRule list in optimizer.rs:291-318; rules are
    individually skippable there by replacing the rule set)."""
    from .cleanup import cleanup_rules, filter_null_join_keys_rule
    from .decorrelate import decorrelate_rule
    from .dedup import dedup_rule
    from .pushdown import (eliminate_outer_joins_rule, limit_into_sort_rule,
                           or_implication_rule, projection_pruning_rule,
                           prune_join_columns_rule, push_filters_rule,
                           reorder_joins_rule,
                           semi_join_through_aggregate_rule)

    opts = options or {}

    def on(key: str) -> bool:
        return bool(opts.get(key, True))

    rules: List[Callable] = []
    simplify = on("optimizer.simplify_expressions")
    pushdown = on("optimizer.filter_pushdown")
    dedup = on("optimizer.common_subplan_dedup")
    if simplify:
        rules.append(simplify_rule)
    if on("optimizer.decorrelate_subqueries"):
        rules.append(decorrelate_rule)
        if simplify:
            rules.append(simplify_rule)
    if dedup:
        rules.append(dedup_rule)  # unify sub-plans duplicated by subquery lifting
    if on("optimizer.plan_cleanup"):
        rules.append(cleanup_rules)  # constant filters/limits, empties, dups
    if on("optimizer.eliminate_outer_joins"):
        rules.append(eliminate_outer_joins_rule)  # LEFT/RIGHT/FULL -> INNER
    if on("optimizer.filter_null_join_keys"):
        rules.append(filter_null_join_keys_rule)
    if pushdown:
        rules.append(or_implication_rule)  # pushable per-column preds (Q7/Q19)
        rules.append(push_filters_rule)
    if on("optimizer.join_reorder"):
        rules.append(reorder_joins_rule)
    if pushdown:
        rules.append(push_filters_rule)
        rules.append(semi_join_through_aggregate_rule)
    if on("optimizer.late_materialization"):
        from .latemat import late_materialization_rule

        # before projection pruning: dropped group keys must disappear from
        # the join tree's carried columns in the same optimize() run
        rules.append(late_materialization_rule)
    if on("optimizer.projection_pruning"):
        rules.append(projection_pruning_rule)
        rules.append(prune_join_columns_rule)
    if on("optimizer.limit_into_sort"):
        rules.append(limit_into_sort_rule)
    if dedup:
        rules.append(dedup_rule)
    for rule in rules:
        plan = rule(plan)
    return plan
