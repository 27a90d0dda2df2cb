# Verbatim copy of datafusion_tpu/optimizer/cleanup.py; host-only, kept in step with the original.
"""Plan-cleanup rules: constant filters, empty-relation propagation,
degenerate limits, duplicated expressions, null join keys, constant group
keys.

Capability analogs of the reference's EliminateFilter, PropagateEmptyRelation,
EliminateLimit, EliminateDuplicatedExpr, FilterNullJoinKeys and
EliminateGroupByConstant rules (datafusion/optimizer/src/{eliminate_filter.rs,
propagate_empty_relation.rs, eliminate_limit.rs, eliminate_duplicated_expr.rs,
filter_null_join_keys.rs, eliminate_group_by_constant.rs}), re-stated over
this engine's plan IR.  Their value here is the same as there -- a folded
FALSE predicate or a pruned partition should erase whole subtrees before any
device program is built -- plus one TPU-specific payoff: every erased operator
is an XLA program that never has to compile.
"""
from __future__ import annotations

from typing import List, Optional

from ..expr import nodes as E
from ..expr.typing import infer
from ..logical import plan as L


def _false_literal(e: E.Expr) -> bool:
    return isinstance(e, E.Literal) and (e.value is None or e.value is False)


def _true_literal(e: E.Expr) -> bool:
    return isinstance(e, E.Literal) and e.value is True


def _empty(p: L.LogicalPlan) -> bool:
    return isinstance(p, L.EmptyRelation) and not p.produce_one_row


def _as_empty(schema) -> L.EmptyRelation:
    return L.EmptyRelation(False, schema)


def eliminate_filter_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Filter(TRUE) -> input; Filter(FALSE | NULL) -> empty relation."""

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, L.Filter):
            if _true_literal(p.predicate):
                return p.input
            if _false_literal(p.predicate):
                return _as_empty(p.schema)
        return p

    return L.transform_up(plan, f)


def eliminate_limit_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Limit(fetch=0) -> empty; Limit(skip=0, fetch=None) -> input."""

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, L.Limit):
            if p.fetch == 0:
                return _as_empty(p.schema)
            if p.skip == 0 and p.fetch is None:
                return p.input
        return p

    return L.transform_up(plan, f)


def propagate_empty_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Erase operators over provably-empty inputs (bottom-up, so empties
    introduced by eliminate_filter bubble all the way to the root)."""

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, (L.Projection, L.Filter, L.Sort, L.Limit,
                          L.Distinct, L.Window, L.SubqueryAlias, L.Unnest)):
            if _empty(p.children()[0]):
                return _as_empty(p.schema)
        if isinstance(p, L.Aggregate):
            # a GLOBAL aggregate over no rows still yields one row
            if p.group_exprs and _empty(p.input):
                return _as_empty(p.schema)
        if isinstance(p, L.Join):
            le, re_ = _empty(p.left), _empty(p.right)
            jt = p.join_type
            if jt in (L.JoinType.INNER, L.JoinType.CROSS) and (le or re_):
                return _as_empty(p.schema)
            if le and jt in (L.JoinType.LEFT, L.JoinType.LEFT_SEMI,
                             L.JoinType.LEFT_ANTI):
                return _as_empty(p.schema)
            if re_ and jt in (L.JoinType.RIGHT, L.JoinType.RIGHT_SEMI,
                              L.JoinType.RIGHT_ANTI):
                return _as_empty(p.schema)
            if re_ and jt is L.JoinType.LEFT_SEMI:
                return _as_empty(p.schema)
            if le and jt is L.JoinType.RIGHT_SEMI:
                return _as_empty(p.schema)
            if re_ and jt is L.JoinType.LEFT_ANTI:
                return p.left  # nothing to reject: pass-through
            if le and jt is L.JoinType.RIGHT_ANTI:
                return p.right
        if isinstance(p, L.Union):
            keep = [c for c in p.inputs if not _empty(c)]
            if not keep:
                return _as_empty(p.schema)
            if len(keep) == 1:
                only = keep[0]
                # re-alias to the union's output names (they come from the
                # FIRST input, which may be the branch that was dropped)
                if [f.name for f in only.schema.fields] != \
                        [f.name for f in p.schema.fields]:
                    only = L.Projection(only, [
                        E.Alias(E.Column(cf.name, cf.qualifier), uf.name)
                        for cf, uf in zip(only.schema.fields,
                                          p.schema.fields)])
                return only if p.all else L.Distinct(only)
            if len(keep) != len(p.inputs):
                return L.Union(keep, p.all)
        return p

    return L.transform_up(plan, f)


def dedup_exprs_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Drop exact-duplicate sort keys and group-by keys (reference:
    EliminateDuplicatedExpr). Duplicates appear from ORDER BY lists that
    repeat columns and from GROUP BY a, a."""

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, L.Sort):
            # structural equality (qualifiers count); a repeated key cannot
            # re-order rows already tied on it, whatever its direction
            seen, specs = set(), []
            for s in p.sort_specs:
                if s.expr not in seen:
                    seen.add(s.expr)
                    specs.append(s)
            if len(specs) != len(p.sort_specs):
                return L.Sort(p.input, specs, p.fetch)
        if isinstance(p, L.Aggregate):
            seen, groups = set(), []
            for g in p.group_exprs:
                if g not in seen:
                    seen.add(g)
                    groups.append(g)
            if len(groups) != len(p.group_exprs):
                return L.Aggregate(p.input, groups, p.aggr_exprs)
        return p

    return L.transform_up(plan, f)


def filter_null_join_keys_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """INNER equi-joins never match NULL keys: filter them out below the
    join so the join sees fewer live rows (reference: FilterNullJoinKeys).
    Only nullable keys get a predicate."""

    def not_null_side(side: L.LogicalPlan, keys: List[E.Expr]) \
            -> Optional[L.LogicalPlan]:
        preds = []
        for k in keys:
            try:
                _, nullable = infer(k, side.schema)
            except Exception:
                return None
            if nullable:
                preds.append(E.Not(E.IsNull(k)))
        if not preds:
            return None
        pred = preds[0]
        for q in preds[1:]:
            pred = E.BinaryOp(E.Op.AND, pred, q)
        return L.Filter(side, pred)

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Join) or p.join_type is not L.JoinType.INNER \
                or not p.on:
            return p
        nl = not_null_side(p.left, [l for l, _ in p.on])
        nr = not_null_side(p.right, [r for _, r in p.on])
        if nl is None and nr is None:
            return p
        return L.Join(nl or p.left, nr or p.right, p.on, p.join_type,
                      p.filter)

    return L.transform_down(plan, f)


def eliminate_groupby_constant_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """GROUP BY keys that fold to literals group nothing: drop them from the
    key set and re-attach as projected constants (reference:
    EliminateGroupByConstant). Keeps one key when ALL are constant -- a
    grouped aggregate over zero rows yields zero rows, a global one yields
    one row, so full elimination would change empty-input semantics."""

    def is_const(e: E.Expr) -> bool:
        inner = e.expr if isinstance(e, E.Alias) else e
        return isinstance(inner, E.Literal)

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Aggregate):
            return p
        consts = [g for g in p.group_exprs if is_const(g)]
        if not consts or len(consts) == len(p.group_exprs):
            return p
        keep = [g for g in p.group_exprs if not is_const(g)]
        agg = L.Aggregate(p.input, keep, p.aggr_exprs)
        proj = []
        for i, g in enumerate(p.group_exprs):
            if is_const(g):
                proj.append(g if isinstance(g, E.Alias)
                            else E.Alias(g, g.name()))
            else:
                proj.append(E.Column(g.name(), p.schema.fields[i].qualifier))
        for a in p.aggr_exprs:
            proj.append(E.Column(a.name(), None))
        return L.Projection(agg, proj)

    return L.transform_up(plan, f)


def aggregate_statistics_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Answer a global count(*) over a bare table scan from exact table
    statistics -- no scan, no device program (reference:
    physical-optimizer/src/aggregate_statistics.rs). Only fires when the
    provider's row count is exact and the scan has no filters."""
    from ..common import types as T

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Aggregate) or p.group_exprs:
            return p
        scan = p.input
        if isinstance(scan, L.SubqueryAlias):
            scan = scan.input
        if not isinstance(scan, L.TableScan) or scan.filters:
            return p
        for a in p.aggr_exprs:
            inner = a.expr if isinstance(a, E.Alias) else a
            if not (isinstance(inner, E.AggregateFunction)
                    and inner.fname == "count" and not inner.distinct
                    and inner.filter is None and not inner.args):
                return p
        try:
            stats = scan.source.statistics()
        except Exception:
            return p
        if stats is None or not getattr(stats, "exact_rows", False):
            return p
        n = E.Literal(int(stats.num_rows), T.INT64)
        return L.Projection(
            L.EmptyRelation(True),
            [E.Alias(n, a.name()) for a in p.aggr_exprs])

    return L.transform_up(plan, f)


def optimize_unions_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Flatten nested unions and collapse single-input unions (reference:
    OptimizeUnions, optimizer/src/optimize_unions.rs). UNION [ALL] of a
    UNION ALL splices the inner inputs; a distinct union additionally
    splices inner distinct unions and strips inner Distinct wrappers (one
    top-level dedup subsumes them)."""

    def rename_like(q: L.LogicalPlan, schema) -> L.LogicalPlan:
        if [f.name for f in q.schema.fields] == [f.name for f in schema.fields]:
            return q
        return L.Projection(q, [
            E.Alias(E.Column(cf.name, cf.qualifier), uf.name)
            for cf, uf in zip(q.schema.fields, schema.fields)])

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Union):
            return p
        if len(p.inputs) == 1:
            only = rename_like(p.inputs[0], p.schema)
            return only if p.all else L.Distinct(only)
        flat: list = []
        changed = False
        for c in p.inputs:
            if isinstance(c, L.Union) and (c.all or not p.all):
                flat.extend(c.inputs)
                changed = True
            elif not p.all and isinstance(c, L.Distinct):
                flat.append(c.input)
                changed = True
            else:
                flat.append(c)
        if not changed:
            return p
        # output names come from the first input; keep the original ones
        return rename_like(L.Union(flat, p.all), p.schema)

    return L.transform_up(plan, f)


def unions_to_filter_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """UNION DISTINCT branches that differ only by their filter predicate
    collapse into one branch filtered by the disjunction (reference:
    UnionsToFilter, optimizer/src/unions_to_filter.rs). The planner emits
    UNION as Distinct(Union ALL); each branch may carry a projection above
    its filter. Branch equality is structural (identical projection exprs,
    identical display of everything below the Filter)."""

    def strip(c: L.LogicalPlan):
        """-> (projection exprs or None, filter predicate, base) or None."""
        proj = None
        if isinstance(c, L.Projection):
            proj = c.proj_exprs
            c = c.input
        if isinstance(c, L.Filter):
            return proj, c.predicate, c.input
        return None

    def collapse(u: L.Union):
        parts = [strip(c) for c in u.inputs]
        if any(x is None for x in parts):
            return None
        base_repr = parts[0][2].display()
        if any(x[0] != parts[0][0] or x[2].display() != base_repr
               for x in parts[1:]):
            return None
        pred = parts[0][1]
        for _, q, _ in parts[1:]:
            pred = E.BinaryOp(E.Op.OR, pred, q)
        out: L.LogicalPlan = L.Filter(parts[0][2], pred)
        if parts[0][0] is not None:
            out = L.Projection(out, parts[0][0])
        return out

    def f(p: L.LogicalPlan) -> L.LogicalPlan:
        u = None
        if isinstance(p, L.Distinct) and isinstance(p.input, L.Union) \
                and p.input.all and len(p.input.inputs) >= 2:
            u = p.input
        elif isinstance(p, L.Union) and not p.all and len(p.inputs) >= 2:
            u = p
        if u is None:
            return p
        one = collapse(u)
        return p if one is None else L.Distinct(one)

    return L.transform_up(plan, f)


def cleanup_rules(plan: L.LogicalPlan) -> L.LogicalPlan:
    plan = eliminate_filter_rule(plan)
    plan = eliminate_limit_rule(plan)
    plan = dedup_exprs_rule(plan)
    plan = eliminate_groupby_constant_rule(plan)
    plan = aggregate_statistics_rule(plan)
    plan = optimize_unions_rule(plan)
    plan = unions_to_filter_rule(plan)
    plan = propagate_empty_rule(plan)
    return plan
