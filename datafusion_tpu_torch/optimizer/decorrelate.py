# Verbatim copy of datafusion_tpu/optimizer/decorrelate.py; host-only, kept in step with the original.
"""Subquery decorrelation.

Capability analog of the reference rules DecorrelatePredicateSubquery and
ScalarSubqueryToJoin (datafusion/optimizer/src/{decorrelate_predicate_subquery,
scalar_subquery_to_join}.rs):

* EXISTS / NOT EXISTS      -> LEFT SEMI / LEFT ANTI join, correlated equality
                              conjuncts lifted into join keys
* expr IN (subquery)       -> LEFT SEMI join on (expr = subquery column)
* expr NOT IN (subquery)   -> LEFT ANTI join
* cmp with correlated scalar aggregate subquery
                           -> subquery's correlation keys appended to its
                              GROUP BY; INNER join on the keys; the comparison
                              becomes a plain filter over the joined schema
* uncorrelated scalar aggregate subquery
                           -> cross join against the single-row subquery

Only top-level conjuncts of Filter predicates are rewritten (matches the
reference's supported surface for these rules).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..common import types as T
from ..common.errors import PlanError
from ..expr import nodes as E
from ..logical import plan as L

_COUNTER = itertools.count()


def split_conjuncts(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.BinaryOp) and e.op is E.Op.AND:
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(exprs: List[E.Expr]) -> Optional[E.Expr]:
    out = None
    for e in exprs:
        out = e if out is None else E.BinaryOp(E.Op.AND, out, e)
    return out


def _has_subquery(e: E.Expr) -> bool:
    if isinstance(e, (E.Exists, E.InSubquery, E.ScalarSubquery)):
        return True
    return any(_has_subquery(c) for c in e.children())


def _outer_refs(e: E.Expr, inner_schema) -> List[E.Column]:
    """Columns in e not resolvable against inner_schema."""
    out = []
    for c in E.collect_columns(e):
        try:
            if inner_schema.find(c.flat_name) is None:
                out.append(c)
        except PlanError:
            pass  # ambiguous -> resolvable
    return out


def _simplify_plan(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Run expression simplification over a lifted subquery plan. Plans
    embedded in expressions are unreachable by the top-level simplify pass,
    but correlation-equality extraction needs folded predicates — TPC-DS
    q41's subquery filter is `(corr AND X) OR (corr AND Y)`, which only
    becomes `corr AND (X OR Y)` after OR factoring (reference: ExprSimplifier
    runs inside ScalarSubqueryToJoin's rewrites as part of Analyzer)."""
    from .optimizer import simplify_rule

    return simplify_rule(plan)


def _extract_correlated(plan: L.LogicalPlan):
    """Remove correlated conjuncts from Filters inside `plan`.
    Returns (new_plan, [(outer_expr, inner_expr)], [residual correlated preds])."""
    pairs: List[Tuple[E.Expr, E.Expr]] = []
    residual: List[E.Expr] = []

    def walk(p: L.LogicalPlan) -> L.LogicalPlan:
        kids = p.children()
        if kids:
            new_kids = [walk(k) for k in kids]
            if any(n is not o for n, o in zip(new_kids, kids)):
                p = p.with_children(new_kids)
        if isinstance(p, L.Filter):
            inner_schema = p.input.schema
            keep = []
            for c in split_conjuncts(p.predicate):
                refs = _outer_refs(c, inner_schema)
                if not refs:
                    keep.append(c)
                    continue
                # correlated conjunct
                if (isinstance(c, E.BinaryOp) and c.op is E.Op.EQ):
                    lrefs = _outer_refs(c.left, inner_schema)
                    rrefs = _outer_refs(c.right, inner_schema)
                    if lrefs and not rrefs:
                        pairs.append((c.left, c.right))
                        continue
                    if rrefs and not lrefs:
                        pairs.append((c.right, c.left))
                        continue
                residual.append(c)
            pred = conjoin(keep)
            p = L.Filter(p.input, pred) if pred is not None else p.input
        return p

    return walk(plan), pairs, residual


def _strip_projections_to(plan: L.LogicalPlan):
    """Descend through Projection/SubqueryAlias to find an Aggregate."""
    path = []
    p = plan
    while isinstance(p, (L.Projection, L.SubqueryAlias)):
        path.append(p)
        p = p.input
    return path, p


def decorrelate_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    return L.transform_up(plan, _rewrite_node)


def _rewrite_node(plan: L.LogicalPlan) -> L.LogicalPlan:
    if isinstance(plan, L.Projection) and any(
            _has_subquery(e) for e in plan.proj_exprs):
        # scalar subqueries in the SELECT list: join each one in and replace
        # it with the joined scalar column (reference: ScalarSubqueryToJoin
        # also fires on Projection, scalar_subquery_to_join.rs)
        input_plan = plan.input
        new_exprs = []
        for e in plan.proj_exprs:
            while True:
                sq = _find_scalar_subquery(e)
                if sq is None:
                    break
                input_plan, scalar_ref = _scalar_subquery_join(sq, input_plan)
                e = _replace_expr(e, sq, scalar_ref)
            new_exprs.append(e)
        return L.Projection(input_plan, new_exprs)
    if not isinstance(plan, L.Filter) or not _has_subquery(plan.predicate):
        return plan
    input_plan = plan.input
    remaining: List[E.Expr] = []
    for conj in split_conjuncts(plan.predicate):
        input_plan, handled = _rewrite_conjunct(conj, input_plan)
        if not handled:
            remaining.append(conj)
    pred = conjoin(remaining)
    return L.Filter(input_plan, pred) if pred is not None else input_plan


def _rewrite_conjunct(conj: E.Expr, input_plan: L.LogicalPlan):
    """Returns (new_input_plan, handled)."""
    if isinstance(conj, E.Exists):
        return _rewrite_exists(conj, input_plan), True
    if isinstance(conj, E.Not) and isinstance(conj.expr, E.Exists):
        inner = conj.expr
        return _rewrite_exists(E.Exists(inner.plan, not inner.negated), input_plan), True
    if isinstance(conj, E.InSubquery):
        return _rewrite_in(conj, input_plan), True
    if isinstance(conj, E.Not) and isinstance(conj.expr, E.InSubquery):
        inner = conj.expr
        return _rewrite_in(E.InSubquery(inner.expr, inner.plan, not inner.negated), input_plan), True
    if _has_subquery(conj):
        if _only_scalar_subqueries(conj):
            return _rewrite_scalar_cmp(conj, input_plan), True
        # EXISTS / IN under OR (or other boolean combinations): replace each
        # subquery with a mark column computed by a LEFT-joined grouped
        # aggregate — the capability analog of the reference's mark joins
        # (JoinType::LeftMark, physical-plan/src/joins/mod.rs; used by
        # DecorrelatePredicateSubquery for disjunctive subqueries).
        return _rewrite_disjunctive(conj, input_plan), True
    return input_plan, False


def _only_scalar_subqueries(e: E.Expr) -> bool:
    if isinstance(e, (E.Exists, E.InSubquery)):
        return False
    return all(_only_scalar_subqueries(c) for c in e.children())


def _rewrite_disjunctive(conj: E.Expr, input_plan: L.LogicalPlan) -> L.LogicalPlan:
    plan_box = [input_plan]

    def repl(e: E.Expr) -> E.Expr:
        if isinstance(e, E.Exists):
            mark = _exists_mark(e, plan_box)
            return E.Not(mark) if e.negated else mark
        if isinstance(e, E.InSubquery):
            mark = _in_mark(e, plan_box)
            return E.Not(mark) if e.negated else mark
        import dataclasses

        if not dataclasses.is_dataclass(e):
            return e
        changes = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, E.Expr):
                nv = repl(v)
                if nv is not v:
                    changes[f.name] = nv
            elif isinstance(v, tuple):
                nv = tuple(repl(x) if isinstance(x, E.Expr) else x for x in v)
                if any(a is not b for a, b in zip(nv, v)):
                    changes[f.name] = nv
        return dataclasses.replace(e, **changes) if changes else e

    pred = repl(conj)
    return L.Filter(plan_box[0], pred)


def _mark_join_keys(pairs, nid: int):
    """Group exprs + join keys for the correlation columns of a mark
    aggregate. Returns (group_exprs, [(outer, inner_ref)], alias)."""
    alias = f"__mark_{nid}"
    gexprs, on = [], []
    for i, (outer, inner) in enumerate(pairs):
        if isinstance(inner, E.Column):
            gexprs.append(inner)
            on.append((outer, E.Column(inner.cname, alias)))
        else:
            kname = f"__mk{i}_{nid}"
            gexprs.append(E.Alias(inner, kname))
            on.append((outer, E.Column(kname, alias)))
    return gexprs, on, alias


def _exists_mark(e: E.Exists, plan_box) -> E.Expr:
    """LEFT-join a per-correlation-group COUNT(*) and return the boolean
    existence mark (never NULL)."""
    sub, pairs, residual = _extract_correlated(decorrelate_rule(e.plan))
    if residual:
        # push non-equality correlated predicates back: unsupported here
        raise PlanError(
            "unsupported: non-equality correlated EXISTS under OR")
    nid = next(_COUNTER)
    gexprs, on, alias = _mark_join_keys(pairs, nid)
    cname = f"__mc_{nid}"
    agg = L.SubqueryAlias(
        L.Aggregate(sub, gexprs,
                    [E.Alias(E.AggregateFunction("count", ()), cname)]),
        alias)
    c = E.Column(cname, alias)
    if pairs:
        plan_box[0] = L.Join(plan_box[0], agg, on, L.JoinType.LEFT, None)
        return E.Not(E.IsNull(c))
    plan_box[0] = L.Join(plan_box[0], agg, [], L.JoinType.INNER, None)
    return E.BinaryOp(E.Op.GT, c, E.lit(0))


def _in_mark(e: E.InSubquery, plan_box) -> E.Expr:
    """3VL mark for `expr IN (subquery)` under OR:
      TRUE  if some subquery row (of this correlation group) equals expr,
      FALSE if the group is empty, or no match and no NULLs anywhere,
      NULL  if no match but expr IS NULL or the group contains NULLs."""
    sub0 = decorrelate_rule(e.plan)
    if len(sub0.schema) != 1:
        raise PlanError("IN subquery must produce exactly one column")
    first = sub0.schema.fields[0]
    sub, pairs, residual = _extract_correlated(sub0)
    if residual:
        raise PlanError("unsupported: non-equality correlated IN under OR")
    if pairs and isinstance(sub, L.Projection):
        sub = L.Projection(sub.input, list(sub.proj_exprs) + [p[1] for p in pairs])
    inner_col = E.Column(first.name, first.qualifier)
    nid = next(_COUNTER)

    # match mark: group by (correlation keys, value), join on both
    mg, mon, malias = _mark_join_keys(
        pairs + [(e.expr, inner_col)], nid)
    mc = f"__mm_{nid}"
    magg = L.SubqueryAlias(
        L.Aggregate(sub, mg,
                    [E.Alias(E.AggregateFunction("count", ()), mc)]),
        malias)
    plan_box[0] = L.Join(plan_box[0], magg, mon, L.JoinType.LEFT, None)
    matched = E.Not(E.IsNull(E.Column(mc, malias)))

    # group info: total count + non-null count per correlation group
    nid2 = next(_COUNTER)
    gg, gon, galias = _mark_join_keys(pairs, nid2)
    tot_n, nn_n = f"__mt_{nid2}", f"__mn_{nid2}"
    gagg = L.SubqueryAlias(
        L.Aggregate(sub, gg,
                    [E.Alias(E.AggregateFunction("count", ()), tot_n),
                     E.Alias(E.AggregateFunction("count", (inner_col,)), nn_n)]),
        galias)
    jt = L.JoinType.LEFT if pairs else L.JoinType.INNER
    plan_box[0] = L.Join(plan_box[0], gagg, gon, jt, None)
    tot = E.Column(tot_n, galias)
    nn = E.Column(nn_n, galias)
    empty = E.BinaryOp(E.Op.OR, E.IsNull(tot),
                       E.BinaryOp(E.Op.EQ, tot, E.lit(0)))
    uncertain = E.BinaryOp(E.Op.OR, E.IsNull(e.expr),
                           E.BinaryOp(E.Op.LT, nn, tot))
    null_lit = E.Literal(None, T.BOOL)
    return E.Case(None,
                  ((matched, E.lit(True)),
                   (empty, E.lit(False)),
                   (uncertain, null_lit)),
                  E.lit(False))


def _rewrite_exists(e: E.Exists, input_plan: L.LogicalPlan) -> L.LogicalPlan:
    sub, pairs, residual = _extract_correlated(decorrelate_rule(e.plan))
    jt = L.JoinType.LEFT_ANTI if e.negated else L.JoinType.LEFT_SEMI
    on = [(outer, inner) for outer, inner in pairs]
    filt = conjoin(residual)
    # project the subquery to just the inner join-key columns to keep schemas lean
    return L.Join(input_plan, sub, on, jt, filt)


def _rewrite_in(e: E.InSubquery, input_plan: L.LogicalPlan) -> L.LogicalPlan:
    sub0 = decorrelate_rule(e.plan)
    if len(sub0.schema) != 1:
        raise PlanError("IN subquery must produce exactly one column")
    first = sub0.schema.fields[0]
    sub, pairs, residual = _extract_correlated(sub0)
    if pairs and isinstance(sub, L.Projection):
        # keep the correlation key columns visible through the projection
        extra = [p[1] for p in pairs]
        sub = L.Projection(sub.input, list(sub.proj_exprs) + extra)
    inner_col = E.Column(first.name, first.qualifier)
    on = [(e.expr, inner_col)] + list(pairs)
    jt = L.JoinType.LEFT_ANTI if e.negated else L.JoinType.LEFT_SEMI
    joined = L.Join(input_plan, sub, on, jt, conjoin(residual))
    if not e.negated or residual:
        # (residual correlated predicates keep the plain anti join; NOT IN
        # with residual non-equality correlation is not null-aware)
        return joined
    return _null_aware_not_in(e, joined, sub, pairs, inner_col)


def _null_aware_not_in(e: E.InSubquery, joined: L.LogicalPlan,
                       sub: L.LogicalPlan, pairs, inner_col: E.Column):
    """SQL NOT IN is not a plain anti join: if the subquery (for this row's
    correlation group) produces any NULL, NOT IN is never TRUE; and a NULL
    probe value only passes when the group is empty. Mirrors the reference's
    null-aware anti join semantics (DecorrelatePredicateSubquery) by LEFT-
    joining per-group COUNT(*) / COUNT(value) onto the anti-join survivors:

      pass iff group-empty OR (probe IS NOT NULL AND count(value) = count(*))
    """
    nid = next(_COUNTER)
    alias = f"__nin_{nid}"
    tot_name, nn_name = f"__nin_tot_{nid}", f"__nin_nn_{nid}"
    gexprs = []
    key_names = []
    for i, (_, inner) in enumerate(pairs):
        if isinstance(inner, E.Column):
            gexprs.append(inner)
            key_names.append(inner.cname)
        else:
            kname = f"__nin_k{i}_{nid}"
            gexprs.append(E.Alias(inner, kname))
            key_names.append(kname)
    aggs = [E.Alias(E.AggregateFunction("count", ()), tot_name),
            E.Alias(E.AggregateFunction("count", (inner_col,)), nn_name)]
    agg = L.SubqueryAlias(L.Aggregate(sub, gexprs, aggs), alias)
    if pairs:
        on2 = [(outer, E.Column(k, alias))
               for (outer, _), k in zip(pairs, key_names)]
        joined2 = L.Join(joined, agg, on2, L.JoinType.LEFT, None)
    else:
        # uncorrelated: the group-less aggregate is exactly one row
        joined2 = L.Join(joined, agg, [], L.JoinType.INNER, None)
    tot = E.Column(tot_name, alias)
    nn = E.Column(nn_name, alias)
    group_empty = E.BinaryOp(E.Op.OR, E.IsNull(tot),
                             E.BinaryOp(E.Op.EQ, tot, E.lit(0)))
    clean = E.BinaryOp(E.Op.AND, E.Not(E.IsNull(e.expr)),
                       E.BinaryOp(E.Op.EQ, nn, tot))
    return L.Filter(joined2, E.BinaryOp(E.Op.OR, group_empty, clean))


def _find_scalar_subquery(e: E.Expr) -> Optional[E.ScalarSubquery]:
    if isinstance(e, E.ScalarSubquery):
        return e
    for c in e.children():
        f = _find_scalar_subquery(c)
        if f is not None:
            return f
    return None


def _replace_expr(e: E.Expr, target: E.Expr, replacement: E.Expr) -> E.Expr:
    return E.map_expr(e, lambda x: replacement if x == target else x)


def _rewrite_scalar_cmp(conj: E.Expr, input_plan: L.LogicalPlan) -> L.LogicalPlan:
    # one conjunct may hold several scalar subqueries (TPC-DS q54:
    # `x BETWEEN (select ...) AND (select ...)`): join each one in
    if _find_scalar_subquery(conj) is None:
        raise PlanError(f"unsupported subquery pattern: {conj!r}")
    while True:
        sq = _find_scalar_subquery(conj)
        if sq is None:
            return L.Filter(input_plan, conj)
        input_plan, scalar_ref = _scalar_subquery_join(sq, input_plan)
        conj = _replace_expr(conj, sq, scalar_ref)


def _scalar_subquery_join(sq: E.ScalarSubquery, input_plan: L.LogicalPlan):
    """Join `sq` against input_plan; returns (joined_plan, expr standing in
    for the subquery's scalar value over the joined schema)."""
    sub, pairs, residual = _extract_correlated(_simplify_plan(decorrelate_rule(sq.plan)))
    if residual:
        raise PlanError("non-equality correlated predicate in scalar subquery")
    alias = f"__sq_{next(_COUNTER)}"

    if not pairs:
        # uncorrelated: cross join the 1-row aggregate
        sub_aliased = L.SubqueryAlias(sub, alias)
        joined = L.Join(input_plan, sub_aliased, [], L.JoinType.INNER, None)
        scalar_col = E.Column(sub_aliased.schema.fields[0].name, alias)
        return joined, scalar_col

    # correlated: group the subquery by its correlation keys
    path, agg = _strip_projections_to(sub)
    if not isinstance(agg, L.Aggregate):
        raise PlanError("correlated scalar subquery must be an aggregate")
    inner_keys = [inner for _, inner in pairs]
    new_agg = L.Aggregate(agg.input, list(agg.group_exprs) + inner_keys, agg.aggr_exprs)
    # rebuild projections on top, extended with the key columns
    rebuilt: L.LogicalPlan = new_agg
    for node in reversed(path):
        if isinstance(node, L.Projection):
            extra = [E.Column(k.name(), None) if not isinstance(k, E.Column) else k
                     for k in inner_keys]
            rebuilt = L.Projection(rebuilt, list(node.proj_exprs) + list(extra))
        elif isinstance(node, L.SubqueryAlias):
            rebuilt = L.SubqueryAlias(rebuilt, node.alias)
    sub_aliased = L.SubqueryAlias(rebuilt, alias)

    # scalar output = first field of the original subquery schema
    scalar_name = sq.plan.schema.fields[0].name
    scalar_col = E.Column(scalar_name, alias)
    on = []
    for (outer, inner) in pairs:
        iname = inner.name() if not isinstance(inner, E.Column) else inner.cname
        on.append((outer, E.Column(iname, alias)))
    # LEFT join (not INNER): outer rows whose correlation group is empty must
    # survive with a NULL scalar -- the classic COUNT bug (reference:
    # optimizer/src/scalar_subquery_to_join.rs uses LEFT + coalesce)
    joined = L.Join(input_plan, sub_aliased, on, L.JoinType.LEFT, None)
    scalar_ref: E.Expr = scalar_col
    if _count_like(sq.plan):
        scalar_ref = E.ScalarFunction("coalesce", (scalar_col, E.lit(0)))
    return joined, scalar_ref


def _count_like(plan: L.LogicalPlan) -> bool:
    """True when the subquery's first output column is a count-family
    aggregate (zero, not NULL, on empty input)."""
    p = plan
    while True:
        if isinstance(p, L.SubqueryAlias):
            p = p.input
            continue
        if isinstance(p, L.Projection):
            e = p.proj_exprs[0]
            e = e.expr if isinstance(e, E.Alias) else e
            if isinstance(e, E.Column):
                p = p.input
                continue
            return (isinstance(e, E.AggregateFunction)
                    and e.fname in ("count", "approx_distinct"))
        if isinstance(p, L.Aggregate):
            if p.group_exprs or not p.aggr_exprs:
                return False  # field 0 would be a group key
            e = p.aggr_exprs[0]
            e = e.expr if isinstance(e, E.Alias) else e
            return (isinstance(e, E.AggregateFunction)
                    and e.fname in ("count", "approx_distinct"))
        return False
