# Verbatim copy of datafusion_tpu/optimizer/pushdown.py; host-only, kept in step with the original.
"""Filter pushdown, cross-join elimination, projection (column) pruning,
limit-into-sort.

Capability analogs of the reference rules PushDownFilter, EliminateCrossJoin,
ExtractEquijoinPredicate, OptimizeProjections and PushDownLimit
(datafusion/optimizer/src/{push_down_filter,eliminate_cross_join,
extract_equijoin_predicate,optimize_projections,push_down_limit}.rs).

Column pruning matters doubly here: pruned columns never get
dictionary-encoded or shipped to HBM (TPC-H comment columns are ~40% of bytes).
"""
from __future__ import annotations

import os
from typing import List, Optional, Set, Tuple

from ..common.errors import PlanError
from ..expr import nodes as E
from ..logical import plan as L
from .decorrelate import conjoin, split_conjuncts

_DEBUG_REORDER = bool(os.environ.get("DFTPU_DEBUG_REORDER"))


def _resolvable(e: E.Expr, schema) -> bool:
    """Every column in e resolves (unambiguously) against schema."""
    for c in E.collect_columns(e):
        try:
            if schema.find(c.flat_name) is None:
                return False
        except PlanError:
            return False
    return True


def push_filters_rule(plan: L.LogicalPlan, max_passes: int = 5) -> L.LogicalPlan:
    for _ in range(max_passes):
        new = L.transform_down(plan, _push_filter_node)
        if new.display() == plan.display():
            return new
        plan = new
    return plan


def _split_disjuncts(e: E.Expr) -> List[E.Expr]:
    if isinstance(e, E.BinaryOp) and e.op is E.Op.OR:
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _factor_or(conjunct: E.Expr) -> List[E.Expr]:
    """(a AND x1) OR (a AND x2) -> a AND (x1 OR x2): hoist conjuncts common
    to every OR branch (reference: EliminateCrossJoin's join-key recovery
    from ORs, optimizer/src/eliminate_cross_join.rs). Critical for TPC-H Q19
    where the equi-join key hides inside each OR branch."""
    branches = _split_disjuncts(conjunct)
    if len(branches) < 2:
        return [conjunct]
    branch_sets = [split_conjuncts(b) for b in branches]
    common = [c for c in branch_sets[0]
              if all(any(c == d for d in bs) for bs in branch_sets[1:])]
    if not common:
        return [conjunct]
    residuals = []
    for bs in branch_sets:
        rest = [c for c in bs if not any(c == k for k in common)]
        residuals.append(conjoin(rest) or E.lit(True))
    out = list(common)
    disj = None
    for r in residuals:
        disj = r if disj is None else E.BinaryOp(E.Op.OR, disj, r)
    if disj is not None and not (isinstance(disj, E.Literal) and disj.value is True):
        out.append(disj)
    return out


def _implied_from_or(e: E.Expr) -> List[E.Expr]:
    """Derive pushable single-column predicates implied by an OR: if every
    disjunct constrains column c, then OR(per-disjunct constraints on c)
    holds for all rows.  TPC-H Q7's `(n1=F AND n2=G) OR (n1=G AND n2=F)`
    implies n1 IN (F,G) AND n2 IN (F,G), which shrinks the nation scans
    25x before the join chain (reference: the same extraction inside
    EliminateCrossJoin / filter pushdown, optimizer/src/push_down_filter.rs
    extract_or_clauses_for_filter_push analog)."""
    disjuncts = _split_disjuncts(e)
    if len(disjuncts) < 2:
        return []
    percol: List[dict] = []
    for d in disjuncts:
        m: dict = {}
        for cj in split_conjuncts(d):
            keys = {(c.qualifier, c.cname) for c in E.collect_columns(cj)}
            if len(keys) == 1:
                m.setdefault(keys.pop(), []).append(cj)
        percol.append(m)
    common = set(percol[0])
    for m in percol[1:]:
        common &= set(m)
    out = []
    for k in sorted(common, key=repr):
        disj = None
        for m in percol:
            b = conjoin(m[k])
            disj = b if disj is None else E.BinaryOp(E.Op.OR, disj, b)
        out.append(disj)
    return out


# scalar functions that return NULL whenever any argument is NULL, so a
# column under them stays null-rejecting inside a comparison
_STRICT_FNS = frozenset({
    "abs", "round", "floor", "ceil", "trunc", "sqrt", "exp", "ln", "log10",
    "log2", "sign", "signum", "upper", "lower", "trim", "ltrim", "rtrim",
    "btrim", "substr", "substring", "length", "char_length",
    "character_length", "year", "month", "day", "extract", "date_part",
    "date_trunc", "to_date", "reverse", "ascii",
})


def _strict_columns(e: E.Expr) -> Set[Tuple]:
    """Columns whose NULL forces `e` to evaluate to NULL (strict
    propagation). COALESCE/IFNULL/CASE/IS NULL absorb NULLs, so columns
    under them are NOT collected."""
    if isinstance(e, E.Column):
        return {(e.qualifier, e.cname)}
    if isinstance(e, (E.Cast, E.Negative)):
        return _strict_columns(e.expr)
    if isinstance(e, E.Alias):
        return _strict_columns(e.expr)
    if isinstance(e, E.BinaryOp) and not e.op.is_logic:
        return _strict_columns(e.left) | _strict_columns(e.right)
    if isinstance(e, E.ScalarFunction) and e.fname.lower() in _STRICT_FNS:
        out: Set[Tuple] = set()
        for a in e.args:
            out |= _strict_columns(a)
        return out
    return set()


def _null_rejecting_cols(e: E.Expr) -> Set[Tuple]:
    """Columns for which predicate `e` cannot be TRUE when the column is
    NULL (reference: eliminate_outer_join.rs extract_non_nullable_columns).
    Conservative: only shapes whose strictness is obvious, and only columns
    that propagate NULL strictly into the comparison (a column under
    COALESCE does not reject NULLs — the classic COUNT-subquery trap)."""
    if isinstance(e, E.BinaryOp):
        if e.op is E.Op.AND:
            return _null_rejecting_cols(e.left) | _null_rejecting_cols(e.right)
        if e.op is E.Op.OR:
            return _null_rejecting_cols(e.left) & _null_rejecting_cols(e.right)
        if e.op in (E.Op.EQ, E.Op.NEQ, E.Op.LT, E.Op.LE, E.Op.GT, E.Op.GE):
            return _strict_columns(e.left) | _strict_columns(e.right)
    if isinstance(e, (E.Between, E.InList, E.Like)) and not e.negated:
        out: Set[Tuple] = set()
        for sub in getattr(e, "values", None) or ():
            out |= _strict_columns(sub)
        out |= _strict_columns(e.expr)
        if isinstance(e, E.Between):
            out |= _strict_columns(e.low) | _strict_columns(e.high)
        return out
    if isinstance(e, E.Not) and isinstance(e.expr, E.IsNull):
        if isinstance(e.expr.expr, E.Column):
            c = e.expr.expr
            return {(c.qualifier, c.cname)}
    return set()


def eliminate_outer_joins_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """LEFT/RIGHT/FULL -> INNER when a filter above rejects NULLs from the
    null-supplying side (reference: optimizer/src/eliminate_outer_join.rs).
    Run before filter pushdown so the demoted join can then reorder."""

    def side_cols(p: L.LogicalPlan) -> Set[Tuple]:
        return {(f.qualifier, f.name) for f in p.schema.fields}

    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Filter) or not isinstance(p.input, L.Join):
            return p
        j = p.input
        if j.join_type not in (L.JoinType.LEFT, L.JoinType.RIGHT, L.JoinType.FULL):
            return p
        strict: Set[Tuple] = set()
        for conj in split_conjuncts(p.predicate):
            strict |= _null_rejecting_cols(conj)
        right_hit = bool(strict & side_cols(j.right))
        left_hit = bool(strict & side_cols(j.left))
        jt = j.join_type
        if jt is L.JoinType.LEFT and right_hit:
            jt = L.JoinType.INNER
        elif jt is L.JoinType.RIGHT and left_hit:
            jt = L.JoinType.INNER
        elif jt is L.JoinType.FULL:
            # rejecting right-side NULLs removes the left-unmatched rows
            # (whose right columns are NULL), leaving inner + right-unmatched
            if left_hit and right_hit:
                jt = L.JoinType.INNER
            elif right_hit:
                jt = L.JoinType.RIGHT
            elif left_hit:
                jt = L.JoinType.LEFT
        if jt is j.join_type:
            return p
        return L.Filter(L.Join(j.left, j.right, j.on, jt, j.filter),
                        p.predicate)

    return L.transform_up(plan, rewrite)


def or_implication_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Filter):
            return p
        conj = split_conjuncts(p.predicate)
        new: List[E.Expr] = []
        for c in conj:
            if isinstance(c, E.BinaryOp) and c.op is E.Op.OR:
                for d in _implied_from_or(c):
                    if d not in conj and d not in new:
                        new.append(d)
        if not new:
            return p
        return L.Filter(p.input, conjoin(conj + new))

    return L.transform_up(plan, rewrite)


def _push_filter_node(plan: L.LogicalPlan) -> L.LogicalPlan:
    if not isinstance(plan, L.Filter):
        return plan
    child = plan.input
    conjuncts = []
    for c in split_conjuncts(plan.predicate):
        conjuncts.extend(_factor_or(c))

    if isinstance(child, L.Filter):
        return L.Filter(child.input, conjoin(conjuncts + split_conjuncts(child.predicate)))

    if isinstance(child, L.Join):
        return _push_into_join(conjuncts, child)

    if isinstance(child, L.TableScan):
        # sink conjuncts into the scan: providers use them for file/row-group
        # pruning (inexact), and the physical planner re-applies each as an
        # exact FilterExec above the scan (reference: push_down_filter.rs
        # TableScan case + TableProviderFilterPushDown::Inexact)
        merged = list(child.filters)
        merged.extend(c for c in conjuncts if c not in merged)
        return L.TableScan(child.name, child.source, child.projection,
                           merged, child.alias)

    if isinstance(child, L.SubqueryAlias):
        # cannot cross alias boundary without re-qualification; leave.
        return plan
    if isinstance(child, (L.Sort, L.Limit)):
        if isinstance(child, L.Limit) or child.fetch is not None:
            return plan  # filter past a limit changes results
        return L.Sort(L.Filter(child.input, plan.predicate), child.sort_specs, child.fetch)
    return plan


def _push_into_join(conjuncts: List[E.Expr], join: L.Join) -> L.LogicalPlan:
    jt = join.join_type
    lsch, rsch = join.left.schema, join.right.schema
    left_ok = jt in (L.JoinType.INNER, L.JoinType.CROSS, L.JoinType.LEFT,
                     L.JoinType.LEFT_SEMI, L.JoinType.LEFT_ANTI)
    right_ok = jt in (L.JoinType.INNER, L.JoinType.CROSS, L.JoinType.RIGHT)
    can_equi = jt in (L.JoinType.INNER, L.JoinType.CROSS)

    to_left: List[E.Expr] = []
    to_right: List[E.Expr] = []
    new_on: List[Tuple[E.Expr, E.Expr]] = list(join.on)
    to_filter: List[E.Expr] = []  # cross-side residuals attach to the join
    stay: List[E.Expr] = []

    for c in conjuncts:
        if left_ok and _resolvable(c, lsch):
            to_left.append(c)
        elif right_ok and _resolvable(c, rsch):
            to_right.append(c)
        elif can_equi and isinstance(c, E.BinaryOp) and c.op is E.Op.EQ:
            l, r = c.left, c.right
            if _resolvable(l, lsch) and _resolvable(r, rsch):
                new_on.append((l, r))
            elif _resolvable(r, lsch) and _resolvable(l, rsch):
                new_on.append((r, l))
            else:
                stay.append(c)
        elif can_equi and _resolvable(c, join.schema):
            # references both sides: make it the join's residual filter so
            # the physical layer can pick a range-predicate (piecewise
            # merge) phase instead of filtering a cartesian expansion
            # (reference: push_down_filter.rs keeping join filters on
            # INNER joins)
            to_filter.append(c)
        else:
            stay.append(c)

    if not (to_left or to_right or to_filter or len(new_on) > len(join.on)):
        pred = conjoin(conjuncts)
        return L.Filter(join, pred)

    left = L.Filter(join.left, conjoin(to_left)) if to_left else join.left
    right = L.Filter(join.right, conjoin(to_right)) if to_right else join.right
    njt = L.JoinType.INNER if (jt is L.JoinType.CROSS and new_on) else jt
    jfilter = conjoin(([join.filter] if join.filter is not None else [])
                      + to_filter)
    new_join = L.Join(left, right, new_on, njt, jfilter)
    pred = conjoin(stay)
    return L.Filter(new_join, pred) if pred is not None else new_join


# ---------------------------------------------------------------------------
# projection pruning
# ---------------------------------------------------------------------------


def projection_pruning_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Trim TableScan projections to the columns the plan actually consumes
    (reference: OptimizeProjections, optimizer/src/optimize_projections/).

    Refs are collected SCOPE-AWARE, top-down: Projection and Aggregate
    nodes define a fresh output namespace, so column refs from above them
    (e.g. an ORDER BY over the projection's output aliases) must NOT leak
    into their subtree -- a same-named column in an unrelated scan below
    the boundary would otherwise be kept alive. (TPC-H Q3 after late
    materialization: the final `o_orderdate` is produced by the __lm0
    re-scan, and the global collection used to keep it in the pruned-away
    inner orders scan too, dragging dead payload lanes through the
    join+aggregate hot path.) Pass-through nodes (Filter/Sort/Limit/Join/
    Distinct/Union/Window...) forward their parents' refs and add their
    own; over-keeping on ambiguity is safe, under-keeping is not."""
    refs_at_scan: dict = {}

    def collect(p: L.LogicalPlan, refs: Set[Tuple[Optional[str], str]]):
        if isinstance(p, (L.Projection, L.Aggregate)):
            refs = set()  # fresh namespace: only this node's exprs matter
        own = set(refs)
        for e in p.exprs():
            for c in E.collect_columns(e):
                own.add((c.qualifier, c.cname))
        if isinstance(p, L.TableScan):
            refs_at_scan.setdefault(id(p), set()).update(own)
        for k in p.children():
            collect(k, own)

    collect(plan, {(f.qualifier, f.name) for f in plan.schema.fields})

    protected: Set[int] = set()

    def mark_protected(p: L.LogicalPlan, protect: bool):
        if isinstance(p, (L.Projection, L.Aggregate)):
            protect = False
        if isinstance(p, (L.Distinct, L.Union)):
            protect = True
        if isinstance(p, L.TableScan) and protect:
            protected.add(id(p))
        for k in p.children():
            mark_protected(k, protect)

    mark_protected(plan, False)

    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, L.TableScan) and id(p) not in protected:
            refs = refs_at_scan.get(id(p), set())
            base = p.source.schema()
            keep = []
            for f in base.fields:
                if (p.alias, f.name) in refs or (None, f.name) in refs:
                    keep.append(f.name)
            if not keep:
                keep = [base.fields[0].name]
            if p.projection is None and len(keep) < len(base.fields):
                return L.TableScan(p.name, p.source, keep, p.filters, p.alias)
        return p

    return L.transform_up(plan, rewrite)


def reorder_joins_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Cost-based join ordering over chains of INNER/CROSS joins, with
    semi/anti joins placed at their cheapest valid position (reference:
    EliminateCrossJoin, optimizer/src/eliminate_cross_join.rs +
    JoinSelection's statistics use, physical-optimizer/src/join_selection.rs).

    The chain (including LEFT SEMI/ANTI links on the left spine) is
    flattened, per-leaf cardinalities are estimated from table statistics
    (optimizer/cost.py), and a greedy System-R-style order is chosen from
    the best starting leaf (minimizing the sum of intermediate result
    sizes).  Semi/anti joins are applied as soon as their left-side columns
    are available -- e.g. TPC-H Q18's big-order semi filter runs against
    `orders` BEFORE the customer/lineitem joins, and Q21's l2/l3 semi+anti
    run against l1 before the supplier join."""
    from .cost import estimate, join_cardinality, selectivity

    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Join) or p.join_type not in (
                L.JoinType.INNER, L.JoinType.CROSS,
                L.JoinType.LEFT_SEMI, L.JoinType.LEFT_ANTI):
            return p
        leaves: List[L.LogicalPlan] = []
        pairs: List[Tuple[E.Expr, E.Expr]] = []  # equi pairs (either direction)
        filters: List[E.Expr] = []
        semis: List[Tuple] = []  # (join_type, right_plan, on, filter)

        def flatten(n: L.LogicalPlan):
            if isinstance(n, L.Join) and n.join_type in (L.JoinType.INNER,
                                                         L.JoinType.CROSS):
                flatten(n.left)
                flatten(n.right)
                pairs.extend(n.on)
                if n.filter is not None:
                    filters.extend(split_conjuncts(n.filter))
            elif isinstance(n, L.Join) and n.join_type in (
                    L.JoinType.LEFT_SEMI, L.JoinType.LEFT_ANTI):
                flatten(n.left)
                semis.append((n.join_type, n.right, n.on, n.filter))
            else:
                leaves.append(n)

        flatten(p)
        if len(leaves) <= 1:
            return p  # pure semi chain: already minimal

        memo: dict = {}
        ests = {id(leaf): estimate(leaf, memo) for leaf in leaves}

        # Transitive equality closure (reference: equivalence classes,
        # datafusion/physical-expr/src/equivalence/class.rs): columns linked
        # by simple Column=Column equi pairs form classes, and ANY pair of
        # class members is an implied join edge. TPC-H Q5's c_nationkey =
        # s_nationkey = n_nationkey lets customer join the 5-row ASIA
        # nation/region build directly, so the region filter reduces
        # customer/orders BEFORE the lineitem joins instead of after.
        parent: dict = {}

        def find(k):
            while parent.get(k, k) != k:
                parent[k] = parent.get(parent[k], parent[k])
                k = parent[k]
            return k

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        def col_key(e):
            return (e.qualifier, e.cname) if isinstance(e, E.Column) else None

        raw_pairs: List[Tuple[E.Expr, E.Expr]] = []
        class_cols: dict = {}  # key -> Column expr (one representative each)
        for a, b in pairs:
            ka, kb = col_key(a), col_key(b)
            if ka is None or kb is None:
                raw_pairs.append((a, b))
            else:
                class_cols.setdefault(ka, a)
                class_cols.setdefault(kb, b)
                union(ka, kb)
        class_members: dict = {}  # root -> [Column, ...]
        for k, c in class_cols.items():
            class_members.setdefault(find(k), []).append(c)

        def semi_attachable(semi, schema) -> bool:
            jt, right, on, filt = semi
            for lk, _ in on:
                if not _resolvable(lk, schema):
                    return False
            if filt is not None:
                for c in E.collect_columns(filt):
                    if not (_resolvable(c, right.schema)
                            or _resolvable(c, schema)):
                        return False
            return True

        def apply_semi(node, node_est, semi, memo):
            jt, right, on, filt = semi
            out = L.Join(node, right, list(on), jt, filt)
            out_est = join_cardinality(node_est, estimate(right, memo),
                                       on, jt)
            if filt is not None:
                out_est = out_est.scaled(selectivity(filt, out_est))
            return out, out_est

        def greedy(start_idx: int):
            """One greedy chain from leaves[start_idx]; returns
            (total_cost, plan, leftover_pairs)."""
            current = leaves[start_idx]
            cur_est = ests[id(current)]
            remaining = leaves[:start_idx] + leaves[start_idx + 1:]
            unused_pairs = list(raw_pairs)
            pending = list(semis)
            cost = 0.0
            # attach any semi/anti already valid on the bare leaf
            changed = True
            while changed:
                changed = False
                for semi in list(pending):
                    if semi_attachable(semi, current.schema):
                        current, cur_est = apply_semi(current, cur_est,
                                                      semi, memo)
                        pending.remove(semi)
                        cost += cur_est.rows
                        changed = True
            while remaining:
                best = None  # (rows, index, leaf, on_here, est)
                for i, leaf in enumerate(remaining):
                    on_here = []
                    for (a, b) in unused_pairs:
                        if _resolvable(a, current.schema) and _resolvable(b, leaf.schema):
                            on_here.append((a, b))
                        elif _resolvable(b, current.schema) and _resolvable(a, leaf.schema):
                            on_here.append((b, a))
                    # one implied edge per equivalence class spanning the
                    # frontier: joining the new leaf once per class enforces
                    # the full closure with no redundant composite keys
                    for members in class_members.values():
                        cur_m = next((m for m in members
                                      if _resolvable(m, current.schema)), None)
                        leaf_m = next((m for m in members
                                       if col_key(m) != col_key(cur_m)
                                       and _resolvable(m, leaf.schema)), None) \
                            if cur_m is not None else None
                        if cur_m is not None and leaf_m is not None:
                            on_here.append((cur_m, leaf_m))
                    if not on_here:
                        continue
                    nxt = join_cardinality(cur_est, ests[id(leaf)], on_here,
                                           L.JoinType.INNER)
                    if best is None or nxt.rows < best[0]:
                        best = (nxt.rows, i, leaf, on_here, nxt)
                if best is None:  # unconnected: cross join smallest leaf
                    i = min(range(len(remaining)),
                            key=lambda j: ests[id(remaining[j])].rows)
                    leaf = remaining[i]
                    nxt = join_cardinality(cur_est, ests[id(leaf)], [],
                                           L.JoinType.CROSS)
                    best = (nxt.rows, i, leaf, [], nxt)
                _, i, leaf, on_here, nxt_est = best
                if _DEBUG_REORDER:
                    print(f"#   + {getattr(best[2], 'name', '?')} -> "
                          f"{best[0]:,.0f} rows (on={len(best[3])})")
                remaining.pop(i)
                jt = L.JoinType.INNER if on_here else L.JoinType.CROSS
                # build-side selection (reference: JoinSelection's
                # swap_hash_join, physical-optimizer/src/join_selection.rs):
                # the physical join always builds on the RIGHT side, so the
                # larger input must stay left (probe). A 200k-row probe
                # against a 6M-row build would sort/scatter the 6M side.
                if ests[id(leaf)].rows > cur_est.rows:
                    current = L.Join(leaf, current,
                                     [(b, a) for a, b in on_here], jt, None)
                else:
                    current = L.Join(current, leaf, on_here, jt, None)
                cur_est = nxt_est
                cost += cur_est.rows
                for pr in on_here:
                    for orig in list(unused_pairs):
                        if orig == pr or (orig[1], orig[0]) == pr:
                            unused_pairs.remove(orig)
                            break
                changed = True
                while changed:
                    changed = False
                    for semi in list(pending):
                        if semi_attachable(semi, current.schema):
                            current, cur_est = apply_semi(current, cur_est,
                                                          semi, memo)
                            pending.remove(semi)
                            cost += cur_est.rows
                            changed = True
            for semi in pending:  # should not happen; keep semantics anyway
                current, cur_est = apply_semi(current, cur_est, semi, memo)
                cost += cur_est.rows
            return cost, current, unused_pairs

        best_cost, best_plan, best_left = None, None, None
        for s in range(len(leaves)):
            try:
                c, pl, leftover = greedy(s)
            except Exception:
                if _DEBUG_REORDER:
                    import traceback
                    traceback.print_exc()
                continue
            if _DEBUG_REORDER:
                print(f"# reorder start={getattr(leaves[s], 'name', leaves[s])}"
                      f" cost={c:,.0f}")
            if best_cost is None or c < best_cost:
                best_cost, best_plan, best_left = c, pl, leftover
        if best_plan is None:
            return p
        extra = [E.BinaryOp(E.Op.EQ, a, b) for a, b in best_left] + filters
        pred = conjoin(extra)
        return L.Filter(best_plan, pred) if pred is not None else best_plan

    return L.transform_up(plan, rewrite)


def limit_into_sort_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if isinstance(p, L.Limit) and p.fetch is not None and isinstance(p.input, L.Sort):
            s = p.input
            fetch = p.skip + p.fetch
            if s.fetch is None or s.fetch > fetch:
                s = L.Sort(s.input, s.sort_specs, fetch)
            return L.Limit(s, p.skip, p.fetch) if p.skip else s if p.fetch == fetch else L.Limit(s, 0, p.fetch)
        return p

    return L.transform_up(plan, rewrite)


def prune_join_columns_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Project away join-input columns consumed only BELOW the join.

    A pushed-down filter keeps its column alive in the scan (it must read
    it), but once the filter has applied, nothing above needs it -- yet the
    physical join materializes its WHOLE output schema through packed
    probe-capacity payload gathers (ops/joinimpl lane packing), so every
    dead column rides the hot path. TPC-H Q3 at SF1: `o_orderdate` (consumed
    by the pushed filter, re-attached later by the late-materialization
    re-scan) cost ~2 lanes x 8.4M gathered rows in the lineitem join.
    Reference analog: OptimizeProjections' requirement propagation
    (optimizer/src/optimize_projections/).

    Top-down needed-set walk with the same namespace boundaries as
    projection_pruning_rule; nodes with whole-row or positional semantics
    (Distinct/Union/Unnest/RecursiveQuery/SubqueryAlias) conservatively
    need every child column."""

    def own_refs(p) -> Set[Tuple[Optional[str], str]]:
        out = set()
        for e in p.exprs():
            for c in E.collect_columns(e):
                out.add((c.qualifier, c.cname))
        return out

    def is_needed(f, refs) -> bool:
        for rq, rn in refs:
            if rn == f.name and (rq is None or f.qualifier is None
                                 or rq == f.qualifier):
                return True
        return False

    PASS_THROUGH = (L.Filter, L.Sort, L.Limit, L.Join, L.Window)

    def rewrite(p: L.LogicalPlan, refs) -> L.LogicalPlan:
        if isinstance(p, (L.Projection, L.Aggregate)):
            refs = own_refs(p)  # fresh output namespace
        elif isinstance(p, PASS_THROUGH):
            refs = refs | own_refs(p)
        else:
            # whole-row / positional semantics: every child column is needed
            kids = [rewrite(c, {(f.qualifier, f.name) for f in c.schema.fields})
                    for c in p.children()]
            return p.with_children(kids) if p.children() else p

        if isinstance(p, L.Join):
            sides = []
            for side in (p.left, p.right):
                fields = side.schema.fields
                keep = [f for f in fields if is_needed(f, refs)]
                names = [f.name for f in fields]
                prunable = (
                    0 < len(keep) < len(fields)
                    and not isinstance(side, L.Projection)
                    and len({(f.qualifier, f.name) for f in fields}) == len(fields)
                    and all(f.qualifier is not None or names.count(f.name) == 1
                            for f in keep))
                if prunable:
                    side = L.Projection(
                        side, [E.Column(f.name, f.qualifier) for f in keep])
                sides.append(rewrite(side, refs))
            return L.Join(sides[0], sides[1], p.on, p.join_type, p.filter)

        kids = [rewrite(c, refs) for c in p.children()]
        return p.with_children(kids) if p.children() else p

    return rewrite(plan, {(f.qualifier, f.name) for f in plan.schema.fields})


def semi_join_through_aggregate_rule(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Push a selective inner equi-join below an aggregate as a semi join
    on the group key (reference analog: the aggregate-pushdown family of
    optimizations; TPC-H Q17's shape).

        Join(Agg(groupBy=[k,...])(T), R, on k = rk, INNER)
          -> Join(Agg(groupBy=[k,...])(T leftsemi R on k = rk), R, ...)

    Unconditionally sound for INNER joins keyed on a group expression: the
    semi join only removes T rows of groups the outer join would drop.
    Worth it when R is much smaller than T (the aggregate's input then
    compacts to the surviving rows); gated on estimated cardinalities."""
    from .cost import estimate

    def trace_to_group_key(side: L.LogicalPlan, key: E.Expr):
        """Follow `key` down through SubqueryAlias/Projection wrappers by
        output position; return (path, agg, group_index) when it lands on a
        group expression of an Aggregate."""
        try:
            idx = side.schema.index_of(key.flat_name) \
                if isinstance(key, E.Column) else None
        except Exception:  # noqa: BLE001 -- unresolvable: no match
            return None
        if idx is None:
            return None
        path = []
        node = side
        while True:
            if isinstance(node, L.SubqueryAlias):
                path.append(node)
                node = node.input
            elif isinstance(node, L.Projection):
                e = node.proj_exprs[idx]
                while isinstance(e, E.Alias):
                    e = e.expr
                if not isinstance(e, E.Column):
                    return None
                try:
                    idx = node.input.schema.index_of(e.flat_name)
                except Exception:  # noqa: BLE001
                    return None
                path.append(node)
                node = node.input
            elif isinstance(node, L.Aggregate):
                if idx < len(node.group_exprs):
                    return path, node, idx
                return None
            else:
                return None

    def rebuild(path, old_agg, new_agg):
        node = new_agg
        for p in reversed(path):
            node = p.with_children([node])
        return node

    def rewrite(p: L.LogicalPlan) -> L.LogicalPlan:
        if not isinstance(p, L.Join) or p.join_type is not L.JoinType.INNER \
                or not p.on:
            return p
        for agg_on_left in (True, False):
            side = p.left if agg_on_left else p.right
            other = p.right if agg_on_left else p.left
            for lk, rk in p.on:
                key = lk if agg_on_left else rk
                okey = rk if agg_on_left else lk
                hit = trace_to_group_key(side, key)
                if hit is None:
                    continue
                path, agg, gidx = hit
                if isinstance(agg.input, L.Join) and \
                        agg.input.join_type is L.JoinType.LEFT_SEMI:
                    continue  # already pushed
                try:
                    agg_rows = estimate(agg.input).rows
                    other_rows = estimate(other).rows
                except Exception:  # noqa: BLE001 -- no stats: skip
                    continue
                if not (other_rows * 8 < agg_rows):
                    continue
                semi = L.Join(agg.input, other,
                              [(agg.group_exprs[gidx], okey)],
                              L.JoinType.LEFT_SEMI)
                new_agg = L.Aggregate(semi, agg.group_exprs, agg.aggr_exprs)
                new_side = rebuild(path, agg, new_agg)
                return L.Join(new_side if agg_on_left else p.left,
                              p.right if agg_on_left else new_side,
                              p.on, p.join_type, p.filter)
        return p

    return L.transform_up(plan, rewrite)
