# Verbatim copy of datafusion_tpu/sql/planner.py; host-only, kept in step with the original.
"""SQL AST -> LogicalPlan.

Capability analog of the reference's SqlToRel planner
(datafusion/sql/src/planner.rs:454 + select.rs/query.rs): name resolution with
nested scopes (outer references survive as qualified columns for the
decorrelation rule), star expansion, aggregate extraction from
SELECT/HAVING/ORDER BY, GROUP BY alias/ordinal resolution, CTEs, derived
tables, set operations."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from ..expr import nodes as E
from ..logical import plan as L
from . import ast as A


def _rename_columns(plan: L.LogicalPlan, cols) -> L.LogicalPlan:
    """CTE column alias list: WITH t(a, b) AS (...)."""
    from ..common.errors import PlanError

    if len(cols) != len(plan.schema):
        raise PlanError(f"CTE column list has {len(cols)} names for "
                        f"{len(plan.schema)} columns")
    proj = [E.Alias(E.Column(f.name, f.qualifier), nm)
            for f, nm in zip(plan.schema.fields, cols)]
    return L.Projection(plan, proj)


def _fold_to_literal(e: E.Expr) -> E.Literal:
    """Constant-fold a VALUES cell to a literal (literals, signs, casts)."""
    if isinstance(e, E.Literal):
        return e
    if isinstance(e, E.Alias):
        return _fold_to_literal(e.expr)
    if isinstance(e, E.Negative):
        inner = _fold_to_literal(e.expr)
        if inner.value is None:
            return inner
        return E.Literal(-inner.value, inner.dtype)
    if isinstance(e, E.Cast):
        inner = _fold_to_literal(e.expr)
        return E.Literal(inner.value, e.dtype)
    if isinstance(e, E.ScalarFunction) and e.fname == "arrow_cast" \
            and len(e.args) == 2 and isinstance(e.args[1], E.Literal):
        # VALUES (arrow_cast(x, 'Int8'), ...) — common reference fixture
        from ..physical.functions import parse_arrow_type

        inner = _fold_to_literal(e.args[0])
        return E.Literal(inner.value, parse_arrow_type(str(e.args[1].value)))
    raise PlanError(f"VALUES cells must be constant, got {e!r}")


def _ast_refs_table(node, key: str) -> bool:
    """Does this AST sub-tree reference table `key` in any FROM clause?"""
    if isinstance(node, A.SelectStmt):
        return (any(_ast_refs_table(s, key) for _, _, s in node.ctes)
                or _ast_refs_table(node.body, key))
    if isinstance(node, A.SetOp):
        return _ast_refs_table(node.left, key) or _ast_refs_table(node.right, key)
    if isinstance(node, A.SelectCore):
        if any(_ast_refs_table(f, key) for f in node.from_):
            return True
        exprs = [i.expr for i in node.items]
        exprs += [node.where] if node.where is not None else []
        exprs += [node.having] if node.having is not None else []
        return any(_expr_refs_table(e, key) for e in exprs)
    if isinstance(node, A.Relation):
        return node.name.lower() == key
    if isinstance(node, A.Derived):
        return _ast_refs_table(node.query, key)
    if isinstance(node, A.JoinRef):
        return _ast_refs_table(node.left, key) or _ast_refs_table(node.right, key)
    return False


def _expr_refs_table(e, key: str) -> bool:
    if isinstance(e, (A.SqlScalarSubquery, A.SqlExists)):
        return _ast_refs_table(e.query, key)
    if isinstance(e, A.SqlInSubquery):
        return _ast_refs_table(e.query, key) or _expr_refs_table(e.expr, key)
    if isinstance(e, E.Expr):
        return any(_expr_refs_table(c, key) for c in e.children())
    return False


def replace_topdown(e: E.Expr, mapping: Dict[E.Expr, E.Expr]) -> E.Expr:
    if e in mapping:
        return mapping[e]

    def fn(x: E.Expr) -> E.Expr:
        return x

    # rebuild children with replacement applied before descending
    def rec(x: E.Expr) -> E.Expr:
        if x in mapping:
            return mapping[x]
        return E.map_expr(x, lambda y: mapping.get(y, y)) if False else _rebuild(x)

    def _rebuild(x: E.Expr) -> E.Expr:
        import dataclasses

        if not dataclasses.is_dataclass(x):
            return x
        changes = {}
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, E.Expr):
                changes[f.name] = rec(v)
            elif isinstance(v, tuple) and v and all(isinstance(i, E.Expr) or (isinstance(i, tuple)) for i in v):
                new = []
                for i in v:
                    if isinstance(i, E.Expr):
                        new.append(rec(i))
                    elif isinstance(i, tuple):
                        new.append(tuple(rec(j) if isinstance(j, E.Expr) else j for j in i))
                    else:
                        new.append(i)
                changes[f.name] = tuple(new)
        if changes:
            return dataclasses.replace(x, **changes)
        return x

    return rec(e)


class SqlPlanner:
    def __init__(self, catalog, outer_schemas: Optional[List[Schema]] = None,
                 ctes: Optional[Dict[str, L.LogicalPlan]] = None):
        self.catalog = catalog
        self.outer_schemas = outer_schemas or []
        self.ctes = dict(ctes or {})

    # ------------------------------------------------------------------
    def plan_statement(self, stmt) -> L.LogicalPlan:
        if isinstance(stmt, A.SelectStmt):
            return self.plan_query(stmt)
        raise PlanError(f"cannot plan {type(stmt).__name__} here")

    def plan_query(self, q: A.SelectStmt, strip_projection: bool = False) -> L.LogicalPlan:
        ctes = dict(self.ctes)
        for name, cols, sub in q.ctes:
            key = name.lower()
            if q.recursive and _ast_refs_table(sub, key):
                sub_plan = self._plan_recursive_cte(key, cols, sub, ctes)
            else:
                sub_plan = SqlPlanner(self.catalog, self.outer_schemas, ctes).plan_query(sub)
                if cols:
                    sub_plan = _rename_columns(sub_plan, cols)
            ctes[key] = sub_plan
        planner = SqlPlanner(self.catalog, self.outer_schemas, ctes)
        plan = planner.plan_body(q.body, q, strip_projection)
        return plan

    def _plan_recursive_cte(self, key: str, cols, sub: A.SelectStmt,
                            ctes) -> L.LogicalPlan:
        """WITH RECURSIVE name AS (static UNION ALL step) (reference:
        LogicalPlan::RecursiveQuery, expr/src/logical_plan/plan.rs;
        RecursiveQueryExec physical-plan/src/recursive_query.rs:66)."""
        body = sub.body
        if not isinstance(body, A.SetOp) or body.op not in ("union", "union_all"):
            raise PlanError(
                f"recursive CTE {key!r} must be `static UNION ALL recursive`")
        if body.op == "union":
            raise PlanError(
                f"recursive CTE {key!r}: UNION DISTINCT is not supported; "
                "use UNION ALL")
        static_plan = SqlPlanner(self.catalog, self.outer_schemas, ctes) \
            .plan_body(body.left, A.SelectStmt(body.left), False)
        if cols:
            static_plan = _rename_columns(static_plan, cols)
        from ..catalog.catalog import WorkTable
        from ..common.schema import Field, Schema

        wt_schema = Schema([Field(f.name, f.dtype, f.nullable)
                            for f in static_plan.schema.fields])
        wt = WorkTable(key, wt_schema)
        wt_scan = L.TableScan(key, wt)
        ctes2 = dict(ctes)
        ctes2[key] = wt_scan
        rec_plan = SqlPlanner(self.catalog, self.outer_schemas, ctes2) \
            .plan_body(body.right, A.SelectStmt(body.right), False)
        if len(rec_plan.schema) != len(static_plan.schema):
            raise PlanError(
                f"recursive CTE {key!r}: static and recursive arms have "
                "different column counts")
        names = [f.name for f in static_plan.schema.fields]
        if [f.name for f in rec_plan.schema.fields] != names:
            rec_plan = _rename_columns(rec_plan, names)
        return L.RecursiveQuery(key, static_plan, rec_plan, wt)

    def plan_body(self, body, q: A.SelectStmt, strip_projection: bool) -> L.LogicalPlan:
        if isinstance(body, A.SetOp):
            left = self.plan_body(body.left, A.SelectStmt(body.left), False)
            right = self.plan_body(body.right, A.SelectStmt(body.right), False)
            if body.op in ("union", "union_all"):
                u = L.Union([left, right], all=True)
                plan = u if body.op == "union_all" else L.Distinct(u)
            elif body.op == "intersect":
                on = [(E.Column(f.name, f.qualifier), E.Column(g.name, g.qualifier))
                      for f, g in zip(left.schema.fields, right.schema.fields)]
                plan = L.Distinct(L.Join(left, right, on, L.JoinType.LEFT_SEMI, None))
            elif body.op == "except":
                on = [(E.Column(f.name, f.qualifier), E.Column(g.name, g.qualifier))
                      for f, g in zip(left.schema.fields, right.schema.fields)]
                plan = L.Distinct(L.Join(left, right, on, L.JoinType.LEFT_ANTI, None))
            else:
                raise PlanError(f"unsupported set op {body.op}")
            return self._order_limit(plan, q, None)
        if isinstance(body, A.SelectStmt):
            # parenthesized subquery as body
            inner = self.plan_query(body)
            return self._order_limit(inner, q, None)
        return self.plan_select_core(body, q, strip_projection)

    # ------------------------------------------------------------------
    def plan_select_core(self, core: A.SelectCore, q: A.SelectStmt,
                         strip_projection: bool) -> L.LogicalPlan:
        # GROUPING SETS / ROLLUP / CUBE: expand into a UNION ALL of per-set
        # aggregations with NULL-filled absent group columns (reference:
        # ResolveGroupingFunction + grouping-set planning,
        # optimizer/src/analyzer/resolve_grouping_function.rs)
        if core.grouping_sets is not None:
            import dataclasses as _dc

            def fold_grouping(x, gset):
                # grouping(a[, b, ...]) -> bitmask literal: bit is 1 when the
                # column is NOT in this branch's grouping set (reference:
                # analyzer/resolve_grouping_function.rs)
                if isinstance(x, E.ScalarFunction) and x.fname == "grouping":
                    bits = 0
                    for a in x.args:
                        bits = (bits << 1) | (0 if any(a == g for g in gset) else 1)
                    return E.Literal(bits, T.INT64)
                return x

            all_gcols = list(core.group_by or [])
            if not all_gcols:
                for gs in core.grouping_sets:
                    for g in gs:
                        if not any(g == x for x in all_gcols):
                            all_gcols.append(g)

            def subst_absent(x, absent):
                # NULL-fill references to group columns absent from this
                # branch's set, OUTSIDE aggregate arguments (inside an
                # aggregate the name is a row value, not a group key) --
                # e.g. TPC-DS q36's `case when grouping(i_class)=0 then
                # i_category end` window partition key on the total branch
                if any(x == g for g in absent):
                    return E.Literal(None, T.NULL)
                if isinstance(x, E.AggregateFunction) or not _dc.is_dataclass(x):
                    return x
                def sub_v(v):
                    if isinstance(v, E.Expr):
                        return subst_absent(v, absent)
                    if isinstance(v, tuple):
                        return tuple(sub_v(i) for i in v)
                    return v

                changes = {}
                for f in _dc.fields(x):
                    v = getattr(x, f.name)
                    nv = sub_v(v)
                    if nv is not v and nv != v:
                        changes[f.name] = nv
                return _dc.replace(x, **changes) if changes else x

            branches = []
            for gset in core.grouping_sets:
                absent = [g for g in all_gcols if not any(g == s for s in gset)]
                new_items = []
                for it in core.items:
                    expr = E.map_expr(it.expr, lambda x: fold_grouping(x, gset)) \
                        if not isinstance(it.expr, A.Star) else it.expr
                    in_group = any(it.expr == g for g in (core.group_by or []))
                    in_set = any(it.expr == g for g in gset)
                    if in_group and not in_set:
                        alias = it.alias or it.expr.name()
                        new_items.append(A.SelectItem(E.Literal(None, T.NULL), alias))
                    else:
                        if not isinstance(expr, A.Star):
                            expr = subst_absent(expr, absent)
                        new_items.append(A.SelectItem(expr, it.alias))
                having = None if core.having is None else \
                    subst_absent(E.map_expr(core.having,
                                            lambda x: fold_grouping(x, gset)),
                                 absent)
                sub = _dc.replace(core, items=new_items, group_by=list(gset),
                                  grouping_sets=None, having=having)
                branches.append(self.plan_select_core(sub, A.SelectStmt(sub), False))
            u = L.Union(branches, all=True)
            return self._order_limit(u, q, None)

        if core.group_by:
            # plain GROUP BY: grouping(col) over a grouped column is 0
            def fold_plain(x):
                if isinstance(x, E.ScalarFunction) and x.fname == "grouping":
                    return E.Literal(0, T.INT64)
                return x

            import dataclasses as _dc

            new_items = [
                it if isinstance(it.expr, A.Star)
                else A.SelectItem(E.map_expr(it.expr, fold_plain), it.alias)
                for it in core.items]
            having = None if core.having is None else \
                E.map_expr(core.having, fold_plain)
            core = _dc.replace(core, items=new_items, having=having)

        # 1. FROM
        if core.from_:
            plan = self.plan_table_ref(core.from_[0])
            for tr in core.from_[1:]:
                right = self.plan_table_ref(tr)
                plan = L.Join(plan, right, [], L.JoinType.CROSS, None)
        else:
            plan = L.EmptyRelation(True)
        schema = plan.schema

        # 2. WHERE
        if core.where is not None:
            pred = self.resolve(core.where, schema)
            plan = L.Filter(plan, pred)

        # 3. SELECT items (star expansion + resolution)
        items: List[Tuple[E.Expr, Optional[str]]] = []
        for it in core.items:
            if isinstance(it.expr, A.Star):
                for f in schema.fields:
                    if it.expr.qualifier is None or f.qualifier == it.expr.qualifier:
                        items.append((E.Column(f.name, f.qualifier), None))
            else:
                items.append((self.resolve(it.expr, schema), it.alias))

        having = self.resolve(core.having, schema) if core.having is not None else None
        order_items = [(self.resolve_order(it.expr, items, schema), it) for it in (q.order_by or [])]

        qualify = None
        if core.qualify is not None:
            # QUALIFY may reference select-list aliases (reference:
            # sql/src/select.rs qualify handling, test_files/qualify.slt)
            amap = {al: pe for pe, al in items if al is not None}

            def _alias_sub(x):
                if isinstance(x, E.Column) and x.qualifier is None \
                        and x.cname in amap:
                    return amap[x.cname]
                return x

            qualify = self.resolve(E.map_expr(core.qualify, _alias_sub),
                                   schema)

        # 4. GROUP BY resolution (ordinals / aliases / exprs)
        group_exprs: List[E.Expr] = []
        if core.group_by:
            for g in core.group_by:
                if isinstance(g, E.Literal) and isinstance(g.value, int) and not isinstance(g.value, bool):
                    group_exprs.append(items[g.value - 1][0])
                elif isinstance(g, E.Column) and g.qualifier is None and \
                        any(al == g.cname for _, al in items):
                    idx = next(i for i, (_, al) in enumerate(items) if al == g.cname)
                    group_exprs.append(items[idx][0])
                else:
                    group_exprs.append(self.resolve(g, schema))
            # GROUP BY a, a: duplicate keys group identically and would make
            # the aggregate schema ambiguous (reference dedupes too,
            # EliminateDuplicatedExpr)
            seen, uniq = set(), []
            for g in group_exprs:
                if g not in seen:  # structural equality: qualifiers count
                    seen.add(g)
                    uniq.append(g)
            group_exprs = uniq

        # 5. aggregate extraction
        agg_fns: List[E.AggregateFunction] = []

        def collect_aggs(e: E.Expr):
            if isinstance(e, E.AggregateFunction):
                if e not in agg_fns:
                    agg_fns.append(e)
                return
            for c in e.children():
                collect_aggs(c)

        for e, _ in items:
            collect_aggs(e)
        if having is not None:
            collect_aggs(having)
        if qualify is not None:
            collect_aggs(qualify)
        for oe, _ in order_items:
            collect_aggs(oe)

        if agg_fns or group_exprs:
            plan = L.Aggregate(plan, group_exprs, agg_fns)
            mapping: Dict[E.Expr, E.Expr] = {}
            for ge, f in zip(group_exprs, plan.schema.fields[: len(group_exprs)]):
                mapping[ge] = E.Column(f.name, f.qualifier)
            for af, f in zip(agg_fns, plan.schema.fields[len(group_exprs):]):
                mapping[af] = E.Column(f.name, f.qualifier)
            items = [(replace_topdown(e, mapping), al) for e, al in items]
            if having is not None:
                having = replace_topdown(having, mapping)
            if qualify is not None:
                qualify = replace_topdown(qualify, mapping)
            order_items = [(replace_topdown(oe, mapping), it) for oe, it in order_items]
            if having is not None:
                plan = L.Filter(plan, having)
        elif having is not None:
            raise PlanError("HAVING requires aggregation")

        # 5b. window function extraction (evaluated after aggregation)
        window_fns: List[E.WindowFunction] = []

        def collect_windows(e: E.Expr):
            if isinstance(e, E.WindowFunction):
                if e not in window_fns:
                    window_fns.append(e)
                return
            for c in e.children():
                collect_windows(c)

        for e, _ in items:
            collect_windows(e)
        if qualify is not None:
            collect_windows(qualify)
        for oe, _ in order_items:
            collect_windows(oe)
        if window_fns:
            plan = L.Window(plan, window_fns)
            wmap: Dict[E.Expr, E.Expr] = {}
            nbase = len(plan.schema) - len(window_fns)
            for wf, f in zip(window_fns, plan.schema.fields[nbase:]):
                wmap[wf] = E.Column(f.name, f.qualifier)
            items = [(replace_topdown(e, wmap), al) for e, al in items]
            order_items = [(replace_topdown(oe, wmap), it) for oe, it in order_items]
            if qualify is not None:
                plan = L.Filter(plan, replace_topdown(qualify, wmap))
        elif qualify is not None:
            raise PlanError("QUALIFY requires at least one window function")

        # 5c. select-list UNNEST extraction (reference: unnest() rewritten
        # to LogicalPlan::Unnest, sql/src/select.rs try_process_unnest)
        unnest_fns: List[E.Expr] = []

        def collect_unnests(e: E.Expr):
            if isinstance(e, E.ScalarFunction) and e.fname == "unnest":
                if len(e.args) != 1:
                    raise PlanError("unnest takes exactly one argument")
                if e not in unnest_fns:
                    unnest_fns.append(e)
                return
            for c in e.children():
                collect_unnests(c)

        for e, _ in items:
            collect_unnests(e)
        if unnest_fns:
            plan = L.Unnest(plan, [u.args[0] for u in unnest_fns])
            umap: Dict[E.Expr, E.Expr] = {}
            nbase = len(plan.schema) - len(unnest_fns)
            for uf, f in zip(unnest_fns, plan.schema.fields[nbase:]):
                umap[uf] = E.Column(f.name, f.qualifier)
            items = [(replace_topdown(e, umap),
                      al if al is not None or e not in umap else e.name())
                     for e, al in items]
            order_items = [(replace_topdown(oe, umap), it) for oe, it in order_items]

        # 6. projection (+ hidden sort columns), DISTINCT, ORDER BY, LIMIT
        if strip_projection:
            return plan
        visible = []
        for e, al in items:
            visible.append(E.Alias(e, al) if al is not None else e)

        specs: List[E.SortSpec] = []
        hidden: List[E.Expr] = []
        if order_items:
            vis_names = []
            probe = L.Projection(plan, visible)
            for pe, f in zip(visible, probe.schema.fields):
                vis_names.append((pe.expr if isinstance(pe, E.Alias) else pe, f))
            for oe, it in order_items:
                bound = None
                if isinstance(oe, E.Literal) and isinstance(oe.value, int) and not isinstance(oe.value, bool):
                    f = probe.schema.fields[oe.value - 1]
                    bound = E.Column(f.name, f.qualifier)
                else:
                    for inner, f in vis_names:
                        if oe == inner:
                            bound = E.Column(f.name, f.qualifier)
                            break
                if bound is None:
                    hname = f"__sort_{len(hidden)}"
                    hidden.append(E.Alias(oe, hname))
                    bound = E.Column(hname)
                specs.append(E.SortSpec(bound, it.asc,
                                        it.nulls_first if it.nulls_first is not None else not it.asc))

        proj = L.Projection(plan, visible + hidden)
        out: L.LogicalPlan = proj
        if core.distinct:
            if hidden:
                raise PlanError("ORDER BY expression must appear in SELECT DISTINCT list")
            out = L.Distinct(out)
        if specs:
            out = L.Sort(out, specs)
        if q.limit is not None or q.offset is not None:
            out = L.Limit(out, q.offset or 0, q.limit)
        if hidden:
            keep = [E.Column(f.name, f.qualifier) for f in proj.schema.fields[: len(visible)]]
            out = L.Projection(out, keep)
        return out

    # ------------------------------------------------------------------
    def _order_limit(self, plan: L.LogicalPlan, q: A.SelectStmt, order_ctx) -> L.LogicalPlan:
        if q.order_by:
            specs = []
            if order_ctx is None:
                for it in q.order_by:
                    e = self.resolve(it.expr, plan.schema)
                    specs.append(E.SortSpec(e, it.asc,
                                            it.nulls_first if it.nulls_first is not None else not it.asc))
            else:
                order_items, proj, pre_schema = order_ctx
                out_schema = plan.schema
                for oe, it in order_items:
                    e = self._bind_order_expr(oe, it, plan, proj)
                    specs.append(E.SortSpec(e, it.asc,
                                            it.nulls_first if it.nulls_first is not None else not it.asc))
            plan = L.Sort(plan, specs)
        if q.limit is not None or q.offset is not None:
            plan = L.Limit(plan, q.offset or 0, q.limit)
        return plan

    def _bind_order_expr(self, oe: E.Expr, it: A.OrderItem, plan: L.LogicalPlan, proj: L.Projection) -> E.Expr:
        out_schema = plan.schema
        # ordinal
        if isinstance(oe, E.Literal) and isinstance(oe.value, int) and not isinstance(oe.value, bool):
            f = out_schema.fields[oe.value - 1]
            return E.Column(f.name, f.qualifier)
        # match a projection output by structural equality or alias
        for pe, f in zip(proj.proj_exprs, proj.schema.fields):
            inner = pe.expr if isinstance(pe, E.Alias) else pe
            if oe == inner or (isinstance(oe, E.Column) and oe.qualifier is None and oe.cname == f.name):
                return E.Column(f.name, f.qualifier)
        # fall back: expression over projection output schema
        return oe

    # ------------------------------------------------------------------
    def plan_table_ref(self, tr) -> L.LogicalPlan:
        if isinstance(tr, A.Relation):
            key = tr.name.lower()
            if key.startswith("information_schema."):
                return self._information_schema(key.split(".", 1)[1], tr.alias)
            if key in self.ctes:
                base = self.ctes[key]
                return L.SubqueryAlias(base, tr.alias or tr.name)
            views = getattr(self.catalog, "views", {})
            if key in views:
                return L.SubqueryAlias(views[key], tr.alias or tr.name)
            provider = self.catalog.get(tr.name)
            return L.TableScan(tr.name, provider, alias=tr.alias or tr.name)
        if isinstance(tr, A.Derived):
            sub = SqlPlanner(self.catalog, self.outer_schemas, self.ctes).plan_query(tr.query)
            if tr.columns:
                if len(tr.columns) != len(sub.schema):
                    raise PlanError(
                        f"derived table {tr.alias!r} has {len(sub.schema)} "
                        f"columns but {len(tr.columns)} aliases")
                exprs = [E.Alias(E.col(f.qualified_name), n)
                         for f, n in zip(sub.schema.fields, tr.columns)]
                sub = L.Projection(sub, exprs)
            return L.SubqueryAlias(sub, tr.alias)
        if isinstance(tr, A.ValuesTable):
            return self._plan_values_table(tr)
        if isinstance(tr, A.TableFunction):
            return self._plan_table_function(tr)
        if isinstance(tr, A.JoinRef):
            left = self.plan_table_ref(tr.left)
            right = self.plan_table_ref(tr.right)
            schema = left.schema.join(right.schema)
            jt = {"inner": L.JoinType.INNER, "left": L.JoinType.LEFT,
                  "right": L.JoinType.RIGHT, "full": L.JoinType.FULL,
                  "cross": L.JoinType.CROSS}[tr.kind]
            on_pairs: List[Tuple[E.Expr, E.Expr]] = []
            residual = None
            if tr.using:
                for c in tr.using:
                    lf = left.schema.field(c)
                    rf = right.schema.field(c)
                    on_pairs.append((E.Column(lf.name, lf.qualifier), E.Column(rf.name, rf.qualifier)))
            elif tr.on is not None:
                resolved = self.resolve(tr.on, schema)
                from ..optimizer.decorrelate import conjoin, split_conjuncts

                rest = []
                for conj in split_conjuncts(resolved):
                    if isinstance(conj, E.BinaryOp) and conj.op is E.Op.EQ:
                        l, r = conj.left, conj.right
                        if self._only_in(l, left.schema) and self._only_in(r, right.schema):
                            on_pairs.append((l, r))
                            continue
                        if self._only_in(r, left.schema) and self._only_in(l, right.schema):
                            on_pairs.append((r, l))
                            continue
                    rest.append(conj)
                residual = conjoin(rest)
            if jt is L.JoinType.CROSS:
                return L.Join(left, right, [], jt, None)
            return L.Join(left, right, on_pairs, jt, residual)
        raise PlanError(f"unsupported table ref {tr!r}")

    def _plan_table_function(self, tr) -> L.LogicalPlan:
        """FROM-position function call. Built-ins generate_series (inclusive
        stop) and range (exclusive stop) match the reference
        (functions-table/src/generate_series.rs); other names resolve to
        session-registered table UDFs (ctx.register_udtf)."""
        from ..catalog.catalog import MemTable
        from ..data.table import Table
        from ..expr.udf import active_registry

        vals = []
        for a in tr.args:
            lit = _fold_to_literal(a)
            if not isinstance(lit, E.Literal):
                raise PlanError(
                    f"table function {tr.name!r} arguments must be literals")
            vals.append(lit.value)

        if tr.name in ("generate_series", "range"):
            if not 1 <= len(vals) <= 3:
                raise PlanError(f"{tr.name} takes 1-3 arguments")
            if any(v is None for v in vals):
                rows = []
            else:
                start = int(vals[0]) if len(vals) > 1 else 0
                stop = int(vals[1]) if len(vals) > 1 else int(vals[0])
                step = int(vals[2]) if len(vals) > 2 else 1
                if step == 0:
                    raise PlanError(f"{tr.name} step must not be zero")
                end = stop + (0 if tr.name == "range" else
                              (1 if step > 0 else -1))
                rows = list(range(start, end, step))
            out = Table.from_pydict({"value": rows},
                                    {"value": T.INT64})
        else:
            udtf = active_registry().table(tr.name)
            if udtf is None:
                raise PlanError(f"unknown table function {tr.name!r}")
            res = udtf.fn(*vals)
            out = res if isinstance(res, Table) else Table.from_pydict(res)

        alias = tr.alias or tr.name
        plan: L.LogicalPlan = L.TableScan(alias, MemTable(out), alias=alias)
        if tr.columns:
            if len(tr.columns) != len(out.schema):
                raise PlanError(
                    f"table function {tr.name!r} has {len(out.schema)} "
                    f"columns but {len(tr.columns)} aliases")
            exprs = [E.Alias(E.col(f.qualified_name), n)
                     for f, n in zip(plan.schema.fields, tr.columns)]
            plan = L.SubqueryAlias(L.Projection(plan, exprs), alias)
        return plan

    def _plan_values_table(self, tr) -> L.LogicalPlan:
        """Inline VALUES relation -> L.Values (reference:
        LogicalPlan::Values, sql/src/query.rs VALUES planning). Cells fold to
        literals; per-column types unify numerically; default column names
        are column1..columnN like the reference. Rows whose cells are
        constant *expressions* rather than plain literals (make_array(...),
        named_struct(...), 'a' || 'b', date arithmetic — the reference allows
        any expression here) evaluate eagerly over a one-row EmptyRelation
        and land in an anonymous MemTable instead."""
        from ..common.schema import Field

        try:
            rows = [[_fold_to_literal(c) for c in row] for row in tr.rows]
        except PlanError:
            return self._plan_values_eval(tr)
        if not rows:
            raise PlanError("VALUES requires at least one row")
        ncols = len(rows[0])
        for r in rows:
            if len(r) != ncols:
                raise PlanError("VALUES rows have differing lengths")
        names = tr.columns or [f"column{i + 1}" for i in range(ncols)]
        if len(names) != ncols:
            raise PlanError(
                f"VALUES has {ncols} columns but {len(names)} aliases")
        fields = []
        for j in range(ncols):
            dtype = T.NULL
            nullable = False
            for r in rows:
                lv = r[j]
                if lv.value is None:
                    nullable = True
                elif dtype.kind is T.TypeKind.NULL:
                    dtype = lv.dtype
                elif lv.dtype != dtype and lv.dtype.is_numeric and dtype.is_numeric:
                    dtype = T.common_numeric_type(dtype, lv.dtype)
            if dtype.kind is T.TypeKind.NULL:
                dtype = T.INT64
            fields.append(Field(names[j], dtype, nullable))
        plan = L.Values(Schema(fields), rows)
        return L.SubqueryAlias(plan, tr.alias) if tr.alias else plan

    def _plan_values_eval(self, tr) -> L.LogicalPlan:
        """VALUES fallback for constant-expression cells: evaluate each row
        as a projection over a one-row EmptyRelation through the normal
        physical pipeline, then concatenate the host rows into a MemTable.
        Handles everything the expression evaluator supports (arrays,
        structs, maps, string/date arithmetic) at fixture-sized row counts."""
        from ..catalog.catalog import MemTable
        from ..data.device import to_host
        from ..data.table import Table
        from ..physical.planner import create_physical_plan
        from ..runtime.context import ExecContext

        ncols = len(tr.rows[0])
        for r in tr.rows:
            if len(r) != ncols:
                raise PlanError("VALUES rows have differing lengths")
        names = tr.columns or [f"column{i + 1}" for i in range(ncols)]
        if len(names) != ncols:
            raise PlanError(
                f"VALUES has {ncols} columns but {len(names)} aliases")
        ctx = ExecContext({})
        data = {n: [] for n in names}
        dtypes: Dict[str, T.DataType] = {}
        for row in tr.rows:
            plan = L.Projection(
                L.EmptyRelation(True),
                [E.Alias(c, n) for c, n in zip(row, names)])
            t = to_host(create_physical_plan(plan).execute(ctx))
            d = t.to_pydict()
            for f, n in zip(t.schema.fields, names):
                data[n].append(d[f.name][0])
                dt = f.dtype
                if dt.kind is T.TypeKind.NULL:
                    continue
                prev = dtypes.get(n)
                if prev is None or prev.kind is T.TypeKind.NULL:
                    dtypes[n] = dt
                elif prev != dt and prev.is_numeric and dt.is_numeric:
                    dtypes[n] = T.common_numeric_type(prev, dt)
        out = Table.from_pydict(data, dtypes)
        alias = tr.alias or "values"
        scan = L.TableScan(alias, MemTable(out), alias=alias)
        return scan

    def _information_schema(self, table: str, alias) -> L.LogicalPlan:
        """Virtual information_schema.{tables,columns} built from the catalog
        (reference: datafusion/catalog/src/information_schema.rs)."""
        from ..catalog.catalog import MemTable
        from ..data.table import Table

        if table == "tables":
            names = self.catalog.names()
            views = sorted(getattr(self.catalog, "views", {}))
            cats, schemas, bare = [], [], []
            for n in names:
                c, s, tn = self.catalog._split(n)
                cats.append(c)
                schemas.append(s)
                bare.append(tn)
            t = Table.from_pydict({
                "table_catalog": cats + [self.catalog.default_catalog] * len(views),
                "table_schema": schemas + [self.catalog.default_schema] * len(views),
                "table_name": bare + views,
                "table_type": ["BASE TABLE"] * len(names) + ["VIEW"] * len(views),
            })
        elif table == "schemata":
            cats, schemas = [], []
            for cn, cat in sorted(self.catalog.catalogs.items()):
                for sn in cat.schema_names():
                    cats.append(cn)
                    schemas.append(sn)
            t = Table.from_pydict({"catalog_name": cats,
                                   "schema_name": schemas})
        elif table == "columns":
            rows = {"table_name": [], "column_name": [], "ordinal_position": [],
                    "data_type": [], "is_nullable": []}
            for name in self.catalog.names():
                for i, f in enumerate(self.catalog.get(name).schema().fields):
                    rows["table_name"].append(name)
                    rows["column_name"].append(f.name)
                    rows["ordinal_position"].append(i + 1)
                    rows["data_type"].append(repr(f.dtype))
                    rows["is_nullable"].append("YES" if f.nullable else "NO")
            t = Table.from_pydict(rows)
        elif table == "df_settings":
            # session config values (reference: information_schema.rs
            # df_settings view)
            from ..common.config import REGISTRY

            session = getattr(self.catalog, "session", None)
            names, values, descs = [], [], []
            for k in sorted(REGISTRY):
                names.append(k)
                v = session.options.get(k) if session is not None \
                    else REGISTRY[k].default
                values.append("" if v is None else str(v))
                descs.append(REGISTRY[k].doc)
            t = Table.from_pydict({"name": names, "value": values,
                                   "description": descs})
        elif table == "routines":
            # registered functions: built-ins + session UDFs (reference:
            # information_schema.rs routines view)
            from ..physical.functions import builtin_function_names
            from ..sql.parser import Parser

            session = getattr(self.catalog, "session", None)
            rows = {"routine_name": [], "routine_type": []}

            def add(names, kind):
                for n in sorted(names):
                    rows["routine_name"].append(n)
                    rows["routine_type"].append(kind)

            add(builtin_function_names(), "SCALAR")
            add(Parser._AGG_FNS, "AGGREGATE")
            add(Parser._WINDOW_FNS, "WINDOW")
            if session is not None:
                reg = session.functions
                add(reg.scalars, "SCALAR")
                add(reg.aggregates, "AGGREGATE")
                add(reg.windows, "WINDOW")
                add(reg.tables, "TABLE")
            t = Table.from_pydict(rows)
        elif table == "views":
            # registered views with their SQL definition re-rendered by the
            # unparser (reference: information_schema.rs views)
            from ..sql.unparser import plan_to_sql

            names, defs = [], []
            for vn in sorted(getattr(self.catalog, "views", {})):
                names.append(vn)
                try:
                    defs.append(plan_to_sql(self.catalog.views[vn]))
                except Exception:  # noqa: BLE001 -- unrenderable plan shape
                    defs.append(None)
            t = Table.from_pydict({
                "table_catalog": [self.catalog.default_catalog] * len(names),
                "table_schema": [self.catalog.default_schema] * len(names),
                "table_name": names,
                "definition": defs,
            }, {"table_catalog": T.STRING, "table_schema": T.STRING,
                "table_name": T.STRING, "definition": T.STRING})
        elif table == "parameters":
            # routine parameter signatures for session UDFs (reference:
            # information_schema.rs parameters; built-ins are variadic /
            # overloaded so only typed user functions list here)
            rows = {"specific_name": [], "ordinal_position": [],
                    "parameter_mode": [], "data_type": []}
            session = getattr(self.catalog, "session", None)
            if session is not None:
                for kind in ("scalars", "aggregates", "windows"):
                    for n, f in sorted(getattr(session.functions, kind).items()):
                        rt = getattr(f, "return_type", None)
                        rows["specific_name"].append(n)
                        rows["ordinal_position"].append(1)
                        rows["parameter_mode"].append("OUT")
                        rows["data_type"].append(repr(rt) if rt is not None
                                                 else "ANY")
            t = Table.from_pydict(rows, {
                "specific_name": T.STRING, "ordinal_position": T.INT64,
                "parameter_mode": T.STRING, "data_type": T.STRING})
        else:
            raise PlanError(f"unknown information_schema table {table!r}")
        return L.TableScan(f"information_schema.{table}", MemTable(t),
                           alias=alias or table)

    @staticmethod
    def _only_in(e: E.Expr, schema: Schema) -> bool:
        cols = E.collect_columns(e)
        if not cols:
            return False
        for c in cols:
            try:
                if schema.find(c.flat_name) is None:
                    return False
            except PlanError:
                return False
        return True

    # ------------------------------------------------------------------
    def resolve_order(self, e: E.Expr, items, schema: Schema) -> E.Expr:
        """Resolve an ORDER BY expr: alias > ordinal > normal resolution."""
        if isinstance(e, E.Literal):
            return e
        if isinstance(e, E.Column) and e.qualifier is None:
            for pe, al in items:
                if al == e.cname:
                    return pe
        try:
            return self.resolve(e, schema)
        except PlanError:
            # SQL resolves ORDER BY names against the SELECT output list
            # before the FROM scope: a unique output column (aliased or the
            # expr's derived name, e.g. `ss_items.item_id` -> item_id) wins
            # even when the name is ambiguous among input relations
            # (reference: order_by resolution in sql/src/select.rs).
            if isinstance(e, E.Column) and e.qualifier is None:
                hits = [pe for pe, al in items
                        if (al or pe.name()) == e.cname]
                if len(hits) == 1:
                    return hits[0]
            raise

    def resolve(self, e: E.Expr, schema: Schema) -> E.Expr:
        """Resolve columns against schema (then outer scopes) and plan
        subquery expressions."""

        def rec(x: E.Expr, bound=frozenset()) -> E.Expr:
            if isinstance(x, E.Column):
                if x.qualifier is None and x.cname in bound:
                    return x  # lambda parameter: bound, not a scope column
                return self._resolve_column(x, schema)
            if isinstance(x, E.Lambda):
                import dataclasses

                return dataclasses.replace(
                    x, body=rec(x.body, bound | frozenset(x.params)))
            if isinstance(x, E.ScalarFunction):
                # a registered UDAF name parses as a generic function call;
                # promote it here so aggregate extraction sees it (reference:
                # sql planner's FunctionRegistry lookup, sql/src/expr/
                # function.rs)
                from ..expr.udf import active_registry

                if active_registry().aggregate(x.fname) is not None:
                    return E.AggregateFunction(
                        x.fname, tuple(rec(a, bound) for a in x.args), False)
            if isinstance(x, A.SqlScalarSubquery):
                sub = self._plan_subquery(x.query, schema)
                return E.ScalarSubquery(sub)
            if isinstance(x, A.SqlExists):
                sub = self._plan_subquery(x.query, schema, strip_projection=True)
                return E.Exists(sub, x.negated)
            if isinstance(x, A.SqlInSubquery):
                sub = self._plan_subquery(x.query, schema)
                return E.InSubquery(rec(x.expr, bound), sub, x.negated)
            # descend
            import dataclasses

            if not dataclasses.is_dataclass(x):
                return x
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, E.Expr):
                    changes[f.name] = rec(v, bound)
                elif isinstance(v, tuple):
                    new = []
                    dirty = False
                    for i in v:
                        if isinstance(i, E.Expr):
                            ni = rec(i, bound)
                            dirty = dirty or (ni is not i)
                            new.append(ni)
                        elif isinstance(i, tuple):
                            ni = tuple(rec(j, bound) if isinstance(j, E.Expr) else j for j in i)
                            dirty = True
                            new.append(ni)
                        else:
                            new.append(i)
                    if dirty:
                        changes[f.name] = tuple(new)
            if changes:
                return dataclasses.replace(x, **changes)
            return x

        return rec(e)

    def _resolve_column(self, c: E.Column, schema: Schema) -> E.Column:
        i = schema.find(c.flat_name)
        if i is not None:
            f = schema.fields[i]
            return E.Column(f.name, f.qualifier)
        for outer in self.outer_schemas:
            i = outer.find(c.flat_name)
            if i is not None:
                f = outer.fields[i]
                return E.Column(f.name, f.qualifier)
        raise PlanError(
            f"column {c.flat_name!r} not found in scope; available: "
            f"{[f.qualified_name for f in schema.fields]}"
        )

    def _plan_subquery(self, q: A.SelectStmt, schema: Schema,
                       strip_projection: bool = False) -> L.LogicalPlan:
        sub_planner = SqlPlanner(self.catalog, [schema] + self.outer_schemas, self.ctes)
        return sub_planner.plan_query(q, strip_projection=strip_projection)
