# Verbatim copy of datafusion_tpu/logical/plan.py; host-only, kept in step with the original.
"""Logical plan IR.

Capability analog of the reference's `LogicalPlan` enum
(datafusion/expr/src/logical_plan/plan.rs:211): Projection, Filter, Aggregate,
Sort, Join, Limit, Distinct, Union, SubqueryAlias, TableScan, Values, Window,
EmptyRelation.  Each node derives its output Schema eagerly (like DFSchema on
the reference nodes) so optimizer rules can type-check rewrites.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Field, Schema
from ..expr import nodes as E
from ..expr.typing import infer


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI = "leftsemi"
    LEFT_ANTI = "leftanti"
    RIGHT_SEMI = "rightsemi"
    RIGHT_ANTI = "rightanti"
    CROSS = "cross"


class LogicalPlan:
    schema: Schema

    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def with_children(self, children: Sequence["LogicalPlan"]) -> "LogicalPlan":
        assert not children
        return self

    def exprs(self) -> Tuple[E.Expr, ...]:
        return ()

    def display(self, indent: int = 0) -> str:
        pad = "  " * indent
        line = pad + self._display_line()
        return "\n".join([line] + [c.display(indent + 1) for c in self.children()])

    def _display_line(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.display()


class TableScan(LogicalPlan):
    def __init__(self, name: str, source, projection: Optional[List[str]] = None,
                 filters: Tuple[E.Expr, ...] = (), alias: Optional[str] = None):
        self.name = name
        self.source = source  # TableProvider
        self.projection = projection
        self.filters = tuple(filters)
        self.alias = alias or name
        base = source.schema().with_qualifier(self.alias)
        if projection is not None:
            base = Schema([base.field(c) for c in projection])
        self.schema = base

    def exprs(self):
        return self.filters

    def _display_line(self):
        p = f" projection={self.projection}" if self.projection is not None else ""
        f = f" filters={len(self.filters)}" if self.filters else ""
        return f"TableScan: {self.name}{p}{f}"


class EmptyRelation(LogicalPlan):
    """Zero or one row; carries a schema when standing in for a pruned
    relation (reference: EmptyRelation with schema, used by
    PropagateEmptyRelation -- optimizer/src/propagate_empty_relation.rs)."""

    def __init__(self, produce_one_row: bool = True,
                 schema: Optional[Schema] = None):
        self.produce_one_row = produce_one_row
        self.schema = schema if schema is not None else Schema([])


class Values(LogicalPlan):
    def __init__(self, schema: Schema, rows: List[List[E.Literal]]):
        self.schema = schema
        self.rows = rows


class Projection(LogicalPlan):
    def __init__(self, input: LogicalPlan, proj_exprs: Sequence[E.Expr]):
        self.input = input
        self.proj_exprs = tuple(proj_exprs)
        fields = []
        for e in self.proj_exprs:
            dt, nullable = infer(e, input.schema)
            q = None
            if isinstance(e, E.Column):
                q = e.qualifier or input.schema.field(e.flat_name).qualifier
            elif isinstance(e, E.Alias):
                q = e.qualifier
            fields.append(Field(e.name(), dt, nullable, q))
        self.schema = Schema(fields)

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Projection(c[0], self.proj_exprs)

    def exprs(self):
        return self.proj_exprs

    def _display_line(self):
        return f"Projection: {', '.join(e.name() for e in self.proj_exprs)}"


class Filter(LogicalPlan):
    def __init__(self, input: LogicalPlan, predicate: E.Expr):
        self.input = input
        self.predicate = predicate
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Filter(c[0], self.predicate)

    def exprs(self):
        return (self.predicate,)

    def _display_line(self):
        return f"Filter: {self.predicate.name()}"


class Aggregate(LogicalPlan):
    def __init__(self, input: LogicalPlan, group_exprs: Sequence[E.Expr],
                 aggr_exprs: Sequence[E.Expr]):
        self.input = input
        self.group_exprs = tuple(group_exprs)
        self.aggr_exprs = tuple(aggr_exprs)  # AggregateFunction possibly under Alias
        fields = []
        for e in self.group_exprs:
            dt, nullable = infer(e, input.schema)
            q = e.qualifier if isinstance(e, E.Column) else None
            fields.append(Field(e.name(), dt, nullable, q))
        for e in self.aggr_exprs:
            dt, nullable = infer(e, input.schema)
            fields.append(Field(e.name(), dt, nullable))
        self.schema = Schema(fields)

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Aggregate(c[0], self.group_exprs, self.aggr_exprs)

    def exprs(self):
        return self.group_exprs + self.aggr_exprs

    def _display_line(self):
        return (f"Aggregate: groupBy=[{', '.join(e.name() for e in self.group_exprs)}], "
                f"aggr=[{', '.join(e.name() for e in self.aggr_exprs)}]")


class Sort(LogicalPlan):
    def __init__(self, input: LogicalPlan, sort_specs: Sequence[E.SortSpec],
                 fetch: Optional[int] = None):
        self.input = input
        self.sort_specs = tuple(sort_specs)
        self.fetch = fetch
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Sort(c[0], self.sort_specs, self.fetch)

    def exprs(self):
        return self.sort_specs

    def _display_line(self):
        keys = ", ".join(
            f"{s.expr.name()} {'ASC' if s.asc else 'DESC'}" for s in self.sort_specs
        )
        f = f" fetch={self.fetch}" if self.fetch is not None else ""
        return f"Sort: {keys}{f}"


class Limit(LogicalPlan):
    def __init__(self, input: LogicalPlan, skip: int = 0, fetch: Optional[int] = None):
        self.input = input
        self.skip = skip
        self.fetch = fetch
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Limit(c[0], self.skip, self.fetch)

    def _display_line(self):
        return f"Limit: skip={self.skip}, fetch={self.fetch}"


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 on: Sequence[Tuple[E.Expr, E.Expr]], join_type: JoinType,
                 filter: Optional[E.Expr] = None):
        self.left = left
        self.right = right
        self.on = tuple(on)
        self.join_type = join_type
        self.filter = filter
        lt, rt = left.schema, right.schema
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            self.schema = lt
        elif join_type in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            self.schema = rt
        else:
            lf = list(lt.fields)
            rf = list(rt.fields)
            if join_type in (JoinType.RIGHT, JoinType.FULL):
                lf = [dataclasses.replace(f, nullable=True) for f in lf]
            if join_type in (JoinType.LEFT, JoinType.FULL):
                rf = [dataclasses.replace(f, nullable=True) for f in rf]
            self.schema = Schema(lf + rf)

    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return Join(c[0], c[1], self.on, self.join_type, self.filter)

    def exprs(self):
        out = []
        for l, r in self.on:
            out += [l, r]
        if self.filter is not None:
            out.append(self.filter)
        return tuple(out)

    def _display_line(self):
        on = ", ".join(f"{l.name()} = {r.name()}" for l, r in self.on)
        f = f" filter={self.filter.name()}" if self.filter is not None else ""
        return f"Join: type={self.join_type.value} on=[{on}]{f}"


class SubqueryAlias(LogicalPlan):
    def __init__(self, input: LogicalPlan, alias: str):
        self.input = input
        self.alias = alias
        self.schema = input.schema.with_qualifier(alias)

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return SubqueryAlias(c[0], self.alias)

    def _display_line(self):
        return f"SubqueryAlias: {self.alias}"


class Distinct(LogicalPlan):
    def __init__(self, input: LogicalPlan):
        self.input = input
        self.schema = input.schema

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Distinct(c[0])


class Union(LogicalPlan):
    def __init__(self, inputs: Sequence[LogicalPlan], all: bool = True):
        self.inputs = list(inputs)
        self.all = all
        first = self.inputs[0].schema
        for p in self.inputs[1:]:
            if len(p.schema) != len(first):
                raise PlanError("UNION inputs have different column counts")
        # field types: first input whose field is typed (NULL-literal branches
        # from grouping-set expansion defer typing to their siblings)
        fields = []
        for i, f in enumerate(first.fields):
            dtype = f.dtype
            nullable = f.nullable
            for p in self.inputs:
                pf = p.schema.fields[i]
                nullable = nullable or pf.nullable or pf.dtype.kind is T.TypeKind.NULL
                if dtype.kind is T.TypeKind.NULL and pf.dtype.kind is not T.TypeKind.NULL:
                    dtype = pf.dtype
            fields.append(Field(f.name, dtype, nullable, None))
        self.schema = Schema(fields)

    def children(self):
        return tuple(self.inputs)

    def with_children(self, c):
        return Union(list(c), self.all)

    def _display_line(self):
        return f"Union: all={self.all}"


class Unnest(LogicalPlan):
    """Explode list expressions to rows (reference: LogicalPlan::Unnest,
    expr/src/logical_plan/plan.rs; UnnestExec physical-plan/src/unnest.rs:65).
    Appends one element column per expression to the input schema; each input
    row expands to max(list lengths) rows, zipping multiple lists (shorter
    lists pad with NULL); rows whose lists are all empty/NULL vanish."""

    def __init__(self, input: LogicalPlan, unnest_exprs: Sequence[E.Expr],
                 names: Optional[Sequence[str]] = None):
        self.input = input
        self.unnest_exprs = tuple(unnest_exprs)
        self.names = tuple(names) if names is not None else tuple(
            f"__unnest{i}" for i in range(len(self.unnest_exprs)))
        fields = list(input.schema.fields)
        for e, nm in zip(self.unnest_exprs, self.names):
            dt, _ = infer(e, input.schema)
            if not dt.is_list:
                raise PlanError(f"UNNEST argument must be a list, got {dt}")
            fields.append(Field(nm, dt.elem, nullable=True))
        self.schema = Schema(fields)

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Unnest(c[0], self.unnest_exprs, self.names)

    def exprs(self):
        return self.unnest_exprs

    def _display_line(self):
        return f"Unnest: {', '.join(e.name() for e in self.unnest_exprs)}"


class RecursiveQuery(LogicalPlan):
    """WITH RECURSIVE: static arm seeds a working table; the recursive arm
    re-executes against the previous iteration's rows until it produces none
    (reference: LogicalPlan::RecursiveQuery, expr/src/logical_plan/plan.rs;
    WorkTable physical-plan/src/work_table.rs)."""

    def __init__(self, name: str, static_plan: LogicalPlan,
                 recursive_plan: LogicalPlan, work_table):
        self.name = name
        self.static_plan = static_plan
        self.recursive_plan = recursive_plan
        self.work_table = work_table
        self.schema = static_plan.schema

    def children(self):
        return (self.static_plan, self.recursive_plan)

    def with_children(self, c):
        return RecursiveQuery(self.name, c[0], c[1], self.work_table)

    def exprs(self):
        return ()

    def _display_line(self):
        return f"RecursiveQuery: {self.name}"


class Window(LogicalPlan):
    def __init__(self, input: LogicalPlan, window_exprs: Sequence[E.Expr]):
        self.input = input
        self.window_exprs = tuple(window_exprs)
        fields = list(input.schema.fields)
        for e in self.window_exprs:
            dt, nullable = infer(e, input.schema)
            fields.append(Field(e.name(), dt, nullable))
        self.schema = Schema(fields)

    def children(self):
        return (self.input,)

    def with_children(self, c):
        return Window(c[0], self.window_exprs)

    def exprs(self):
        return self.window_exprs

    def _display_line(self):
        return f"Window: {', '.join(e.name() for e in self.window_exprs)}"


def transform_up(plan: LogicalPlan, fn, _memo=None) -> LogicalPlan:
    """Bottom-up plan rewrite (reference: TreeNode::transform_up,
    datafusion/common/src/tree_node.rs). Shared sub-plans (CTEs referenced
    multiple times) rewrite to ONE shared result so downstream planning can
    compute them once."""
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(plan))
    if hit is not None:
        return hit[1]
    out = plan
    children = plan.children()
    if children:
        new_children = [transform_up(c, fn, _memo) for c in children]
        if any(n is not o for n, o in zip(new_children, children)):
            out = plan.with_children(new_children)
    out = fn(out)
    # the memo value pins the keyed node: id() keys are only unique while
    # the object is alive, and rewrites can drop intermediate nodes whose
    # ids the allocator then reuses (observed as nondeterministic plan
    # corruption on TPC-DS q88's eight shared sub-plans)
    _memo[id(plan)] = (plan, out)
    return out


def transform_down(plan: LogicalPlan, fn, _memo=None) -> LogicalPlan:
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(plan))
    if hit is not None:
        return hit[1]
    out = fn(plan)
    mid = out  # pin fn's output: its children are this call's memo keys
    children = out.children()
    if children:
        new_children = [transform_down(c, fn, _memo) for c in children]
        if any(n is not o for n, o in zip(new_children, children)):
            out = out.with_children(new_children)
    _memo[id(plan)] = (plan, out, mid)
    return out
