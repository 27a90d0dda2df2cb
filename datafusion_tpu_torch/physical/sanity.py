"""Physical plan sanity checking.

Port of datafusion_tpu/physical/sanity.py for the operators this package
has: after physical planning, walk the operator tree and verify structural
invariants that would otherwise surface as shape errors deep inside an
operator. Pure metadata walks, no device work; disable with
DATAFUSION_TPU_SKIP_SANITY_CHECK=1.
"""
from __future__ import annotations

import os
from typing import List

from ..common.errors import PlanError
from ..expr import nodes as E
from ..logical.plan import JoinType
from . import plan as P


def _check_exprs(exprs, schema, where: str, errors: List[str]):
    """Every column reference must resolve; expression types must infer."""
    from ..expr.typing import infer

    for e in exprs:
        if e is None:
            continue
        for c in E.collect_columns(e):
            try:
                if schema.find(c.flat_name) is None:
                    errors.append(
                        f"{where}: column {c.flat_name!r} not in input schema "
                        f"{[f.qualified_name for f in schema.fields]}")
            except PlanError:
                pass  # ambiguous = resolvable
        try:
            infer(e, schema)
        except PlanError as exc:
            errors.append(f"{where}: cannot type {e.name()!r}: {exc}")


def validate_plan(plan: P.PhysicalPlan) -> None:
    """Raise PlanError listing every structural violation in the tree."""
    if os.environ.get("DATAFUSION_TPU_SKIP_SANITY_CHECK", "") not in ("", "0"):
        return
    errors: List[str] = []
    _walk(plan, errors)
    if errors:
        raise PlanError("plan sanity check failed:\n  " + "\n  ".join(errors))


def _walk(p: P.PhysicalPlan, errors: List[str]) -> None:
    from .planner import AliasExec
    from .window import WindowExec

    for c in p.children():
        _walk(c, errors)
    name = type(p).__name__

    if isinstance(p, P.ProjectionExec):
        if len(p.exprs) != len(p.schema):
            errors.append(f"{name}: {len(p.exprs)} exprs vs "
                          f"{len(p.schema)}-column schema")
        _check_exprs(p.exprs, p.input.schema, name, errors)
    elif isinstance(p, P.FilterExec):
        if p.schema != p.input.schema:
            errors.append(f"{name}: schema must equal input schema")
        _check_exprs([p.predicate], p.input.schema, name, errors)
    elif isinstance(p, (P.LimitExec, P.DistinctExec, P.CompactExec)):
        if p.schema != p.input.schema:
            errors.append(f"{name}: schema must equal input schema")
    elif isinstance(p, P.SortExec):
        if p.schema != p.input.schema:
            errors.append(f"{name}: schema must equal input schema")
        _check_exprs([s.expr for s in p.specs], p.input.schema, name, errors)
        if p.fetch is not None and p.fetch < 0:
            errors.append(f"{name}: negative fetch {p.fetch}")
    elif isinstance(p, P.AggregateExec):
        if len(p.group_exprs) + len(p.agg_exprs) != len(p.schema):
            errors.append(
                f"{name}: {len(p.group_exprs)} keys + {len(p.agg_exprs)} "
                f"aggregates vs {len(p.schema)}-column schema")
        _check_exprs(p.group_exprs, p.input.schema, f"{name} keys", errors)
        for a in p.agg_exprs:
            inner = a.expr if isinstance(a, E.Alias) else a
            if not isinstance(inner, E.AggregateFunction):
                errors.append(f"{name}: non-aggregate expr {a.name()!r}")
            else:
                _check_exprs(list(inner.args), p.input.schema,
                             f"{name} args", errors)
    elif isinstance(p, P.JoinExec):
        both = p.left.schema.join(p.right.schema)
        for l, r in p.on:
            _check_exprs([l], p.left.schema, f"{name} left key", errors)
            _check_exprs([r], p.right.schema, f"{name} right key", errors)
        _check_exprs([p.filter], both, f"{name} filter", errors)
        if p.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            want = len(p.left.schema)
        elif p.join_type in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            want = len(p.right.schema)
        else:
            want = len(both)
        if len(p.schema) != want:
            errors.append(f"{name} ({p.join_type.value}): schema has "
                          f"{len(p.schema)} columns, expected {want}")
    elif isinstance(p, P.UnionExec):
        for c in p.inputs:
            if len(c.schema) != len(p.schema):
                errors.append(
                    f"{name}: input with {len(c.schema)} columns vs "
                    f"{len(p.schema)}-column union schema")
    elif isinstance(p, P.UnnestExec):
        _check_exprs(p.unnest_exprs, p.input.schema, name, errors)
        want = len(p.input.schema) + len(p.unnest_exprs)
        if len(p.schema) != want:
            errors.append(f"{name}: schema has {len(p.schema)} columns, "
                          f"expected {want}")
    elif isinstance(p, AliasExec):
        if len(p.schema) != len(p.input.schema):
            errors.append(f"{name}: column count changed "
                          f"{len(p.input.schema)} -> {len(p.schema)}")
    elif isinstance(p, WindowExec):
        want = len(p.input.schema) + len(p.window_exprs)
        if len(p.schema) != want:
            errors.append(f"{name}: schema has {len(p.schema)} columns, "
                          f"expected {want}")
