"""Output-ordering propagation and sort elision.

Port of datafusion_tpu/physical/ordering.py for the operators this package
has. Both aggregate paths emit their groups ascending by key (dense codes
are order-preserving; the sort path sorts by the keys), and DISTINCT its
rows ascending by every column, so a SortExec over the same keys -- TPC-H
Q1's ORDER BY -- is planned as presorted and costs nothing. Orderings are
(schema_index, asc, nulls_first) prefixes over each operator's own output
schema.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..expr import nodes as E
from . import plan as P

Ordering = List[Tuple[int, bool, bool]]


def output_ordering(p: P.PhysicalPlan) -> Optional[Ordering]:
    from .planner import AliasExec

    if isinstance(p, P.AggregateExec):
        if not p.group_exprs:
            return None  # single row: trivially sorted, nothing to elide
        # both the sorted path and the dense path emit groups ascending by
        # key, NULL keys last
        return [(j, True, False) for j in range(len(p.group_exprs))]
    if isinstance(p, P.DistinctExec):
        return [(j, True, False) for j in range(len(p.schema))]
    if isinstance(p, P.SortExec):
        out: Ordering = []
        for s in p.specs:
            idx = _column_index(s.expr, p.schema)
            if idx is None:
                break
            out.append((idx, s.asc, s.nulls_first))
        return out or None
    if isinstance(p, (P.FilterExec, P.LimitExec, P.CompactExec, AliasExec)):
        return output_ordering(p.input)
    if isinstance(p, P.ProjectionExec):
        inner = output_ordering(p.input)
        if inner is None:
            return None
        # map input field index -> first output position projecting it
        mapping = {}
        for j, e in enumerate(p.exprs):
            base = e.expr if isinstance(e, E.Alias) else e
            if isinstance(base, E.Column):
                idx = _find(p.input.schema, base.flat_name)
                if idx is not None and idx not in mapping:
                    mapping[idx] = j
        out = []
        for idx, asc, nf in inner:
            if idx not in mapping:
                break
            out.append((mapping[idx], asc, nf))
        return out or None
    return None


def _find(schema, name: str) -> Optional[int]:
    try:
        return schema.find(name)
    except Exception:  # noqa: BLE001 -- ambiguous
        return None


def _column_index(e: E.Expr, schema) -> Optional[int]:
    base = e.expr if isinstance(e, E.Alias) else e
    if not isinstance(base, E.Column):
        return None
    return _find(schema, base.flat_name)


def ordering_satisfies(p: P.PhysicalPlan,
                       specs: Sequence[E.SortSpec]) -> bool:
    """True when p's output is already ordered by `specs` (prefix match on
    column positions, direction, and null placement)."""
    have = output_ordering(p)
    if have is None or len(specs) > len(have):
        return False
    for (idx, asc, nf), s in zip(have, specs):
        sidx = _column_index(s.expr, p.schema)
        if sidx is None or sidx != idx or s.asc != asc or s.nulls_first != nf:
            return False
    return True
