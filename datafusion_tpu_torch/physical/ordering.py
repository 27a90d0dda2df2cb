"""Output-ordering propagation and sort elision.

Port of datafusion_tpu/physical/ordering.py for the operators this package
has. Both aggregate paths emit their groups ascending by key (dense codes
are order-preserving; the sort path sorts by the keys), and DISTINCT its
rows ascending by every column, so a SortExec over the same keys -- TPC-H
Q1's ORDER BY -- is planned as presorted and costs nothing. Inner joins
emit matched rows in probe order, and semi/anti joins mask their probe side.
A window keeps its input's row order; a window top-k emits its survivors
sorted by (partition keys, rank, order keys).
Orderings are (schema_index, asc, nulls_first) prefixes over each operator's
own output schema.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..expr import nodes as E
from . import plan as P

Ordering = List[Tuple[int, bool, bool]]


def output_ordering(p: P.PhysicalPlan) -> Optional[Ordering]:
    from .planner import AliasExec
    from .window import WindowExec, WindowTopKExec

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
    if isinstance(p, (WindowExec, P.UnnestExec)):
        # window results are gathered back to the input's row order; an
        # unnest repeats each input row in place
        inner = output_ordering(p.input)
        if inner is None:
            return None
        n = len(p.input.schema)
        return [o for o in inner if o[0] < n] or None
    if isinstance(p, WindowTopKExec):
        # survivors come out in (partition asc nulls last, order spec) order;
        # the rank column may be claimed before the order keys, since equal
        # ranks imply equal order keys (peers): [pcols, rank, ocols]
        w = p.wfn
        out: Ordering = []
        for pe in w.partition_by:
            idx = _column_index(pe, p.input.schema)
            if idx is None:
                return out or None
            out.append((idx, True, False))
        out.append((len(p.schema) - 1, True, False))
        for s in w.order_by:
            idx = _column_index(s.expr, p.input.schema)
            if idx is None:
                return out or None
            out.append((idx, s.asc, s.nulls_first))
        return out
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
    if isinstance(p, P.JoinExec):
        from ..logical.plan import JoinType

        if p.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            # output = masked probe relation, order untouched
            return output_ordering(p.left)
        if p.join_type in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return output_ordering(p.right)
        if p.join_type is JoinType.INNER:
            # matched rows are emitted by probe row (residual filters only
            # mask), so the probe (left) side's ordering survives
            return output_ordering(p.left)
        return None
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
