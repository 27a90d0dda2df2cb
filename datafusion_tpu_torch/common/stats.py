# Verbatim copy of datafusion_tpu/common/stats.py; host-only, kept in step with the original.
"""Table and column statistics for cost-based planning.

Capability analog of the reference's `Statistics` / `ColumnStatistics`
(datafusion/common/src/stats.rs:368,31).  All values are estimates (the
reference's `Precision::{Exact,Inexact}` distinction collapses to floats
here; planning decisions never need exactness).

NDV is estimated without an O(n log n) distinct pass: string columns carry
sorted dictionaries whose size IS the exact distinct count, and integer/date
key columns in analytic schemas are near-dense so ``min(max-min+1, rows)``
is a tight bound.  Floats/decimals fall back to row count (pessimistic for
joins, which is the safe direction).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class ColumnStatistics:
    null_count: float = 0.0
    min_value: Optional[float] = None  # numeric/ordinal view (dates = days)
    max_value: Optional[float] = None
    ndv: Optional[float] = None  # distinct count estimate

    def scaled(self, frac: float, rows_after: float) -> "ColumnStatistics":
        """Column stats after a filter keeping `frac` of rows."""
        ndv = None if self.ndv is None else max(1.0, min(self.ndv, rows_after))
        return ColumnStatistics(self.null_count * frac, self.min_value,
                                self.max_value, ndv)


@dataclasses.dataclass
class Statistics:
    num_rows: float
    columns: Dict[str, ColumnStatistics] = dataclasses.field(default_factory=dict)
    _table: object = None  # host Table for lazy exact-NDV resolution
    # reference keeps Precision::{Exact,Inexact} per value; planning only
    # needs it for row counts (AggregateStatistics answers count(*) from
    # stats), so one flag suffices
    exact_rows: bool = False

    def ndv(self, name: str) -> Optional[float]:
        """Distinct count for one column; an exact one-time `np.unique` pass
        (cached) when the cheap estimate was not already exact.  Join-key
        cardinality drives join ordering, so exactness here is worth one
        host pass (reference: Precision::Exact distinct_count)."""
        c = self.columns.get(name)
        if c is None:
            return None
        if c.ndv is not None and getattr(c, "_ndv_exact", True):
            return c.ndv
        if self._table is None:
            return c.ndv
        try:
            col = self._table.column(name)
            data = np.asarray(col.data)
            live = data if col.validity is None else data[np.asarray(col.validity)]
            c.ndv = float(np.unique(live).size)
            c._ndv_exact = True
        except Exception:
            pass
        return c.ndv


def _ordinal(v) -> Optional[float]:
    try:
        f = float(v)
        return f if math.isfinite(f) else None
    except (TypeError, ValueError):
        return None


def column_statistics(col) -> ColumnStatistics:
    """Compute stats for one HostColumn (data/column.py) in O(n) vector ops."""
    data = np.asarray(col.data)
    valid = col.validity
    nulls = 0.0 if valid is None else float(len(data) - int(np.sum(valid)))
    live = data if valid is None else data[np.asarray(valid)]
    out = ColumnStatistics(null_count=nulls)
    if col.dictionary is not None:
        out.ndv = float(col.dictionary.size)
        if live.size:
            out.min_value = float(live.min())
            out.max_value = float(live.max())
        return out
    if live.size == 0 or data.ndim != 1:
        out.ndv = 0.0 if live.size == 0 else None
        return out
    if np.issubdtype(live.dtype, np.integer):
        mn, mx = float(live.min()), float(live.max())
        out.min_value, out.max_value = mn, mx
        out.ndv = float(min(mx - mn + 1, live.size))
        out._ndv_exact = False  # dense-range bound; Statistics.ndv() refines
    elif np.issubdtype(live.dtype, np.floating):
        mn, mx = float(np.min(live)), float(np.max(live))
        if math.isfinite(mn) and math.isfinite(mx):
            out.min_value, out.max_value = mn, mx
        out.ndv = float(live.size)
        out._ndv_exact = False
    elif live.dtype == np.bool_:
        out.min_value, out.max_value = 0.0, 1.0
        out.ndv = 2.0
    return out


def table_statistics(table) -> Statistics:
    """Stats for a host Table keyed by column name."""
    cols = {}
    for f, c in zip(table.schema.fields, table.columns):
        try:
            if f.dtype.is_list:
                continue
            cols[f.name] = column_statistics(c)
        except Exception:  # stats are advisory: never fail a query over them
            continue
    return Statistics(float(table.num_rows), cols, _table=table,
                      exact_rows=True)
