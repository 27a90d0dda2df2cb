"""Aggregate specifications shared by the aggregate operator.

Port of the declarations in datafusion_tpu/ops/groupby.py that
physical/plan.py reads. The sort-based grouping itself (phase_sort,
phase_reduce, _reduce_one, global_aggregate) is not ported yet: ROADMAP
queue 1, item 5."""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..common import types as T


@dataclasses.dataclass
class AggSpec:
    fname: str  # count, count_star, sum, avg, min, max, var.., stddev.., first, last
    arg: Optional[int]  # index into agg arg column list (None for count(*))
    distinct: bool
    out_dtype: T.DataType
    arg_dtype: Optional[T.DataType] = None
    filter: Optional[int] = None  # index into filter mask list
    extra: Optional[float] = None  # percentile q etc.
    # agg(x ORDER BY y): index of the order expression in the arg column
    # list + direction (reference: params.order_by; single-key subset)
    order_arg: Optional[int] = None
    order_desc: bool = False
    # first_value(x IGNORE NULLS): skip null argument rows
    ignore_nulls: bool = False


_ORDER_SENSITIVE = frozenset({"median", "approx_median", "percentile_cont",
                              "approx_percentile_cont", "approx_distinct",
                              "array_agg", "string_agg"})

# aggregates the arithmetic dense-key path cannot evaluate (they need the
# sorted path's is_start/run structure)
DENSE_UNSUPPORTED = frozenset({"bit_and", "bit_or", "bit_xor", "nth_value"})
