"""Scalar functions: typing and device evaluation.

Port of the TPC-H and h2o.ai subset of datafusion_tpu/physical/functions.py:
`power` / `pow` (h2o q9's `power(corr(v1, v2), 2)`), the date parts
`date_part` / `extract` / `year` / `month` / `day` of a DATE (TPC-H
Q7-Q9's `extract(year from ...)`), and `substr` / `substring` on
dictionary strings (Q22), plus LIKE (`eval_like`). Every other scalar
function raises NotImplementedError naming its ROADMAP item, at typing
(planning) time.

String work runs on the host over a column's dictionary (its distinct
values) and reaches the rows as one gather of a small lookup table copied
to the column's device: O(distinct) host work and one host-to-device copy
per call, O(rows) device work.
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from ..data.column import Dictionary
from ..data.device import DeviceColumn
from ..expr import nodes as E
from ..utils import dates as DU
from .expr_compiler import _combine_validity, _not_ported, _to_float

_DATE_PARTS = frozenset({"date_part", "extract", "year", "month", "day"})
_PORTED = frozenset({"power", "pow", "substr", "substring"}) | _DATE_PARTS


def builtin_function_names() -> set:
    """Every scalar-function name the port evaluates."""
    return set(_PORTED)


def scalar_function_type(e: E.ScalarFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    if e.fname not in _PORTED:
        raise _not_ported(f"scalar function {e.fname!r}")
    argt = [infer(a, schema) for a in e.args]
    nullable = any(n for _, n in argt)
    if e.fname in _DATE_PARTS:
        return T.INT64, nullable
    if e.fname in ("substr", "substring"):
        return T.STRING, nullable
    return T.FLOAT64, nullable


# ---------------------------------------------------------------------------
# dictionary transforms
# ---------------------------------------------------------------------------


def _lookup(table: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """table[codes] on the codes' device (codes clamped into the table)."""
    lut = torch.from_numpy(table).to(codes.device)
    return lut[torch.clamp(codes, 0, len(table) - 1).long()]


def _dictionary_text(col: DeviceColumn) -> np.ndarray:
    d = col.dictionary
    if d is None or not len(d.values):
        return np.array([], "U1")
    return np.asarray(d.values, dtype="U")


def transform_dictionary(col: DeviceColumn, values_fn) -> DeviceColumn:
    """Apply a host transform over the dictionary's distinct values and
    re-encode: a new sorted dictionary and a per-row code remap."""
    if col.dictionary is None:
        raise PlanError("string op on non-dictionary column")
    if col.dtype is not None and col.dtype.is_binary:
        raise PlanError("string function not supported on BINARY")
    new_vals = values_fn(_dictionary_text(col))
    if not len(new_vals):
        return DeviceColumn(torch.zeros_like(col.data), col.validity, T.STRING,
                            Dictionary(np.array([], dtype=object)))
    uniq = np.unique(new_vals)
    remap = np.searchsorted(uniq, new_vals).astype(np.int32)
    return DeviceColumn(_lookup(remap, col.data), col.validity, T.STRING,
                        Dictionary(uniq.astype(object)))


def dict_predicate(col: DeviceColumn, pred_fn) -> torch.Tensor:
    """A host predicate over the dictionary's values, as a per-row bool
    tensor (one lookup-table gather). Used for LIKE."""
    vals = _dictionary_text(col)
    if not len(vals):
        return torch.zeros(col.data.shape[0], dtype=torch.bool, device=col.data.device)
    return _lookup(pred_fn(vals).astype(bool), col.data)


def like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


def eval_like(col: DeviceColumn, pattern: str, case_insensitive: bool = False) -> torch.Tensor:
    rx = re.compile(like_to_regex(pattern), re.IGNORECASE if case_insensitive else 0)

    def pred(vals: np.ndarray) -> np.ndarray:
        return np.fromiter((rx.match(v) is not None for v in vals), dtype=bool,
                           count=len(vals))

    return dict_predicate(col, pred)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------


def _literal_value(e: E.Expr):
    if isinstance(e, (E.Alias, E.Cast)):
        return _literal_value(e.expr)
    if isinstance(e, E.Literal):
        return e.value
    if isinstance(e, E.Negative):
        return -_literal_value(e.expr)
    raise PlanError(f"expected literal argument, got {e!r}")


def _year_of(day: int) -> int:
    d64 = np.datetime64("1970-01-01") + np.timedelta64(int(day), "D")
    return int(d64.astype("datetime64[Y]").astype(int)) + 1970


def _date_part(part: str, datecol: DeviceColumn, validity) -> DeviceColumn:
    """year / month / day of a DATE column as int64, civil-from-days integer
    arithmetic (floor division, so dates before 1970 come out right). The
    bounds of year follow from the column's day bounds (year is monotone in
    days), which lets GROUP BY and joins on it prove small dense domains."""
    if datecol.dtype.kind is not T.TypeKind.DATE32 or part not in ("year", "month", "day"):
        raise _not_ported(f"date part {part!r} of {datecol.dtype}")
    y, m, d = DU.civil_from_days(datecol.data)
    bounds = None
    if datecol.bounds is not None:
        bounds = {"year": (_year_of(datecol.bounds[0]), _year_of(datecol.bounds[1])),
                  "month": (1, 12), "day": (1, 31)}[part]
    val = {"year": y, "month": m, "day": d}[part]
    return DeviceColumn(val.to(torch.int64), validity, T.INT64, bounds=bounds)


def eval_scalar_function(fname: str, args: List[DeviceColumn],
                         arg_exprs: Sequence[E.Expr]) -> DeviceColumn:
    validity = _combine_validity(*(a.validity for a in args))
    if fname in ("power", "pow"):
        return DeviceColumn(torch.pow(_to_float(args[0]), _to_float(args[1])),
                            validity, T.FLOAT64)
    if fname in _DATE_PARTS:
        if fname in ("date_part", "extract"):
            part, datecol = str(_literal_value(arg_exprs[0])).lower(), args[1]
        else:
            part, datecol = fname, args[0]
        return _date_part(part, datecol, validity)
    if fname in ("substr", "substring"):
        start = int(_literal_value(arg_exprs[1]))
        length = int(_literal_value(arg_exprs[2])) if len(arg_exprs) > 2 else None
        i0 = max(start - 1, 0)
        i1 = None if length is None else i0 + max(length, 0)
        return transform_dictionary(
            args[0], lambda vals: np.array([v[i0:i1] for v in vals], dtype="U"))
    raise _not_ported(f"scalar function {fname!r}")
