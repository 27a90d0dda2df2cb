"""Scalar functions: typing and device evaluation.

Port of the TPC-H and h2o.ai subset of datafusion_tpu/physical/functions.py:
`power` / `pow` (h2o q9's `power(corr(v1, v2), 2)`), the date parts
`date_part` / `extract` / `year` / `month` / `day` of a DATE (TPC-H
Q7-Q9's `extract(year from ...)`), and `substr` / `substring` on
dictionary strings (Q22), plus LIKE (`eval_like`). Every other scalar
function raises NotImplementedError naming its ROADMAP item, at typing
(planning) time.

String work runs on the host over a column's dictionary (its distinct
values) and reaches the rows as one gather of a small lookup table on the
column's device. Both are made once per dictionary and cached
(expr_compiler.dictionary_work): O(distinct) host work and one
host-to-device copy per dictionary, O(rows) device work per call.
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
from .expr_compiler import (_combine_validity, _not_ported, _to_float,
                            dictionary_text, dictionary_work)

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


_ARROW_PARSE = {
    "null": T.NULL, "boolean": T.BOOL, "bool": T.BOOL,
    "int8": T.INT8, "int16": T.INT16, "int32": T.INT32, "int64": T.INT64,
    # unsigned widths widen into the next signed type this engine carries
    "uint8": T.INT16, "uint16": T.INT32, "uint32": T.INT64,
    "uint64": T.INT64,
    "float16": T.FLOAT32, "float32": T.FLOAT32, "float64": T.FLOAT64,
    "utf8": T.STRING, "largeutf8": T.STRING, "utf8view": T.STRING,
    "binary": T.BINARY, "largebinary": T.BINARY, "binaryview": T.BINARY,
    "date32": T.DATE32,
}


def parse_arrow_type(s: str) -> T.DataType:
    """Parse the type-name argument of `arrow_cast` (host-only: the SQL
    planner folds VALUES cells with it)."""
    t = s.strip()
    low = t.lower()
    if low in _ARROW_PARSE:
        return _ARROW_PARSE[low]
    if re.match(r"fixedsizebinary\s*\(\s*\d+\s*\)", low):
        return T.BINARY  # fixed width is metadata only
    m = re.match(r"decimal(?:128|256)?\s*\(\s*(\d+)\s*,\s*(\d+)\s*\)", low)
    if m:
        return T.decimal(int(m.group(1)), int(m.group(2)))
    if low.startswith("timestamp"):
        return T.TIMESTAMP
    if low.startswith("date64"):
        return T.DATE32
    if low.startswith("time32") or low.startswith("time64"):
        return T.TIME
    if low.startswith("duration"):
        return T.INTERVAL_US
    if low.startswith("interval"):
        return (T.INTERVAL_MONTHS if "yearmonth" in low.replace(" ", "")
                else T.INTERVAL_US)
    m = re.match(r"dictionary\s*\(\s*\w+\s*,\s*(.+)\)\s*$", low)
    if m:
        # Dictionary(K, V) casts behave as V: strings are dictionary-encoded
        # anyway
        return parse_arrow_type(m.group(1))
    m = re.match(r"(?:large)?list\s*\(\s*(.+)\)\s*$", low)
    if m:
        return T.list_of(parse_arrow_type(m.group(1)))
    m = re.match(r"fixedsizelist\s*\(\s*(\d+)\s*,\s*(.+)\)\s*$", low)
    if m:
        return T.list_of(parse_arrow_type(m.group(2)))
    raise PlanError(f"arrow_cast: unsupported type {s!r}")


# ---------------------------------------------------------------------------
# dictionary transforms
# ---------------------------------------------------------------------------


def _gather(work, i: int, codes: torch.Tensor) -> torch.Tensor:
    """work.value[i][codes] on the codes' device (codes clamped into it)."""
    lut = work.table(i, codes.device)
    return lut[torch.clamp(codes, 0, len(work.value[i]) - 1).long()]


def transform_dictionary(col: DeviceColumn, op: str, args: tuple,
                         values_fn) -> DeviceColumn:
    """Apply a host transform over the dictionary's distinct values and
    re-encode: a new sorted dictionary and a per-row code remap. Cached per
    (dictionary, op, args): a hit returns the same new Dictionary object, so
    merges downstream of it are cached too."""
    if col.dictionary is None:
        raise PlanError("string op on non-dictionary column")
    if col.dtype is not None and col.dtype.is_binary:
        raise PlanError("string function not supported on BINARY")

    def compute():
        new_vals = values_fn(dictionary_text(col.dictionary))
        if not len(new_vals):
            return Dictionary(np.array([], dtype=object)), np.zeros(0, np.int32)
        uniq = np.unique(new_vals)
        return (Dictionary(uniq.astype(object)),
                np.searchsorted(uniq, new_vals).astype(np.int32))

    work = dictionary_work((col.dictionary,), op, args, compute)
    new_dict, remap = work.value
    if not len(remap):
        return DeviceColumn(torch.zeros_like(col.data), col.validity, T.STRING,
                            new_dict)
    return DeviceColumn(_gather(work, 1, col.data), col.validity, T.STRING,
                        new_dict)


def dict_predicate(col: DeviceColumn, op: str, args: tuple,
                   pred_fn) -> torch.Tensor:
    """A host predicate over the dictionary's values, as a per-row bool
    tensor (one lookup-table gather); the table is cached per (dictionary,
    op, args). Used for LIKE."""
    if col.dictionary is None or not len(col.dictionary.values):
        return torch.zeros(col.data.shape[0], dtype=torch.bool, device=col.data.device)
    work = dictionary_work(
        (col.dictionary,), op, args,
        lambda: (pred_fn(dictionary_text(col.dictionary)).astype(bool),))
    return _gather(work, 0, col.data)


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

    return dict_predicate(col, "like", (pattern, case_insensitive), pred)


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
            args[0], "substring", (i0, i1),
            lambda vals: np.array([v[i0:i1] for v in vals], dtype="U"))
    raise _not_ported(f"scalar function {fname!r}")
