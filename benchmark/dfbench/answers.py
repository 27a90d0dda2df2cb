"""The plain references' answers and the comparison that decides `correct`.

A reference answers each query with an `Answer`: its columns (`RefCol`) and
the ORDER BY the program's rows must respect. `judge` holds one host table
that the program returned against it and gives:

- `mismatch`: a message where an exact part differs (the row count, a
  column's name, an integer, date, decimal or string value, a NULL, the row
  order), else None. Decimals are exact in units of their scale.
- `float_gap`: the widest gap of a floating-point value, relative to the
  larger of the reference's magnitude and the median magnitude of its
  column in the answer (so that values near 0 do not blow the ratio up).

Rows are matched by sorting both sides on every exact column; a float that
the query selects and does not compute (`RefCol.exact`) sorts and compares
as an exact value. NumPy only."""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

NULL_INT = np.iinfo(np.int64).min


class RefCol(NamedTuple):
    name: str
    kind: str  # "int", "date", "decimal", "string", "float"
    values: np.ndarray  # strings: objects, or codes into `dictionary`
    scale: int = 0  # decimals: units of 10**-scale
    dictionary: Optional[np.ndarray] = None  # sorted; with codes in values
    exact: bool = False  # a float selected, not computed: compared exactly


class Answer(NamedTuple):
    columns: List[RefCol]
    order: List[Tuple[int, bool]]  # (column index, descending) of ORDER BY


class Verdict(NamedTuple):
    mismatch: Optional[str]
    float_gap: float


def _program_column(col, field_name: str, ref: RefCol):
    """(int64 or float64 values comparable with ref's, error message)."""
    dtype = col.dtype
    data = np.asarray(col.data)
    valid = None if col.validity is None else np.asarray(col.validity, dtype=bool)
    if ref.kind == "string":
        if col.dictionary is None:
            return None, f"{field_name} is {dtype}, not a string"
        values = np.asarray(col.dictionary.values, dtype=object)
        if ref.dictionary is not None:
            # the program's dictionary into the reference's codes (-2: absent)
            where = {s: i for i, s in enumerate(ref.dictionary)}
            table = np.array([where.get(s, -2) for s in values], dtype=np.int64)
        else:
            table = values
        out = table[data] if len(values) else np.zeros(len(data), dtype=table.dtype)
        if valid is not None:
            out = np.where(valid, out, None if ref.dictionary is None else NULL_INT)
        return out, None
    if ref.kind == "float":
        if getattr(dtype, "is_decimal", False):
            out = data.astype(np.float64) / 10.0 ** dtype.scale
        else:
            out = data.astype(np.float64)
        if valid is not None:
            out = np.where(valid, out, np.nan)
        return out, None
    if ref.kind == "decimal":
        if not getattr(dtype, "is_decimal", False):
            return None, f"{field_name} is {dtype}, not decimal(_, {ref.scale})"
        if dtype.scale != ref.scale:
            return None, f"{field_name} has scale {dtype.scale}, not {ref.scale}"
    elif data.dtype.kind not in "iu":
        return None, f"{field_name} is {dtype}, not an integer or date"
    out = data.astype(np.int64)
    if valid is not None:
        out = np.where(valid, out, NULL_INT)
    return out, None


def _ref_values(ref: RefCol) -> np.ndarray:
    v = np.asarray(ref.values)
    if ref.kind == "float":
        return v.astype(np.float64)
    if ref.kind == "string":
        return v if ref.dictionary is None else v.astype(np.int64)
    return v.astype(np.int64)


def _sort_key(v: np.ndarray) -> np.ndarray:
    """An integer sort key of a column: codes of strings, float bits."""
    if v.dtype == object:
        _, inv = np.unique(v.astype(str), return_inverse=True)
        return inv.reshape(-1).astype(np.int64)
    if v.dtype.kind == "f":
        return np.where(v == 0, 0.0, v).view(np.int64)
    return v


def _row_order(keys: List[np.ndarray], n: int) -> np.ndarray:
    """The permutation sorting rows on all key columns (first most
    significant). Columns are packed into one int64 while their ranges fit."""
    if not keys or n == 0:
        return np.arange(n)
    packed, span, groups = np.zeros(n, dtype=np.int64), 1, []
    for k in keys:
        lo, hi = int(k.min()), int(k.max())
        width = hi - lo + 1
        if width > (1 << 62) // span:
            groups.append(packed if span > 1 else None)
            packed, span = np.zeros(n, dtype=np.int64), 1
            if width > (1 << 62):  # a key that spans everything sorts alone
                groups.append(k)
                continue
        packed = packed * width + (k - lo)
        span *= width
    groups.append(packed)
    groups = [g for g in groups if g is not None]
    order = np.argsort(groups[0], kind="stable")
    if len(groups) == 1:
        return order
    first = groups[0][order]
    if not np.any(first[1:] == first[:-1]):
        return order  # the leading columns already tell every row apart
    return np.lexsort(groups[::-1])


def _joint_sort_keys(a: np.ndarray, b: np.ndarray):
    """Sort keys of two columns on one scale (strings coded together)."""
    if a.dtype == object or b.dtype == object:
        both = np.concatenate([a.astype(str), b.astype(str)])
        _, inv = np.unique(both, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)
        return inv[:len(a)], inv[len(a):]
    return _sort_key(a), _sort_key(b)


def _order_violation(cols: List[np.ndarray], order) -> Optional[int]:
    """First row at which the rows break ORDER BY, else None."""
    n = len(cols[0]) if cols else 0
    if n < 2 or not order:
        return None
    undecided = np.ones(n - 1, dtype=bool)
    for idx, descending in order:
        v = cols[idx]
        if v.dtype == object:
            v = _sort_key(v)
        a, b = v[:-1], v[1:]
        bad = (a < b) if descending else (a > b)
        hit = np.flatnonzero(undecided & bad)
        if len(hit):
            return int(hit[0]) + 1
        undecided &= a == b
    return None


def judge(table, answer: Answer) -> Verdict:
    """The program's host table against the reference's answer."""
    refs = answer.columns
    names = [f.name for f in table.schema.fields]
    if len(names) != len(refs):
        return Verdict(f"{len(names)} columns, reference {len(refs)}", 0.0)
    n_ref = len(refs[0].values) if refs else 0
    if table.num_rows != n_ref:
        return Verdict(f"{table.num_rows} rows, reference {n_ref}", 0.0)
    ours, theirs = [], []
    for name, col, ref in zip(names, table.columns, refs):
        if name != ref.name:
            return Verdict(f"column {name!r}, reference {ref.name!r}", 0.0)
        v, err = _program_column(col, name, ref)
        if err:
            return Verdict(err, 0.0)
        ours.append(v)
        theirs.append(_ref_values(ref))
    at = _order_violation(ours, answer.order)
    if at is not None:
        return Verdict(f"row {at} breaks the ORDER BY", 0.0)
    exact = [i for i, r in enumerate(refs) if r.kind != "float" or r.exact]
    ka, kb = [], []
    for i in exact:
        a, b = _joint_sort_keys(ours[i], theirs[i])
        ka.append(a)
        kb.append(b)
    pa, pb = _row_order(ka, n_ref), _row_order(kb, n_ref)
    for i, a, b in zip(exact, ka, kb):
        if not np.array_equal(a[pa], b[pb]):
            row = int(np.flatnonzero(a[pa] != b[pb])[0])
            return Verdict(f"column {refs[i].name!r} differs at sorted row {row}: "
                           f"{ours[i][pa][row]!r} vs {theirs[i][pb][row]!r}", 0.0)
    gap = 0.0
    for i, r in enumerate(refs):
        if r.kind != "float" or r.exact:
            continue
        a, b = ours[i][pa], theirs[i][pb]
        na, nb = np.isnan(a), np.isnan(b)
        if not np.array_equal(na, nb):
            row = int(np.flatnonzero(na != nb)[0])
            return Verdict(f"column {r.name!r}: NULL differs at sorted row {row}: "
                           f"{a[row]!r} vs {b[row]!r}", 0.0)
        live = ~nb
        if not live.any():
            continue
        mag = np.abs(b[live])
        scale = np.maximum(mag, np.median(mag))
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.abs(a[live] - b[live]) / scale
        rel = np.where(scale == 0, np.where(a[live] == b[live], 0.0, np.inf), rel)
        gap = max(gap, float(rel.max()))
    return Verdict(None, gap)


class _Dtype(NamedTuple):
    is_decimal: bool
    scale: int


class _Column(NamedTuple):
    dtype: object
    data: np.ndarray
    validity: Optional[np.ndarray]
    dictionary: object


class _Field(NamedTuple):
    name: str


class _Dictionary(NamedTuple):
    values: np.ndarray


class _Schema(NamedTuple):
    fields: list


class AnswerTable(NamedTuple):
    """An Answer in the shape of the program's host table, so that `judge`
    can hold one reference's answer against another's (the control)."""

    schema: _Schema
    columns: list
    num_rows: int


def as_table(answer: Answer) -> AnswerTable:
    cols = []
    for r in answer.columns:
        v = np.asarray(r.values)
        if r.kind == "string":
            if r.dictionary is not None:
                cols.append(_Column(_Dtype(False, 0), v, None, _Dictionary(np.asarray(r.dictionary))))
            else:
                d, codes = np.unique(v.astype(str), return_inverse=True)
                cols.append(_Column(_Dtype(False, 0), codes.reshape(-1), None,
                                    _Dictionary(d.astype(object))))
        elif r.kind == "float":
            cols.append(_Column(_Dtype(False, 0), v.astype(np.float64), ~np.isnan(v), None))
        else:
            valid = v != NULL_INT
            cols.append(_Column(_Dtype(r.kind == "decimal", r.scale), v, valid, None))
    n = len(answer.columns[0].values) if answer.columns else 0
    return AnswerTable(_Schema([_Field(r.name) for r in answer.columns]), cols, n)
