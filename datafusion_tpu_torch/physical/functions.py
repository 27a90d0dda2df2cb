"""Scalar functions: typing and device evaluation.

Port of the TPC-H, TPC-DS and h2o.ai subset of
datafusion_tpu/physical/functions.py: `power` / `pow` (h2o q9's
`power(corr(v1, v2), 2)`), the date parts `date_part` / `extract` / `year` /
`month` / `day` of a DATE (TPC-H Q7-Q9), the numeric unary functions (`abs`,
`round` with one or two arguments, `ceil`, `floor`, `sqrt`, ...),
`coalesce`, `nullif`, and the string functions `substr` / `substring`,
`concat` (and `||`), `upper`, `lower` and the trims on dictionary strings,
plus LIKE (`eval_like`). Every other scalar function raises
NotImplementedError naming its ROADMAP item, at typing (planning) time.

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
from ..common.errors import NotImplementedYet, PlanError
from ..common.schema import Schema
from ..data.column import Dictionary
from ..data.device import DeviceColumn, torch_dtype
from ..expr import nodes as E
from ..utils import dates as DU
from .expr_compiler import (_combine_validity, _not_ported, _to_float,
                            dictionary_text, dictionary_work,
                            unify_many_string_columns, unify_string_columns)

_DATE_PARTS = frozenset({"date_part", "extract", "year", "month", "day"})
_NUMERIC_UNARY = frozenset({
    "abs", "ceil", "floor", "round", "trunc", "sqrt", "cbrt", "exp", "ln",
    "log10", "log2", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "degrees", "radians", "signum", "sign",
})
_STRING_UNARY = frozenset({"upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                           "initcap", "btrim"})
_PORTED = (frozenset({"power", "pow", "substr", "substring", "concat", "coalesce",
                      "nullif"})
           | _DATE_PARTS | _NUMERIC_UNARY | _STRING_UNARY)
# the dictionary product a concat may build (the reference's cap)
_CONCAT_CAP = 1 << 18


def builtin_function_names() -> set:
    """Every scalar-function name the port evaluates."""
    return set(_PORTED)


def scalar_function_type(e: E.ScalarFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    f = e.fname
    if f not in _PORTED:
        raise _not_ported(f"scalar function {f!r}")
    argt = [infer(a, schema) for a in e.args]
    nullable = any(n for _, n in argt)
    if f in _DATE_PARTS:
        return T.INT64, nullable
    if f in _NUMERIC_UNARY:
        # arity and input type are checked at planning time
        maxa = 2 if f in ("round", "trunc") else 1
        if not (1 <= len(argt) <= maxa):
            raise PlanError(f"{f} expects {'1-2' if maxa == 2 else '1'} "
                            f"argument(s), got {len(argt)}")
        t = argt[0][0]
        if not (t.is_numeric or t.kind is T.TypeKind.NULL):
            raise PlanError(f"{f} expects a numeric argument, got {t!r}")
        if f == "abs":
            return t, nullable
        if f in ("ceil", "floor", "round", "trunc", "sign", "signum"):
            return (t if t.is_integer or t.is_decimal else T.FLOAT64), nullable
        return T.FLOAT64, nullable
    if f in ("substr", "substring", "concat") or f in _STRING_UNARY:
        if f == "concat" and any(t.is_binary for t, _ in argt):
            return T.BINARY, nullable  # one binary operand makes concat binary
        return T.STRING, nullable
    if f == "coalesce":
        base = argt[0][0]
        for t, _ in argt[1:]:
            if base.is_numeric and t.is_numeric and t != base:
                base = T.common_numeric_type(base, t)
            elif base.kind is T.TypeKind.NULL:
                base = t
        return base, all(n for _, n in argt)
    if f == "nullif":
        return argt[0][0], True
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
    return DeviceColumn(work.lookup(1, col.data), col.validity, T.STRING,
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
    return work.lookup(0, col.data)


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


def _coerce_to(col: DeviceColumn, dtype: T.DataType) -> torch.Tensor:
    """col's values in dtype's device representation (decimals rescaled)."""
    if col.dtype == dtype:
        return col.data
    if dtype.is_float:
        return _to_float(col).to(torch_dtype(dtype))
    if dtype.is_decimal:
        if col.dtype.is_decimal:
            ds = dtype.scale - col.dtype.scale
            return col.data * (10 ** ds) if ds >= 0 else col.data // (10 ** -ds)
        return col.data.to(torch.int64) * (10 ** dtype.scale)
    return col.data.to(torch_dtype(dtype))


_FLOAT_UNARY = {
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log, "log10": torch.log10,
    "log2": torch.log2, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    # half to even, as jnp.round
    "round": torch.round,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
}

_STRING_IMPL = {
    "upper": np.char.upper, "lower": np.char.lower,
    "trim": np.char.strip, "btrim": np.char.strip,
    "ltrim": np.char.lstrip, "rtrim": np.char.rstrip,
    "initcap": np.char.title,
    "reverse": lambda v: np.array([s[::-1] for s in v], dtype="U"),
}


def _round_digits(a: DeviceColumn, nd: int, validity) -> DeviceColumn:
    """round(a, nd): decimals and integers exactly in scaled-integer
    arithmetic, half away from zero; floats through float64, half to even."""
    if a.dtype.is_decimal or a.dtype.is_integer:
        s = a.dtype.scale if a.dtype.is_decimal else 0
        if nd >= s:
            return DeviceColumn(a.data, validity, a.dtype)
        q = 10 ** (s - nd)
        d = a.data.to(torch.int64)
        out = torch.sign(d) * ((torch.abs(d) + q // 2) // q) * q
        return DeviceColumn(out.to(a.data.dtype), validity, a.dtype)
    scale = 10.0 ** nd
    return DeviceColumn(torch.round(_to_float(a) * scale) / scale, validity, T.FLOAT64)


def _numeric_unary(f: str, a: DeviceColumn, validity) -> DeviceColumn:
    if f == "abs":
        return DeviceColumn(torch.abs(a.data), validity, a.dtype)
    if f in ("sign", "signum"):
        return DeviceColumn(torch.sign(a.data), validity, a.dtype)
    impl = _FLOAT_UNARY[f]
    if f in ("ceil", "floor", "round", "trunc") and (a.dtype.is_integer
                                                    or a.dtype.is_decimal):
        if a.dtype.is_decimal:
            s = 10 ** a.dtype.scale
            out = impl(_to_float(a))
            return DeviceColumn(torch.round(out * s).to(torch.int64), validity, a.dtype)
        return DeviceColumn(a.data, validity, a.dtype)
    return DeviceColumn(impl(_to_float(a)), validity, T.FLOAT64)


def _coalesce(args: List[DeviceColumn], out_dtype: T.DataType) -> DeviceColumn:
    """The first non-NULL argument, left to right."""
    dictionary = None
    if out_dtype.is_string:
        args = unify_many_string_columns(list(args))
        dictionary = args[0].dictionary
    data, valid = args[-1].data, args[-1].valid()
    for c in reversed(args[:-1]):
        cd = c.data if dictionary is not None else _coerce_to(c, out_dtype)
        data = torch.where(c.valid(), cd, data)
        valid = c.valid() | valid
    all_valid = all(a.validity is None for a in args)
    return DeviceColumn(data, None if all_valid else valid, out_dtype, dictionary)


def _nullif(a: DeviceColumn, b: DeviceColumn) -> DeviceColumn:
    """NULL where a equals b, else a."""
    if a.dtype.is_string:
        ua, ub = unify_string_columns(a, b)
        eq = ua.data == ub.data
    else:
        eq = a.data == _coerce_to(b, a.dtype)
    valid = a.valid() & ~(eq & a.valid() & b.valid())
    return DeviceColumn(a.data, valid, a.dtype, a.dictionary)


def _concat(args: List[DeviceColumn], arg_exprs: Sequence[E.Expr],
            capacity: int, validity) -> DeviceColumn:
    """concat / ||: literals fold into the values on the host; each string
    column multiplies the composite dictionary (code = base * |d| + code).
    The product is capped at _CONCAT_CAP: concat of two high-cardinality
    columns would need a row-wise string kernel. The composite dictionary
    and its sorted re-encoding are made once per (dictionaries, literals)."""
    binmode = any(a.dtype is not None and a.dtype.is_binary for a in args)
    parts, dicts, cols = [], [], []
    for a, ae in zip(args, arg_exprs):
        if a.dtype.is_string and a.dictionary is not None and len(a.dictionary.values):
            parts.append(("col", len(dicts)))
            dicts.append(a.dictionary)
            cols.append(a)
            continue
        node = ae.expr if isinstance(ae, E.Alias) else ae
        lit = _literal_value(ae) if isinstance(node, E.Literal) else None
        if lit is None and a.dtype.is_string:
            continue  # an empty-dictionary column contributes nothing
        if lit is None:
            raise NotImplementedYet("concat of non-string non-literal argument")
        parts.append(("lit", lit if isinstance(lit, bytes) else str(lit)))

    def as_bytes(v):
        return v if isinstance(v, bytes) else str(v).encode("utf-8")

    def compute():
        if binmode:
            vals = [b""]
        else:
            vals = np.array([""], dtype="U1")
        for kind, v in parts:
            if kind == "lit":
                vals = ([x + as_bytes(v) for x in vals] if binmode
                        else np.char.add(vals, np.array([v], "U")))
                continue
            dv = dicts[v].values
            if len(vals) * len(dv) > _CONCAT_CAP:
                raise NotImplementedYet(
                    f"concat dictionary product {len(vals)}x{len(dv)} "
                    f"exceeds {_CONCAT_CAP}")
            if binmode:
                dvl = [as_bytes(x) for x in dv]
                vals = [x + y for x in vals for y in dvl]
            else:
                dvu = np.asarray(dv, dtype="U")
                vals = np.char.add(np.repeat(vals, len(dvu)), np.tile(dvu, len(vals)))
        # restore the sorted-unique dictionary invariant
        if binmode:
            uniq = sorted(set(vals))
            lut = {v: i for i, v in enumerate(uniq)}
            inv = np.array([lut[v] for v in vals], dtype=np.int32)
            return Dictionary(np.array(uniq, dtype=object)), inv
        uniq, inv = np.unique(vals, return_inverse=True)
        return Dictionary(uniq.astype(object)), inv.astype(np.int32)

    work = dictionary_work(tuple(dicts), "concat", (binmode, tuple(parts)), compute)
    codes = None
    for a, d in zip(cols, dicts):
        cc = torch.clamp(a.data, 0, len(d.values) - 1)
        codes = cc if codes is None else codes * len(d.values) + cc
    if codes is None:
        codes = torch.zeros(capacity, dtype=torch.int32,
                            device=args[0].data.device if args else None)
    return DeviceColumn(work.lookup(1, codes).to(torch.int32), validity,
                        T.BINARY if binmode else T.STRING, work.value[0])


def eval_scalar_function(fname: str, args: List[DeviceColumn],
                         arg_exprs: Sequence[E.Expr], out_dtype: T.DataType,
                         capacity: int) -> DeviceColumn:
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
    if fname == "round" and len(args) == 2:
        return _round_digits(args[0], int(_literal_value(arg_exprs[1])), validity)
    if fname in _NUMERIC_UNARY:
        return _numeric_unary(fname, args[0], validity)
    if fname in _STRING_UNARY:
        return transform_dictionary(args[0], fname, (), _STRING_IMPL[fname])
    if fname in ("substr", "substring"):
        start = int(_literal_value(arg_exprs[1]))
        length = int(_literal_value(arg_exprs[2])) if len(arg_exprs) > 2 else None
        i0 = max(start - 1, 0)
        i1 = None if length is None else i0 + max(length, 0)
        return transform_dictionary(
            args[0], "substring", (i0, i1),
            lambda vals: np.array([v[i0:i1] for v in vals], dtype="U"))
    if fname == "concat":
        return _concat(args, arg_exprs, capacity, validity)
    if fname == "coalesce":
        return _coalesce(args, out_dtype)
    if fname == "nullif":
        return _nullif(args[0], args[1])
    raise _not_ported(f"scalar function {fname!r}")
