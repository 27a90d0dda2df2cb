"""Scalar functions: typing and device evaluation.

Port of datafusion_tpu/physical/functions.py: every scalar function of the
reference. The nested family (list, struct and map functions) is typed and
evaluated by physical/nested.py, and in a session that enabled the Spark
library (`enable_spark_functions`) its names are typed and evaluated by
spark/functions.py.

Dispatch is a name table (_IMPLS): each name maps to one small function per
family (date parts, date_trunc, the clock, numeric unary, string transforms,
dictionary lookups, conditionals, ...). Typing (scalar_function_type) is the
reference's, name for name; a name whose evaluation the reference does not
have (`random`, `levenshtein`, `bit_length`, one-argument `log`) types as
there and raises the reference's PlanError when evaluated.

String work runs on the host over a column's dictionary (its distinct
values) and reaches the rows as one gather of a small lookup table on the
column's device. Both are made once per dictionary and cached
(expr_compiler.dictionary_work): O(distinct) host work and one
host-to-device copy per dictionary, O(rows) device work per call. Every
per-row step is a torch op on the column's device; dates, times and
timestamps are integer arithmetic with floor division (before 1970 too).
"""
from __future__ import annotations

import datetime as _dt
import hashlib
import math
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
from . import nested as N
from .expr_compiler import (EMPTY_DICTIONARY, _combine_validity, _literal_column,
                            _to_float, cast_column, dictionary_text,
                            dictionary_work, literal_dictionary, steady_value,
                            unify_many_string_columns, unify_string_columns)

_NUMERIC_UNARY = frozenset({
    "abs", "ceil", "floor", "round", "trunc", "sqrt", "cbrt", "exp", "ln",
    "log10", "log2", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "degrees", "radians", "signum", "sign",
})
_STRING_UNARY = frozenset({"upper", "lower", "trim", "ltrim", "rtrim", "reverse",
                           "initcap", "btrim"})
# the rest of the reference's names (its builtin_function_names less the
# nested family)
_OTHER_NAMES = frozenset({
    "date_part", "extract", "year", "month", "day", "date_trunc",
    "power", "pow", "atan2", "log", "pi", "substr", "substring", "left",
    "right", "concat", "concat_ws", "replace", "translate", "lpad",
    "rpad", "repeat", "length", "char_length", "character_length",
    "octet_length", "bit_length", "strpos", "position", "ascii",
    "levenshtein", "starts_with", "ends_with", "contains", "coalesce",
    "nullif", "isnan", "iszero", "nvl", "ifnull", "md5", "sha224",
    "sha256", "sha384", "sha512", "regexp_replace", "regexp_like",
    "regexp_match", "to_date", "now", "current_timestamp",
    "current_date", "today", "random", "split_part", "overlay", "chr",
    "char", "to_hex", "uuid", "encode", "decode", "find_in_set",
    "factorial", "gcd", "lcm", "to_unixtime", "cot", "nanvl",
    "make_date", "to_timestamp", "from_unixtime", "date_bin", "greatest",
    "least", "arrow_typeof", "arrow_cast", "version", "to_char",
    "to_local_time", "substr_index", "substring_index", "regexp_count",
    "regexp_instr", "to_time", "make_time", "current_time",
    "to_timestamp_seconds", "to_timestamp_millis", "to_timestamp_micros",
    "to_timestamp_nanos", "nvl2", "date_format",
})
# the dictionary product a concat / concat_ws may build (the reference's cap)
_CONCAT_CAP = 1 << 18
_US_DAY = 86_400_000_000
_I64_MIN, _I64_MAX = -(2 ** 63), 2 ** 63 - 1


def builtin_function_names() -> set:
    """Every scalar-function name the evaluator accepts (for
    information_schema.routines)."""
    return (set(_NUMERIC_UNARY) | set(_STRING_UNARY) | set(_OTHER_NAMES)
            | set(N.NESTED_FNS))


def arrow_type_name(dt: T.DataType) -> str:
    """Arrow-style type rendering (the reference's arrow_typeof output):
    Int64 / Float64 / Utf8 / Boolean / Date32 / Decimal128(p, s) /
    Timestamp(Nanosecond, None)."""
    k = dt.kind
    if k is T.TypeKind.DECIMAL:
        return f"Decimal128({dt.precision}, {dt.scale})"
    if k is T.TypeKind.LIST:
        return f"List({arrow_type_name(dt.elem)})"
    return {
        T.TypeKind.NULL: "Null", T.TypeKind.BOOL: "Boolean",
        T.TypeKind.INT8: "Int8", T.TypeKind.INT16: "Int16",
        T.TypeKind.INT32: "Int32", T.TypeKind.INT64: "Int64",
        T.TypeKind.FLOAT32: "Float32", T.TypeKind.FLOAT64: "Float64",
        T.TypeKind.STRING: "Utf8", T.TypeKind.BINARY: "Binary",
        T.TypeKind.DATE32: "Date32",
        T.TypeKind.TIMESTAMP: "Timestamp(Nanosecond, None)",
        T.TypeKind.INTERVAL_DAYS: "Interval(DayTime)",
        T.TypeKind.INTERVAL_MONTHS: "Interval(YearMonth)",
    }.get(k, k.value)


def _spark_active(fname: str) -> bool:
    """True when the session opted into Spark-semantics functions
    (ctx.enable_spark_functions(); reference: datafusion-spark crate
    registration) and `fname` is one of them."""
    from ..expr.udf import active_registry

    if not getattr(active_registry(), "spark", False):
        return False
    from ..spark import SPARK_FNS

    return fname in SPARK_FNS


def scalar_function_type(e: E.ScalarFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    f = e.fname
    if f in N.NESTED_FNS:
        return N.nested_function_type(e, schema)
    if _spark_active(f):
        from ..spark import functions as SK

        return SK.spark_function_type(e, schema)
    argt = [infer(a, schema) for a in e.args]
    nullable = any(n for _, n in argt)
    if f in ("date_part", "extract", "year", "month", "day"):
        return T.INT64, nullable
    if f == "date_trunc":
        return argt[1][0], nullable
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
    if f in ("power", "pow", "atan2", "log"):
        return T.FLOAT64, nullable
    if f in ("substr", "substring", "left", "right", "concat", "concat_ws",
             "replace", "translate", "lpad", "rpad", "repeat") or f in _STRING_UNARY:
        if f == "concat" and any(t.is_binary for t, _ in argt):
            return T.BINARY, nullable  # one binary operand makes concat binary
        return T.STRING, nullable
    if f in ("length", "char_length", "character_length", "octet_length",
             "bit_length", "strpos", "position", "ascii", "levenshtein"):
        return T.INT64, nullable
    if f in ("starts_with", "ends_with", "contains"):
        return T.BOOL, nullable
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
    if f in ("isnan", "iszero"):
        return T.BOOL, False
    if f in ("nvl", "ifnull"):
        return argt[0][0], nullable
    if f in ("md5", "sha224", "sha256", "sha384", "sha512", "regexp_replace"):
        return T.STRING, nullable
    if f in ("regexp_like", "regexp_match"):
        return T.BOOL, nullable
    if f == "to_date":
        return T.DATE32, nullable
    if f in ("now", "current_timestamp"):
        return T.TIMESTAMP, False
    if f in ("current_date", "today"):
        return T.DATE32, False
    if f in ("random", "pi"):
        return T.FLOAT64, False
    if f in ("split_part", "overlay", "chr", "char", "to_hex", "uuid",
             "encode", "decode"):
        return T.STRING, nullable if f != "uuid" else False
    if f in ("find_in_set", "factorial", "gcd", "lcm", "to_unixtime"):
        return T.INT64, nullable
    if f in ("cot", "nanvl"):
        return T.FLOAT64, nullable
    if f == "make_date":
        return T.DATE32, nullable
    if f in ("to_timestamp", "from_unixtime", "date_bin",
             "to_timestamp_seconds", "to_timestamp_millis",
             "to_timestamp_micros", "to_timestamp_nanos", "at_time_zone"):
        return T.TIMESTAMP, nullable
    if f == "nvl2":
        return argt[1][0], nullable
    if f in ("greatest", "least"):
        base = argt[0][0]
        for t, _ in argt[1:]:
            if base.is_numeric and t.is_numeric and t != base:
                base = T.common_numeric_type(base, t)
        return base, all(n for _, n in argt)
    if f == "to_char":
        return T.STRING, nullable
    if f in ("to_time", "make_time"):
        return T.TIME, nullable
    if f == "current_time":
        return T.TIME, False
    if f == "to_local_time":
        return argt[0][0], nullable
    if f in ("substr_index", "substring_index"):
        return T.STRING, nullable
    if f in ("regexp_count", "regexp_instr"):
        return T.INT64, nullable
    if f in ("arrow_typeof", "version"):
        return T.STRING, False
    if f == "arrow_cast":
        return parse_arrow_type(str(_literal_value(e.args[1]))), argt[0][1]
    raise PlanError(f"unknown scalar function {f!r}")


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
    op, args). Used for LIKE, starts_with/ends_with/contains and the regex
    predicates."""
    if col.dictionary is None or not len(col.dictionary.values):
        return torch.zeros(col.data.shape[0], dtype=torch.bool, device=col.data.device)
    work = dictionary_work(
        (col.dictionary,), op, args,
        lambda: (pred_fn(dictionary_text(col.dictionary)).astype(bool),))
    return work.lookup(0, col.data)


def _dict_ints(col: DeviceColumn, op: str, args: tuple, fn) -> torch.Tensor:
    """An int64 table over the dictionary's values (fn of the values, over
    [""] when the dictionary is empty), gathered per row."""
    d = col.dictionary or EMPTY_DICTIONARY

    def compute():
        vals = dictionary_text(d) if len(d.values) else np.array([""], "U1")
        return (np.asarray(fn(vals), dtype=np.int64),)

    return dictionary_work((d,), op, args, compute).lookup(0, col.data)


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
# implementations, one function per family; each takes
# (f, args, arg_exprs, out_dtype, capacity, validity, device)
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


def _full(capacity: int, value, dtype, device):
    return torch.full((capacity,), value, dtype=dtype, device=device)


def _date_part(f, args, ex, out_dtype, capacity, validity, device):
    """year / month / day / quarter / dow / doy of a DATE (or of a
    TIMESTAMP's day), hour / minute / second of a TIMESTAMP, and the parts
    of a TIME, as int64 by floor division (so instants before 1970 come out
    right). The bounds of year follow from a DATE column's day bounds (year
    is monotone in days), which lets GROUP BY and joins on it prove small
    dense domains."""
    if f in ("date_part", "extract"):
        if not isinstance(ex[0], E.Literal):
            raise PlanError("extract part must be a literal")
        part, datecol = str(ex[0].value).lower(), args[1]
    else:
        part, datecol = f, args[0]
    kind = datecol.dtype.kind
    if kind is T.TypeKind.TIME:
        us = datecol.data
        secs = us // 1_000_000
        parts = {"hour": lambda: (secs // 3600) % 24,
                 "minute": lambda: (secs // 60) % 60,
                 "second": lambda: secs % 60,
                 "microsecond": lambda: us % 60_000_000,
                 "millisecond": lambda: (us % 60_000_000) // 1000}
        if part not in parts:
            raise PlanError(f"unsupported TIME part {part!r}")
        return DeviceColumn(parts[part]().to(torch.int64), validity, T.INT64)
    days = datecol.data
    if kind is T.TypeKind.TIMESTAMP:
        us = days
        if part in ("hour", "minute", "second"):
            secs = us // 1_000_000
            val = {"hour": lambda: (secs // 3600) % 24,
                   "minute": lambda: (secs // 60) % 60,
                   "second": lambda: secs % 60}[part]()
            return DeviceColumn(val.to(torch.int64), validity, T.INT64)
        days = (us // _US_DAY).to(torch.int32)
    y, m, d = DU.civil_from_days(days)
    val = {"year": y, "month": m, "day": d}.get(part)
    bounds = None
    if val is not None and datecol.bounds is not None \
            and kind is not T.TypeKind.TIMESTAMP:
        bounds = {"year": (_year_of(datecol.bounds[0]), _year_of(datecol.bounds[1])),
                  "month": (1, 12), "day": (1, 31)}[part]
    elif part == "quarter":
        bounds = (1, 4)
    elif part in ("dow", "dayofweek"):
        bounds = (0, 6)
    elif part in ("doy", "dayofyear"):
        bounds = (1, 366)
    if val is None:
        if part == "quarter":
            val = (m - 1) // 3 + 1
        elif part in ("dow", "dayofweek"):
            val = (days.to(torch.int64) + 4) % 7
        elif part in ("doy", "dayofyear"):
            val = days - DU.days_from_civil(y, torch.ones_like(m), torch.ones_like(d)) + 1
        else:
            raise PlanError(f"unsupported date part {part!r}")
    return DeviceColumn(val.to(torch.int64), validity, T.INT64, bounds=bounds)


_TRUNC_US = {"microsecond": 1, "microseconds": 1,
             "millisecond": 1_000, "milliseconds": 1_000,
             "second": 1_000_000, "seconds": 1_000_000,
             "minute": 60_000_000, "minutes": 60_000_000,
             "hour": 3_600_000_000, "hours": 3_600_000_000,
             "day": _US_DAY, "days": _US_DAY}


def _date_trunc(f, args, ex, out_dtype, capacity, validity, device):
    """date_trunc(unit, x): a TIMESTAMP floors to a fixed unit in
    microseconds, or to week / month / quarter / year through its day; a
    DATE floors through the civil calendar."""
    unit = str(_literal_value(ex[0])).lower()
    datecol = args[1]
    if datecol.dtype.kind is T.TypeKind.TIME:
        raise PlanError("date_trunc does not support TIME input "
                        "(reference: datetime/date_trunc.rs signatures)")
    if datecol.dtype.kind is T.TypeKind.TIMESTAMP:
        us = datecol.data
        if unit in _TRUNC_US:
            q = _TRUNC_US[unit]
            return DeviceColumn((us // q) * q, validity, T.TIMESTAMP)
        days32 = (us // _US_DAY).to(torch.int32)
        trunc = _date_trunc(f, [args[0], DeviceColumn(days32, validity, T.DATE32)],
                            ex, T.DATE32, capacity, validity, device)
        return DeviceColumn(trunc.data.to(torch.int64) * _US_DAY, validity, T.TIMESTAMP)
    days = datecol.data
    y, m, _ = DU.civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "year":
        out = DU.days_from_civil(y, one, one)
    elif unit == "quarter":
        out = DU.days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    elif unit == "month":
        out = DU.days_from_civil(y, m, one)
    elif unit == "week":
        out = days - ((days.to(torch.int64) + 3) % 7).to(days.dtype)
    elif unit in ("day", "hour", "minute", "second", "millisecond", "microsecond"):
        out = days  # sub-day truncation of a DATE32 is the identity
    else:
        raise PlanError(f"unsupported date_trunc unit {unit!r}")
    return DeviceColumn(out, validity, T.DATE32)


def _date_bin(f, args, ex, out_dtype, capacity, validity, device):
    """date_bin(stride, ts[, origin]): floor to stride boundaries."""
    stride_col = args[0]
    if stride_col.dtype.kind is T.TypeKind.INTERVAL_DAYS:
        stride_us = int(_literal_value(ex[0])) * _US_DAY
    elif stride_col.dtype.kind is T.TypeKind.INTERVAL_MONTHS:
        raise PlanError("date_bin with month strides is not supported")
    else:
        stride_us = int(_literal_value(ex[0]))
    if stride_us <= 0:
        raise PlanError("date_bin stride must be positive "
                        "(reference: datetime/date_bin.rs)")
    if any(c.dtype.kind is T.TypeKind.TIME for c in args[1:]):
        raise PlanError("date_bin expects date/timestamp inputs, not TIME")
    a = args[1]
    x = a.data.to(torch.int64)
    if a.dtype.kind is T.TypeKind.DATE32:
        x = x * _US_DAY
    origin = 0
    if len(args) > 2:
        ov = _literal_value(ex[2])
        if args[2].dtype.kind is T.TypeKind.DATE32 or a.dtype.kind is T.TypeKind.DATE32:
            origin = (DU.date_str_to_days(str(ov)) * _US_DAY
                      if isinstance(ov, str) else int(ov))
        else:
            origin = (int(np.datetime64(str(ov), "us").astype(np.int64))
                      if isinstance(ov, str) else int(ov))
    out = ((x - origin) // stride_us) * stride_us + origin
    return DeviceColumn(out, validity, T.TIMESTAMP)


def _now():
    """The clock: a new reading outside a steady state; inside one, the
    reading its first run took, which a CUDA graph captures (DataFusion reads
    now() once per statement)."""
    return steady_value("now", lambda: _dt.datetime.now(_dt.timezone.utc))


def _clock(f, args, ex, out_dtype, capacity, validity, device):
    """now / current_timestamp / current_date / today / current_time."""
    now = _now()
    dev = device
    if f in ("now", "current_timestamp"):
        return DeviceColumn(_full(capacity, int(now.timestamp() * 1e6), torch.int64,
                                  device=dev), None, T.TIMESTAMP)
    if f in ("current_date", "today"):
        days = (now.date() - _dt.date(1970, 1, 1)).days
        return DeviceColumn(_full(capacity, days, torch.int32, device=dev), None,
                            T.DATE32)
    t = now.time()
    us = ((t.hour * 60 + t.minute) * 60 + t.second) * 1_000_000 + t.microsecond
    return DeviceColumn(_full(capacity, us, torch.int64, device=dev), None, T.TIME)


def _time_conv(f, args, ex, out_dtype, capacity, validity, device):
    """to_time, make_time, make_date, to_local_time, at_time_zone,
    from_unixtime, to_unixtime."""
    a = args[0]
    if f == "to_local_time":
        # timestamps are naive UTC: identity
        return DeviceColumn(a.data, validity, a.dtype)
    if f == "at_time_zone":
        tz = str(_literal_value(ex[1])).lower()
        if tz not in ("utc", "+00:00", "+00", "etc/utc", "z", "00:00"):
            raise PlanError(f"AT TIME ZONE {tz!r}: only UTC-equivalent "
                            "zones are supported (naive-UTC engine)")
        if a.dtype.kind is T.TypeKind.TIMESTAMP:
            return a
        return cast_column(a, T.TIMESTAMP, capacity)
    if f == "to_time":
        if a.dtype.kind is T.TypeKind.TIME:
            return a
        if a.dtype.kind is T.TypeKind.TIMESTAMP:
            return DeviceColumn(((a.data % _US_DAY) + _US_DAY) % _US_DAY, validity, T.TIME)
        return cast_column(a, T.TIME, capacity)
    if f == "make_time":
        # the arguments are read as literals and checked at once, as in the
        # reference (a column argument raises its PlanError)
        try:
            lh, lm, ls = (_literal_value(x) for x in ex)
            if not (0 <= int(lh) <= 23 and 0 <= int(lm) <= 59 and 0 <= float(ls) < 60):
                raise PlanError(f"make_time: out of range ({lh}, {lm}, {ls})")
        except PlanError:
            raise
        except Exception:  # noqa: BLE001 -- non-literal args: no static check
            pass
        h = args[0].data.to(torch.int64)
        m = args[1].data.to(torch.int64)
        us = (h * 60 + m) * 60 * 1_000_000 + torch.round(_to_float(args[2]) * 1e6).to(torch.int64)
        return DeviceColumn(us, validity, T.TIME)
    if f == "make_date":
        y, m, d = (c.data.to(torch.int64) for c in args[:3])
        return DeviceColumn(DU.days_from_civil(y, m, d).to(torch.int32), validity, T.DATE32)
    if f == "from_unixtime":
        return DeviceColumn(a.data.to(torch.int64) * 1_000_000, validity, T.TIMESTAMP)
    # to_unixtime
    if a.dtype.kind is T.TypeKind.TIMESTAMP:
        return DeviceColumn(a.data // 1_000_000, validity, T.INT64)
    if a.dtype.kind is T.TypeKind.DATE32:
        return DeviceColumn(a.data.to(torch.int64) * 86_400, validity, T.INT64)
    ts = cast_column(a, T.TIMESTAMP, capacity)
    return DeviceColumn(ts.data // 1_000_000, validity, T.INT64)


# to_timestamp family: (microseconds per input unit, truncation in us)
_TO_TS = {"to_timestamp": (1_000_000, 1), "to_timestamp_seconds": (1_000_000, 1_000_000),
          "to_timestamp_millis": (1_000, 1_000), "to_timestamp_micros": (1, 1),
          "to_timestamp_nanos": (1, 1)}
_TO_TS_FLOAT = {"to_timestamp": 1e6, "to_timestamp_seconds": 1e6,
                "to_timestamp_millis": 1e3, "to_timestamp_micros": 1.0,
                "to_timestamp_nanos": 1e-3}


def _to_timestamp(f, args, ex, out_dtype, capacity, validity, device):
    """to_timestamp[_seconds|_millis|_micros|_nanos]: strings parse once per
    dictionary value; numbers are read in the named unit; storage is
    microseconds, floored to the unit's precision."""
    unit_us, trunc_us = _TO_TS[f]
    a = args[0]

    def floor(x):
        return (x // trunc_us) * trunc_us if trunc_us > 1 else x

    if a.dtype.is_string:
        d = a.dictionary or EMPTY_DICTIONARY

        def compute():
            vals = dictionary_text(d)
            return ((vals.astype("datetime64[us]").astype(np.int64) if len(vals)
                     else np.zeros(1, np.int64)),)

        out = dictionary_work((d,), "to_timestamp", (), compute).lookup(0, a.data)
        return DeviceColumn(floor(out), validity, T.TIMESTAMP)
    if a.dtype.kind is T.TypeKind.TIMESTAMP:
        return DeviceColumn(floor(a.data), validity, T.TIMESTAMP) if trunc_us > 1 else a
    if a.dtype.kind is T.TypeKind.DATE32:
        return DeviceColumn(a.data.to(torch.int64) * _US_DAY, validity, T.TIMESTAMP)
    if a.dtype.is_integer and f != "to_timestamp":
        if f == "to_timestamp_nanos":
            return DeviceColumn(a.data.to(torch.int64) // 1_000, validity, T.TIMESTAMP)
        return DeviceColumn(a.data.to(torch.int64) * unit_us, validity, T.TIMESTAMP)
    us = (_to_float(a) * _TO_TS_FLOAT[f]).to(torch.int64)
    return DeviceColumn(floor(us), validity, T.TIMESTAMP)


def _to_date(f, args, ex, out_dtype, capacity, validity, device):
    """to_date(string): each dictionary value parsed once."""
    a = args[0]
    d = a.dictionary or EMPTY_DICTIONARY

    def compute():
        vals = dictionary_text(d)
        return ((vals.astype("datetime64[D]").astype(np.int32) if len(vals)
                 else np.zeros(1, np.int32)),)

    out = dictionary_work((d,), "to_date", (), compute).lookup(0, a.data)
    return DeviceColumn(out, validity, T.DATE32)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root: a power of |x| with x's sign (torch has no cbrt, and
    a negative base to a fractional power is NaN)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign keeping NaN and -0.0 as the reference's does (torch.sign gives 0
    for NaN)."""
    if not x.dtype.is_floating_point:
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


_FLOAT_UNARY = {
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "sqrt": torch.sqrt, "exp": torch.exp, "ln": torch.log, "log10": torch.log10,
    "log2": torch.log2, "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    # half to even, as jnp.round
    "round": torch.round, "cbrt": _cbrt,
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


def _numeric_unary(f, args, ex, out_dtype, capacity, validity, device):
    a = args[0]
    if f == "round" and len(args) == 2:
        return _round_digits(a, int(_literal_value(ex[1])), validity)
    if f == "abs":
        return DeviceColumn(torch.abs(a.data), validity, a.dtype)
    if f in ("sign", "signum"):
        return DeviceColumn(_sign(a.data), validity, a.dtype)
    impl = _FLOAT_UNARY[f]
    if f in ("ceil", "floor", "round", "trunc") and (a.dtype.is_integer
                                                    or a.dtype.is_decimal):
        if a.dtype.is_decimal:
            s = 10 ** a.dtype.scale
            out = impl(_to_float(a))
            return DeviceColumn(torch.round(out * s).to(torch.int64), validity, a.dtype)
        return DeviceColumn(a.data, validity, a.dtype)
    return DeviceColumn(impl(_to_float(a)), validity, T.FLOAT64)


def _numeric_binary(f, args, ex, out_dtype, capacity, validity, device):
    """power / pow, atan2, log(base, x), cot, nanvl, pi."""
    if f == "pi":
        return DeviceColumn(_full(capacity, math.pi, torch.float64,
                                  device=device), None, T.FLOAT64)
    x = _to_float(args[0])
    if f == "cot":
        return DeviceColumn(1.0 / torch.tan(x), validity, T.FLOAT64)
    if f == "log" and len(args) != 2:
        raise PlanError(f"scalar function {f!r} not implemented")
    y = _to_float(args[1])
    out = {"power": lambda: torch.pow(x, y), "pow": lambda: torch.pow(x, y),
           "atan2": lambda: torch.atan2(x, y),
           "log": lambda: torch.log(y) / torch.log(x),
           "nanvl": lambda: torch.where(torch.isnan(x), y, x)}[f]()
    return DeviceColumn(out, validity, T.FLOAT64)


def _float_tests(f, args, ex, out_dtype, capacity, validity, device):
    """isnan, iszero."""
    a = args[0]
    if f == "isnan":
        out = (torch.isnan(a.data) if a.dtype.is_float
               else torch.zeros(a.data.shape[0], dtype=torch.bool, device=a.data.device))
    elif a.dtype.is_float:
        out = a.data == 0.0
    else:
        out = a.data.to(torch.int64) == 0
    return DeviceColumn(out, validity, T.BOOL)


def _factorial(f, args, ex, out_dtype, capacity, validity, device):
    """factorial(n) from a 21-entry table (n clamped into [0, 20]), made
    once per device."""
    def compute():
        facts = np.ones(21, dtype=np.int64)
        for i in range(2, 21):
            facts[i] = facts[i - 1] * i
        return (facts,)

    work = dictionary_work((), "factorial", (), compute)
    return DeviceColumn(work.lookup(0, args[0].data.to(torch.int64)), validity, T.INT64)


def _gcd_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """gcd of |a| and |b| read as uint64, in int64 bits (the reference
    computes in uint64). abs wraps INT64_MIN to itself, 2^63 as uint64:
    gcd(2^63, m) = gcd(2^63 mod m, m), and 2^63 mod m is
    (INT64_MAX mod m + 1) mod m; gcd(2^63, 0) = gcd(2^63, 2^63) = 2^63."""
    au, bu = torch.abs(a), torch.abs(b)
    a_big, b_big = au == _I64_MIN, bu == _I64_MIN

    def mod_2_63(m):  # for m > 0; 0 elsewhere
        safe = torch.where(m > 0, m, torch.ones_like(m))
        return torch.where(m > 0, (_I64_MAX % safe + 1) % safe, torch.zeros_like(m))

    x = torch.where(a_big, mod_2_63(bu), au)
    y = torch.where(b_big, mod_2_63(au), bu)
    g = torch.gcd(x, y)
    special = (a_big & (b_big | (bu == 0))) | (b_big & (au == 0))
    return torch.where(special, torch.full_like(g, _I64_MIN), g)


def _gcd_lcm(f, args, ex, out_dtype, capacity, validity, device):
    """gcd / lcm in uint64 arithmetic, as the reference computes them:
    lcm = |a| // gcd * |b| wrapping mod 2^64, 0 when gcd is 0."""
    a = args[0].data.to(torch.int64)
    b = args[1].data.to(torch.int64)
    g = _gcd_u64(a, b)
    if f == "gcd":
        return DeviceColumn(g, validity, T.INT64)
    au, bu = torch.abs(a), torch.abs(b)
    # |a| // g in uint64: g divides |a|; for |a| = 2^63, g is a power of two
    safe_g = torch.where(g > 0, g, torch.ones_like(g))
    q = torch.where(au == _I64_MIN, _I64_MAX // safe_g + 1, au // safe_g)
    q = torch.where(g == _I64_MIN, (au == _I64_MIN).to(torch.int64), q)
    return DeviceColumn(torch.where(g == 0, torch.zeros_like(q), q * bu), validity, T.INT64)


def _greatest_least(f, args, ex, out_dtype, capacity, validity, device):
    """greatest / least, skipping NULLs: NULL only where every argument is."""
    is_max = f == "greatest"
    if out_dtype.is_string:
        args = unify_many_string_columns(list(args))
    acc = acc_valid = None
    for c in args:
        x = _coerce_to(c, out_dtype) if c.dtype != out_dtype else c.data
        v = c.valid()
        if acc is None:
            acc, acc_valid = x, v
            continue
        take = v & (~acc_valid | ((x > acc) if is_max else (x < acc)))
        acc = torch.where(take, x, acc)
        acc_valid = acc_valid | v
    all_valid = all(a.validity is None for a in args)
    return DeviceColumn(acc, None if all_valid else acc_valid, out_dtype,
                        args[0].dictionary if out_dtype.is_string else None)


def _coalesce(f, args, ex, out_dtype, capacity, validity, device):
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


def _nvl(f, args, ex, out_dtype, capacity, validity, device):
    """nvl / ifnull (a, else b); nvl2(test, when not NULL, when NULL)."""
    if f == "nvl2":
        a, b, c = args[0], args[1], args[2]
        not_null = a.valid()
        if b.dtype != c.dtype and b.dtype.is_numeric and c.dtype.is_numeric:
            common = T.common_numeric_type(b.dtype, c.dtype)
            b, c = cast_column(b, common, capacity), cast_column(c, common, capacity)
        data = torch.where(not_null, b.data, c.data)
        v = None
        if b.validity is not None or c.validity is not None:
            v = torch.where(not_null, b.valid(), c.valid())
        return DeviceColumn(data, v, b.dtype, b.dictionary)
    a, b = args
    if a.dtype.is_string:
        a, b = unify_string_columns(a, b)
        bd = b.data
    else:
        bd = _coerce_to(b, a.dtype)
    data = torch.where(a.valid(), a.data, bd)
    v = None if (a.validity is None or b.validity is None) else a.valid() | b.valid()
    return DeviceColumn(data, v, a.dtype, a.dictionary)


def _nullif(f, args, ex, out_dtype, capacity, validity, device):
    """NULL where a equals b, else a."""
    a, b = args
    if a.dtype.is_string:
        ua, ub = unify_string_columns(a, b)
        eq = ua.data == ub.data
    else:
        eq = a.data == _coerce_to(b, a.dtype)
    valid = a.valid() & ~(eq & a.valid() & b.valid())
    return DeviceColumn(a.data, valid, a.dtype, a.dictionary)


_STRING_IMPL = {
    "upper": np.char.upper, "lower": np.char.lower,
    "trim": np.char.strip, "btrim": np.char.strip,
    "ltrim": np.char.lstrip, "rtrim": np.char.rstrip,
    "initcap": np.char.title,
    "reverse": lambda v: np.array([s[::-1] for s in v], dtype="U"),
}


def _as_u(out) -> np.ndarray:
    return np.array(out, dtype="U")


def _split_part(v, delim, n):
    parts = v.split(delim) if delim else [v]
    i = n - 1 if n > 0 else len(parts) + n
    return parts[i] if 0 <= i < len(parts) else ""


def _substr_index(v, delim, n):
    # MySQL semantics: n > 0 keeps what precedes the n-th delimiter from the
    # left, n < 0 from the right
    if n == 0 or not delim:
        return ""
    parts = v.split(delim)
    return delim.join(parts[:n] if n > 0 else parts[n:])


def _encode(v, f, enc):
    import base64

    try:
        if f == "encode":
            raw = v.encode()
            return raw.hex() if enc == "hex" else base64.b64encode(raw).decode()
        raw = bytes.fromhex(v) if enc == "hex" else base64.b64decode(v)
        return raw.decode("utf-8", "replace")
    except (ValueError, UnicodeError):
        return ""


def _lpad(v, width, fill):
    return (fill * width + v)[-width:] if len(v) < width else v[:width]


def _string_transform(f, args, ex, out_dtype, capacity, validity, device):
    """Functions whose value is a new string per dictionary value: the
    transform runs over the distinct values and the rows take one gather
    of the code remap (transform_dictionary keeps the sorted-dictionary
    invariant)."""
    a = args[0]
    if f in _STRING_UNARY:
        return transform_dictionary(a, f, (), _STRING_IMPL[f])
    lits = tuple(_literal_value(x) for x in ex[1:])
    if f in ("substr", "substring"):
        i0 = max(int(lits[0]) - 1, 0)
        i1 = None if len(lits) < 2 else i0 + max(int(lits[1]), 0)
        return transform_dictionary(a, "substring", (i0, i1),
                                    lambda vals: _as_u([v[i0:i1] for v in vals]))
    per_value = {
        "left": lambda n: lambda v: v[:int(n)],
        "right": lambda n: lambda v: v[-int(n):] if int(n) else "",
        "repeat": lambda n: lambda v: v * int(n),
        "split_part": lambda d, n: lambda v: _split_part(v, str(d), int(n)),
        "substr_index": lambda d, n: lambda v: _substr_index(v, str(d), int(n)),
        "substring_index": lambda d, n: lambda v: _substr_index(v, str(d), int(n)),
        "overlay": lambda r, p, c=None: lambda v: (
            v[:int(p) - 1] + str(r) + v[int(p) - 1 + (len(str(r)) if c is None else int(c)):]),
        "encode": lambda e: lambda v: _encode(v, "encode", str(e).lower()),
        "decode": lambda e: lambda v: _encode(v, "decode", str(e).lower()),
        "lpad": lambda w, fill=" ": lambda v: _lpad(v, int(w), str(fill)),
        "rpad": lambda w, fill=" ": lambda v: (v + str(fill) * int(w))[:int(w)],
    }
    if f in per_value:
        fn = per_value[f](*lits)
        return transform_dictionary(a, f, lits,
                                    lambda vals: _as_u([fn(v) for v in vals]))
    if f == "replace":
        old, new = str(lits[0]), str(lits[1])
        return transform_dictionary(a, f, (old, new),
                                    lambda vals: np.char.replace(vals, old, new))
    if f == "translate":
        src, tgt = str(lits[0]), str(lits[1])
        table = str.maketrans(src, tgt[:len(src)].ljust(len(src)))
        return transform_dictionary(a, f, (src, tgt),
                                    lambda vals: _as_u([v.translate(table) for v in vals]))
    if f == "regexp_replace":
        rx = re.compile(str(lits[0]))
        repl = str(lits[1])
        return transform_dictionary(a, f, (str(lits[0]), repl),
                                    lambda vals: _as_u([rx.sub(repl, v) for v in vals]))
    # md5 / sha224 / sha256 / sha384 / sha512
    h = getattr(hashlib, f)
    return transform_dictionary(a, f, (),
                                lambda vals: _as_u([h(v.encode()).hexdigest() for v in vals]))


def _string_lookup(f, args, ex, out_dtype, capacity, validity, device):
    """Functions whose value is an integer or a bool per dictionary value:
    a table over the distinct values, one gather per row."""
    a = args[0]
    if f in ("length", "char_length", "character_length", "octet_length"):
        if a.dtype is not None and a.dtype.is_binary:
            d = a.dictionary or EMPTY_DICTIONARY
            work = dictionary_work(
                (d,), "byte_length", (),
                lambda: (np.array([len(v) for v in d.values] or [0], dtype=np.int64),))
            return DeviceColumn(work.lookup(0, a.data), validity, T.INT64)
        return DeviceColumn(_dict_ints(a, "length", (), np.char.str_len),
                            validity, T.INT64)
    if f == "ascii":
        return DeviceColumn(_dict_ints(a, f, (), lambda vals: [ord(v[0]) if v else 0
                                                              for v in vals]),
                            validity, T.INT64)
    pat = str(_literal_value(ex[1]))
    if f in ("strpos", "position"):
        return DeviceColumn(_dict_ints(a, "strpos", (pat,),
                                       lambda vals: np.char.find(vals, pat) + 1),
                            validity, T.INT64)
    if f == "find_in_set":
        idx = {v: i + 1 for i, v in enumerate(pat.split(","))}
        return DeviceColumn(_dict_ints(a, f, (pat,), lambda vals: [idx.get(v, 0) for v in vals]),
                            validity, T.INT64)
    if f in ("regexp_count", "regexp_instr"):
        rx = re.compile(pat)
        if f == "regexp_count":
            fn = lambda vals: [len(rx.findall(v)) for v in vals]  # noqa: E731
        else:
            fn = lambda vals: [(m.start() + 1) if (m := rx.search(v)) else 0  # noqa: E731
                               for v in vals]
        return DeviceColumn(_dict_ints(a, f, (pat,), fn), validity, T.INT64)
    if f in ("regexp_like", "regexp_match"):
        rx = re.compile(pat)
        pred = (lambda vals: np.fromiter((rx.search(v) is not None for v in vals),
                                         dtype=bool, count=len(vals)))
        return DeviceColumn(dict_predicate(a, "regexp", (pat,), pred), validity, T.BOOL)
    pred = {"starts_with": lambda v: np.char.startswith(v, pat),
            "ends_with": lambda v: np.char.endswith(v, pat),
            "contains": lambda v: np.char.find(v, pat) >= 0}[f]
    return DeviceColumn(dict_predicate(a, f, (pat,), pred), validity, T.BOOL)


def _int_to_string(f, args, ex, out_dtype, capacity, validity, device):
    """chr / char / to_hex: an integer column with small static bounds maps
    through a table over its whole domain (made once per bounds)."""
    a = args[0]
    b = a.bounds
    if b is None or b[1] - b[0] > (1 << 16):
        raise PlanError(f"{f} needs an integer column with small static "
                        f"bounds (got bounds={b})")
    lo, hi = int(b[0]), int(b[1])
    hexed = f == "to_hex"

    def compute():
        dom = np.arange(lo, hi + 1)
        strs = (np.array([format(x, "x") for x in dom], dtype="U") if hexed else
                np.array([chr(x) if 0 < x < 0x110000 else "" for x in dom], dtype="U"))
        uniq = np.unique(strs)
        return Dictionary(uniq.astype(object)), np.searchsorted(uniq, strs).astype(np.int32)

    work = dictionary_work((), "int_to_string", (hexed, lo, hi), compute)
    codes = work.lookup(1, a.data.to(torch.int64) - lo)
    return DeviceColumn(codes, validity, T.STRING, work.value[0])


def _constant_string(f, args, ex, out_dtype, capacity, validity, device):
    """arrow_typeof, version and uuid."""
    dev = device
    if f == "uuid":
        import uuid as _uuid

        # one value per slot, made on the host as the reference does
        vals = np.array(sorted(str(_uuid.uuid4()) for _ in range(capacity)), dtype=object)
        return DeviceColumn(torch.arange(capacity, dtype=torch.int32, device=dev), None,
                            T.STRING, Dictionary(vals))
    if f == "version":
        from .. import __version__

        text = f"datafusion-tpu {__version__}"
    else:
        text = arrow_type_name(args[0].dtype)
    return DeviceColumn(_full(capacity, 0, torch.int32, device=dev), None, T.STRING,
                        literal_dictionary(text))


def _arrow_cast(f, args, ex, out_dtype, capacity, validity, device):
    src = ex[0] if ex else None
    src = src.expr if isinstance(src, E.Alias) else src
    if isinstance(src, E.Literal) and src.value is None:
        # arrow_cast(NULL, 'T'): a typed all-NULL column
        return _literal_column(E.Literal(None, out_dtype), capacity, device)
    return cast_column(args[0], out_dtype, capacity)


def _unwrap_casts(node):
    node = node.expr if isinstance(node, E.Alias) else node
    while isinstance(node, E.Cast):
        node = node.expr
    return node


def _concat(f, args, ex, out_dtype, capacity, validity, device):
    """concat / ||: literals fold into the values on the host; each string
    column multiplies the composite dictionary (code = base * |d| + code).
    The product is capped at _CONCAT_CAP: concat of two high-cardinality
    columns would need a row-wise string kernel. The composite dictionary
    and its sorted re-encoding are made once per (dictionaries, literals)."""
    binmode = any(a.dtype is not None and a.dtype.is_binary for a in args)
    parts, dicts, cols = [], [], []
    for a, ae in zip(args, ex):
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
        vals = [b""] if binmode else np.array([""], dtype="U1")
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
        codes = _full(capacity, 0, torch.int32, device=device)
    return DeviceColumn(work.lookup(1, codes).to(torch.int32), validity,
                        T.BINARY if binmode else T.STRING, work.value[0])


def _concat_ws(f, args, ex, out_dtype, capacity, validity, device):
    """concat_ws(sep, ...): NULL arguments are skipped with their separator,
    a NULL separator gives NULL. Constant arguments fold into every
    combination; each string column multiplies the composite dictionary,
    with one extra slot for its NULL rows."""
    if not ex:
        raise PlanError("concat_ws needs a separator argument")
    dev = device
    sep_node = _unwrap_casts(ex[0])
    if not isinstance(sep_node, E.Literal):
        raise NotImplementedYet("concat_ws with a non-constant separator")
    if sep_node.value is None:
        return DeviceColumn(_full(capacity, 0, torch.int32, device=dev),
                            _full(capacity, False, torch.bool, device=dev), T.STRING,
                            EMPTY_DICTIONARY)
    sep = str(sep_node.value)
    parts, dicts, cols = [], [], []
    for a, ae in zip(args[1:], ex[1:]):
        node = _unwrap_casts(ae)
        if isinstance(node, E.Literal):
            parts.append(("lit", None if node.value is None else str(node.value)))
            continue
        if isinstance(node, E.ScalarFunction) \
                and node.fname in ("make_array", "array", "make_list"):
            try:  # a literal array: its elements are pieces of their own
                pieces = N._literal_py(node) or []
            except PlanError:
                pieces = None
            if pieces is not None:
                parts.extend(("lit", None if x is None else str(x)) for x in pieces)
                continue
        if not (a.dtype.is_string and a.dictionary is not None):
            raise NotImplementedYet("concat_ws of non-string non-constant argument")
        nullable = a.validity is not None
        if not len(a.dictionary.values) and not nullable:
            continue
        parts.append(("col", len(dicts), nullable))
        dicts.append(a.dictionary)
        cols.append(a)

    def compute():
        combos = [()]  # tuples of str-or-None pieces
        for p in parts:
            if p[0] == "lit":
                combos = [c + (p[1],) for c in combos]
                continue
            dv = [str(v) for v in dicts[p[1]].values] + ([None] if p[2] else [])
            if len(combos) * len(dv) > _CONCAT_CAP:
                raise NotImplementedYet(
                    f"concat_ws dictionary product {len(combos)}x{len(dv)} "
                    f"exceeds {_CONCAT_CAP}")
            combos = [c + (d,) for c in combos for d in dv]
        vals = np.array([sep.join(x for x in c if x is not None) for c in combos],
                        dtype=object)
        uniq = np.unique(vals.astype("U"))
        lut = {v: i for i, v in enumerate(uniq)}
        return (Dictionary(uniq.astype(object)),
                np.array([lut[str(v)] for v in vals], dtype=np.int32))

    work = dictionary_work(tuple(dicts), "concat_ws", (sep, tuple(parts)), compute)
    codes = None
    for a, p in zip(cols, (p for p in parts if p[0] == "col")):
        n = len(a.dictionary.values) + (1 if p[2] else 0)
        cc = torch.clamp(a.data, 0, max(len(a.dictionary.values) - 1, 0))
        if p[2]:
            cc = torch.where(a.validity, cc, torch.full_like(cc, n - 1))
        codes = cc if codes is None else codes * n + cc
    if codes is None:
        codes = _full(capacity, 0, torch.int32, device=dev)
    return DeviceColumn(work.lookup(1, codes).to(torch.int32), None, T.STRING,
                        work.value[0])


def _not_evaluated(f, args, ex, out_dtype, capacity, validity, device):
    """Names the reference types but does not evaluate (random, levenshtein,
    bit_length, to_char with other than two arguments): its PlanError."""
    raise PlanError(f"scalar function {f!r} not implemented")


_IMPLS = {}
for _names, _fn in (
        (("date_part", "extract", "year", "month", "day"), _date_part),
        (("date_trunc",), _date_trunc),
        (("date_bin",), _date_bin),
        (("now", "current_timestamp", "current_date", "today", "current_time"), _clock),
        (("to_time", "make_time", "make_date", "to_local_time", "at_time_zone",
          "from_unixtime", "to_unixtime"), _time_conv),
        (tuple(_TO_TS), _to_timestamp),
        (("to_date",), _to_date),
        (tuple(_NUMERIC_UNARY), _numeric_unary),
        (("power", "pow", "atan2", "log", "cot", "nanvl", "pi"), _numeric_binary),
        (("isnan", "iszero"), _float_tests),
        (("factorial",), _factorial),
        (("gcd", "lcm"), _gcd_lcm),
        (("greatest", "least"), _greatest_least),
        (("coalesce",), _coalesce),
        (("nvl", "ifnull", "nvl2"), _nvl),
        (("nullif",), _nullif),
        (tuple(_STRING_UNARY) + ("substr", "substring", "left", "right", "repeat",
                                 "split_part", "substr_index", "substring_index",
                                 "overlay", "encode", "decode", "lpad", "rpad",
                                 "replace", "translate", "regexp_replace", "md5",
                                 "sha224", "sha256", "sha384", "sha512"), _string_transform),
        (("length", "char_length", "character_length", "octet_length", "ascii",
          "strpos", "position", "find_in_set", "regexp_count", "regexp_instr",
          "regexp_like", "regexp_match", "starts_with", "ends_with", "contains"),
         _string_lookup),
        (("chr", "char", "to_hex"), _int_to_string),
        (("arrow_typeof", "version", "uuid"), _constant_string),
        (("arrow_cast",), _arrow_cast),
        (("concat",), _concat),
        (("concat_ws",), _concat_ws),
        (("random", "levenshtein", "bit_length", "to_char", "date_format"), _not_evaluated)):
    for _n in _names:
        _IMPLS[_n] = _fn


def eval_scalar_function(fname: str, args: List[DeviceColumn],
                         arg_exprs: Sequence[E.Expr], out_dtype: T.DataType,
                         capacity: int, device=None) -> DeviceColumn:
    """fname over the evaluated args on `device` (the relation's: a function
    without arguments has no column to take it from)."""
    if fname in N.NESTED_FNS:
        return N.eval_nested_function(fname, args, arg_exprs, out_dtype, capacity,
                                      device)
    if _spark_active(fname):
        from ..spark import functions as SK

        return SK.eval_spark_function(fname, args, arg_exprs, out_dtype, capacity,
                                      device)
    impl = _IMPLS.get(fname)
    if impl is None:
        raise PlanError(f"scalar function {fname!r} not implemented")
    validity = _combine_validity(*(a.validity for a in args))
    return impl(fname, args, arg_exprs, out_dtype, capacity, validity, device)
