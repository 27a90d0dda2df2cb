"""Spark-semantics scalar functions (reference: datafusion/spark/src/function/).

Port of datafusion_tpu/spark/functions.py. Numeric, bitwise and date work
is torch ops on the column's device. String work is a host transform over
the column's dictionary (its distinct values) with a code remap on the
device (physical/functions.py transform_dictionary), and integer-to-string
and string-to-integer tables are made the same way (expr_compiler.
dictionary_work): once per dictionary or bounds, copied to the device before
a steady state is captured.

Semantics intentionally differ from the core library where Spark differs:
  round     HALF_UP (core/bround are HALF_EVEN)      math/round.rs
  substring 1-based, negative pos counts from end    string/substring.rs
  hex       uppercase, ints and strings              math/hex.rs

Shifts by a count outside [0, 64) give what XLA gives the JAX package: 0
for shiftleft and shiftrightunsigned, the sign for shiftright and bit_get
(torch leaves them to the C++ shift). bit_count is a SWAR popcount of the
int64 bits (torch has no popcount).
"""
from __future__ import annotations

import binascii
from typing import List, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import PlanError
from ..data.column import Dictionary
from ..data.device import DeviceColumn
from ..expr import nodes as E
from ..utils import dates as DU

SPARK_FNS = frozenset({
    # math / bitwise
    "round", "bround", "expm1", "log1p", "rint", "hypot", "pmod",
    "width_bucket", "bin", "hex", "unhex", "bit_count", "bit_get", "getbit",
    "shiftleft", "shiftright", "shiftrightunsigned", "bitwise_not",
    # hash
    "sha1", "sha2", "crc32", "xxhash64",
    # string
    "elt", "space", "base64", "unbase64", "soundex", "luhn_check",
    "format_string", "printf",
    "substring", "substr", "url_encode", "url_decode",
    # datetime
    "add_months", "date_add", "date_sub", "datediff", "date_diff",
    "last_day", "next_day", "weekday", "dayofweek", "dayofmonth",
    "months_between", "unix_timestamp",
    # conditional / predicate / misc
    "if", "nvl2", "isnull", "isnotnull", "monotonically_increasing_id",
    # misc additions
    "negative", "positive", "size", "slice", "parse_url", "try_parse_url",
    "from_utc_timestamp", "to_utc_timestamp", "make_dt_interval",
    "make_interval",
})


def spark_function_type(e: E.ScalarFunction, schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    f = e.fname
    argt = [infer(a, schema) for a in e.args]
    nullable = any(n for _, n in argt)
    if f in ("round", "bround"):
        t = argt[0][0]
        return (t if t.is_integer or t.is_decimal else T.FLOAT64), nullable
    if f in ("expm1", "log1p", "rint", "hypot", "months_between"):
        return T.FLOAT64, nullable
    if f in ("pmod", "width_bucket", "bit_count", "bit_get", "getbit",
             "shiftleft", "shiftright", "shiftrightunsigned", "bitwise_not",
             "crc32", "xxhash64", "weekday", "dayofweek", "dayofmonth",
             "datediff", "date_diff", "unix_timestamp",
             "monotonically_increasing_id"):
        return T.INT64, f != "monotonically_increasing_id" and nullable
    if f in ("bin", "hex", "unhex", "sha1", "sha2", "elt", "space", "base64",
             "unbase64", "soundex", "substring", "substr", "url_encode",
             "url_decode"):
        return T.STRING, nullable
    if f in ("format_string", "printf"):
        return T.STRING, argt[0][1] if argt else False
    if f in ("negative", "positive"):
        return argt[0][0], nullable
    if f == "slice":
        return argt[0][0], True
    if f == "size":
        return T.INT64, False
    if f in ("parse_url", "try_parse_url"):
        return T.STRING, True
    if f in ("from_utc_timestamp", "to_utc_timestamp"):
        return T.TIMESTAMP, nullable
    if f == "make_dt_interval":
        return T.INTERVAL_US, nullable
    if f == "make_interval":
        # years/months only -> calendar months; any finer field -> us
        return (T.INTERVAL_MONTHS if len(e.args) <= 2
                else T.INTERVAL_US), nullable
    if f == "luhn_check":
        return T.BOOL, nullable
    if f in ("add_months", "date_add", "date_sub", "last_day", "next_day"):
        return T.DATE32, nullable
    if f == "if":
        return argt[1][0], True
    if f == "nvl2":
        return argt[1][0], argt[1][1] or argt[2][1]
    if f in ("isnull", "isnotnull"):
        return T.BOOL, False
    raise PlanError(f"unknown spark function {f!r}")


def _lit(arg_exprs, i, default=None):
    if i >= len(arg_exprs):
        return default
    e = arg_exprs[i]
    while isinstance(e, (E.Alias, E.Cast)):
        # 5::int / aliased literals fold through
        e = e.expr
    if isinstance(e, E.Negative):
        inner = _lit([e.expr], 0)
        return None if inner is None else -inner
    if not isinstance(e, E.Literal):
        raise PlanError("spark function argument must be a literal here")
    return e.value


def _const_typed(e):
    """Python value of a constant argument expression (format_string args),
    normalized by its SQL type: bools stay bool, dates/timestamps become
    datetime objects, decimals become floats. Raises PlanError on
    non-constant arguments."""
    import datetime as _dt

    e = e.expr if isinstance(e, E.Alias) else e
    if isinstance(e, E.Negative):
        v = _const_typed(e.expr)
        return None if v is None else -v
    if isinstance(e, E.Cast):
        v = _const_typed(e.expr)
        return _norm_const(v, e.dtype)
    if isinstance(e, E.ScalarFunction) and e.fname == "arrow_cast" \
            and len(e.args) == 2 and isinstance(e.args[1], E.Literal):
        from ..physical.functions import parse_arrow_type

        v = _const_typed(e.args[0])
        tname = str(e.args[1].value)
        rt = _temporal_const(v, tname)
        if rt is not None:
            return rt
        return _norm_const(v, parse_arrow_type(tname))
    if not isinstance(e, E.Literal):
        raise PlanError("format_string arguments must be constants")
    return _norm_const(e.value, e.dtype)


_TIME_UNIT_US = {"s": 1_000_000, "second": 1_000_000,
                 "ms": 1_000, "millisecond": 1_000,
                 "us": 1, "µs": 1, "microsecond": 1,
                 "ns": None, "nanosecond": None}  # None: divide by 1000


def _temporal_const(v, tname: str):
    """RawTemporal for arrow_cast of a raw number to a unit-bearing
    temporal type (Timestamp(s|ms|us|ns), Time32/64, Date32/64): Spark's %s
    prints the raw epoch number while %t* sees the calendar value. Returns
    None when `tname` is not such a type."""
    import datetime as _dt
    import re as _re

    from .javafmt import RawTemporal

    if v is None:
        return None
    low = tname.strip().lower()
    m = _re.match(r"timestamp\s*\(\s*([a-zµ]+)", low)
    if m and m.group(1) in _TIME_UNIT_US:
        unit = _TIME_UNIT_US[m.group(1)]
        if isinstance(v, bool):
            raise PlanError("cannot cast boolean to timestamp")
        if isinstance(v, (int, float)):
            raw = int(v)
        else:
            # string -> epoch in the target unit (ns-capable: datetime only
            # carries us, so split the fraction out by hand)
            s = str(v).strip().rstrip("Zz").replace("T", " ")
            frac = ""
            if "." in s:
                s, frac = s.split(".", 1)
            base = _dt.datetime.strptime(s.strip(), "%Y-%m-%d %H:%M:%S")
            ns = int((base - _dt.datetime(1970, 1, 1)).total_seconds()) \
                * 1_000_000_000 + int((frac + "0" * 9)[:9] or 0)
            raw = ns // (unit * 1000) if unit else ns
        us = raw * unit if unit is not None else raw // 1000
        dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=us)
        return RawTemporal(raw, dt)
    m = _re.match(r"time(?:32|64)\s*\(\s*([a-zµ]+)", low)
    if m and m.group(1) in _TIME_UNIT_US and isinstance(v, (int, float)) \
            and not isinstance(v, bool):
        unit = _TIME_UNIT_US[m.group(1)]
        raw = int(v)
        us = raw * unit if unit is not None else raw // 1000
        dt = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=us)
        return RawTemporal(raw, dt)
    if low.startswith("date") and isinstance(v, (int, float)) \
            and not isinstance(v, bool):
        raw = int(v)
        return RawTemporal(
            raw, _dt.date(1970, 1, 1) + _dt.timedelta(days=raw))
    return None


def _norm_const(v, dtype: T.DataType):
    import datetime as _dt

    if v is None:
        return None
    if dtype.kind is T.TypeKind.BOOL:
        return bool(v)
    if dtype.is_decimal or dtype.is_float:
        return float(v)
    if dtype.is_integer:
        return int(v)
    if dtype.kind is T.TypeKind.DATE32:
        if isinstance(v, (int, np.integer)):
            return _dt.date(1970, 1, 1) + _dt.timedelta(days=int(v))
        return _dt.date.fromisoformat(str(v))
    if dtype.kind is T.TypeKind.TIMESTAMP:
        if isinstance(v, (int, np.integer)):
            return (_dt.datetime(1970, 1, 1)
                    + _dt.timedelta(microseconds=int(v)))
        from .javafmt import _as_datetime

        return _as_datetime(str(v))
    return v


def _xxhash64(data: bytes, seed: int = 42) -> int:
    """Pure-python xxHash64 (public algorithm; Spark seeds with 42)."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1

    def rot(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    n = len(data)
    if n >= 32:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        i = 0
        while i <= n - 32:
            for j, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 8 * j:i + 8 * j + 8], "little")
                v = (v + lane * P2) & M
                v = rot(v, 31)
                v = (v * P1) & M
                if j == 0:
                    v1 = v
                elif j == 1:
                    v2 = v
                elif j == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (rot(v1, 1) + rot(v2, 7) + rot(v3, 12) + rot(v4, 18)) & M
        for v in (v1, v2, v3, v4):
            v = (v * P2) & M
            v = rot(v, 31)
            v = (v * P1) & M
            h = ((h ^ v) * P1 + P4) & M
    else:
        h = (seed + P5) & M
        i = 0
    h = (h + n) & M
    while i <= n - 8:
        lane = int.from_bytes(data[i:i + 8], "little")
        k = (lane * P2) & M
        k = rot(k, 31)
        k = (k * P1) & M
        h = (rot(h ^ k, 27) * P1 + P4) & M
        i += 8
    if i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = (rot(h ^ ((lane * P1) & M), 23) * P2 + P3) & M
        i += 4
    while i < n:
        h = (rot(h ^ ((data[i] * P5) & M), 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


def _soundex(s: str) -> str:
    if not s or not s[0].isalpha():
        return s
    codes = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
             **{c: "3" for c in "DT"}, "L": "4",
             **{c: "5" for c in "MN"}, "R": "6"}
    up = s.upper()
    out = up[0]
    prev = codes.get(up[0], "")
    for ch in up[1:]:
        c = codes.get(ch, "")
        if c and c != prev:
            out += c
            if len(out) == 4:
                break
        if ch not in "HW":
            prev = c
    return (out + "000")[:4]


def _luhn(s: str) -> bool:
    if not s or not s.isdigit():
        return False
    total = 0
    for i, ch in enumerate(reversed(s)):
        d = ord(ch) - 48
        if i % 2 == 1:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return total % 10 == 0


_DOW = {"mo": 0, "tu": 1, "we": 2, "th": 3, "fr": 4, "sa": 5, "su": 6}


def _in_range(n: torch.Tensor) -> torch.Tensor:
    return (n >= 0) & (n < 64)


def _shift_left(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.where(_in_range(n), x << n.clamp(0, 63), 0)


def _shift_right(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Arithmetic: a count outside [0, 64) leaves the sign (0 or -1)."""
    return x >> torch.where(_in_range(n), n, 63)


def _shift_right_logical(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The int64 bits shifted as uint64 (torch has no uint64 >> on the CPU):
    an arithmetic shift with the copied sign bits masked off."""
    k = n.clamp(1, 63)
    low = ~(torch.full_like(x, -1) << (64 - k))
    out = torch.where(n == 0, x, (x >> k) & low)
    return torch.where(_in_range(n), out, 0)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (SWAR; every mask leaves bit 63 clear,
    so the arithmetic shifts act as logical ones)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return (x * 0x0101010101010101) >> 56


def _round_decimal(v: torch.Tensor, k: int, half_up: bool) -> torch.Tensor:
    """Scaled decimal words rounded to a multiple of 10**k, exactly: HALF_UP
    (away from zero on a tie) or HALF_EVEN. The JAX package rounds
    x / 10**scale in float64, whose ties XLA's simplifier happens to keep
    (1.005 -> 1.01); torch's float64 does not (1.00499...), so the port
    rounds the integer words, which is Spark's answer on every input."""
    if k <= 0:
        return v
    if k > 18:  # every representable word is under half of 10**k
        return torch.zeros_like(v)
    fac = 10 ** k
    mag = v.abs()
    q, r = mag // fac, mag % fac
    up = (2 * r >= fac) if half_up else \
        (2 * r > fac) | ((2 * r == fac) & (q % 2 == 1))
    return torch.sign(v) * (q + up.to(torch.int64)) * fac


def _null_strings(cap: int, device) -> DeviceColumn:
    return DeviceColumn(torch.zeros(cap, dtype=torch.int32, device=device),
                        torch.zeros(cap, dtype=torch.bool, device=device),
                        T.STRING, Dictionary(np.array([], object)))


def _constant_string(cap: int, value: str, device) -> DeviceColumn:
    return DeviceColumn(torch.zeros(cap, dtype=torch.int32, device=device), None,
                        T.STRING, Dictionary(np.array([value], object)))


def _domain_strings(f: str, col: DeviceColumn, limit: int, fmt) -> DeviceColumn:
    """An integer column with small static bounds as strings, through a
    table over its whole domain (made once per bounds)."""
    from ..physical.expr_compiler import dictionary_work

    b = col.bounds
    if b is None or b[1] - b[0] > limit:
        if f == "space":
            raise PlanError("space needs an integer column with small bounds")
        raise PlanError(f"{f} needs an integer column with small static "
                        f"bounds (got bounds={b})")
    lo, hi = int(b[0]), int(b[1])

    def compute():
        strs = np.array([fmt(x) for x in range(lo, hi + 1)], "U")
        uniq = np.unique(strs)
        return Dictionary(uniq.astype(object)), np.searchsorted(uniq, strs).astype(np.int32)

    work = dictionary_work((), "spark_" + f, (lo, hi), compute)
    return DeviceColumn(work.lookup(1, col.data.to(torch.int64) - lo), None,
                        T.STRING, work.value[0])


def _strings(f, args, fn, *key):
    """A host transform of a string column's dictionary values."""
    from ..physical.functions import transform_dictionary

    return transform_dictionary(args[0], "spark_" + f, key,
                                lambda vals: np.array([fn(v) for v in vals], "U"))


def _unhex(v: str) -> str:
    try:
        return bytes.fromhex(v).decode("utf-8", "replace")
    except ValueError:
        return ""


def _unbase64(v: str) -> str:
    import base64

    try:
        return base64.b64decode(v).decode("utf-8", "replace")
    except Exception:  # noqa: BLE001 -- undecodable input maps to ""
        return ""


def eval_spark_function(
    f: str,
    args: List[DeviceColumn],
    arg_exprs,
    out_dtype: T.DataType,
    capacity: int,
    device=None,
) -> DeviceColumn:
    """f over the evaluated args on `device` (the relation's)."""
    from ..physical.expr_compiler import _combine_validity, _to_float

    validity = _combine_validity(*(a.validity for a in args))
    dev = args[0].data.device if args else device

    # ---- math --------------------------------------------------------------
    if f in ("round", "bround"):
        a = args[0]
        nd = int(_lit(arg_exprs, 1, 0) or 0)
        s = 10.0 ** nd
        if a.dtype.is_integer and nd >= 0:
            return DeviceColumn(a.data, validity, a.dtype)
        if a.dtype.is_decimal:
            return DeviceColumn(_round_decimal(a.data, a.dtype.scale - nd, f == "round"),
                                validity, a.dtype)
        x = _to_float(a)
        if f == "round":  # HALF_UP (Spark round; reference math/round.rs)
            r = torch.sign(x) * torch.floor(torch.abs(x) * s + 0.5) / s
        else:             # HALF_EVEN
            r = torch.round(x * s) / s
        return DeviceColumn(r, validity, T.FLOAT64)
    if f == "expm1":
        return DeviceColumn(torch.expm1(_to_float(args[0])), validity, T.FLOAT64)
    if f == "log1p":
        return DeviceColumn(torch.log1p(_to_float(args[0])), validity, T.FLOAT64)
    if f == "rint":
        return DeviceColumn(torch.round(_to_float(args[0])), validity, T.FLOAT64)
    if f == "hypot":
        return DeviceColumn(torch.hypot(_to_float(args[0]), _to_float(args[1])),
                            validity, T.FLOAT64)
    if f == "pmod":
        a = args[0].data.to(torch.int64)
        b = args[1].data.to(torch.int64)
        zmask = b == 0
        bz = torch.where(zmask, 1, b)
        r = ((a % bz) + bz) % bz
        v = (~zmask) if validity is None else (validity & ~zmask)
        return DeviceColumn(r, v, T.INT64)
    if f == "width_bucket":
        x = _to_float(args[0])
        lo = float(_lit(arg_exprs, 1))
        hi = float(_lit(arg_exprs, 2))
        n = int(_lit(arg_exprs, 3))
        b = torch.clamp(torch.floor((x - lo) / (hi - lo) * n) + 1, 0, n + 1)
        # XLA converts NaN to 0
        return DeviceColumn(torch.nan_to_num(b, nan=0.0).to(torch.int64), validity,
                            T.INT64)

    # ---- bitwise -----------------------------------------------------------
    if f == "bit_count":
        return DeviceColumn(_popcount(args[0].data.to(torch.int64)), validity, T.INT64)
    if f in ("bit_get", "getbit"):
        x = args[0].data.to(torch.int64)
        return DeviceColumn(_shift_right(x, args[1].data.to(torch.int64)) & 1,
                            validity, T.INT64)
    if f == "shiftleft":
        return DeviceColumn(_shift_left(args[0].data.to(torch.int64),
                                        args[1].data.to(torch.int64)), validity, T.INT64)
    if f == "shiftright":
        return DeviceColumn(_shift_right(args[0].data.to(torch.int64),
                                         args[1].data.to(torch.int64)), validity, T.INT64)
    if f == "shiftrightunsigned":
        return DeviceColumn(_shift_right_logical(args[0].data.to(torch.int64),
                                                 args[1].data.to(torch.int64)),
                            validity, T.INT64)
    if f == "bitwise_not":
        return DeviceColumn(~args[0].data.to(torch.int64), validity, T.INT64)

    # ---- int -> string via bounds LUT --------------------------------------
    if f in ("bin", "hex") and not args[0].dtype.is_string:
        code = "b" if f == "bin" else "X"
        out = _domain_strings(f, args[0], 1 << 16,
                              lambda x: format(x if x >= 0 else x + (1 << 64), code))
        return DeviceColumn(out.data, validity, T.STRING, out.dictionary)

    # ---- string (dictionary transforms) ------------------------------------
    if f == "hex":  # string input: utf8 bytes, uppercase
        return _strings(f, args, lambda v: v.encode().hex().upper())
    if f == "unhex":
        return _strings(f, args, _unhex)
    if f == "sha1":
        import hashlib

        return _strings(f, args, lambda v: hashlib.sha1(v.encode()).hexdigest())
    if f == "sha2":
        import hashlib

        bits = int(_lit(arg_exprs, 1, 256))
        algo = {0: "sha256", 224: "sha224", 256: "sha256", 384: "sha384",
                512: "sha512"}.get(bits)
        if algo is None:
            raise PlanError(f"sha2 bit length {bits} not supported")
        return _strings(f, args, lambda v: getattr(hashlib, algo)(v.encode()).hexdigest(),
                        algo)
    if f in ("crc32", "xxhash64"):
        from ..physical.functions import _dict_ints

        def ints(vals):
            if f == "crc32":
                return [binascii.crc32(v.encode()) for v in vals]
            hs = [_xxhash64(v.encode()) for v in vals]
            return [h - (1 << 64) if h >= 1 << 63 else h for h in hs]

        return DeviceColumn(_dict_ints(args[0], "spark_" + f, (), ints), validity,
                            T.INT64)
    if f == "base64":
        import base64

        return _strings(f, args, lambda v: base64.b64encode(v.encode()).decode())
    if f == "unbase64":
        return _strings(f, args, _unbase64)
    if f == "soundex":
        return _strings(f, args, _soundex)
    if f == "luhn_check":
        from ..physical.functions import dict_predicate

        return DeviceColumn(dict_predicate(args[0], "spark_luhn", (), lambda vals: np.array(
            [_luhn(v) for v in vals], bool)), validity, T.BOOL)
    if f in ("substring", "substr"):
        # Spark: 1-based; pos 0 treated as 1; negative pos counts from end
        _missing = object()
        rawpos = _lit(arg_exprs, 1, _missing)
        rawlen = _lit(arg_exprs, 2, _missing)
        if rawpos is None or rawlen is None:  # NULL pos/len -> NULL
            return _null_strings(args[0].data.shape[0], dev)
        pos = int(rawpos) if rawpos is not _missing else 1
        ln = None if rawlen is _missing else int(rawlen)

        def sub(v):
            p = pos
            if p < 0:
                p = max(len(v) + p, 0)
            elif p > 0:
                p -= 1
            return v[p:] if ln is None else v[p:p + max(ln, 0)]

        return _strings(f, args, sub, pos, ln)
    if f == "url_encode":
        from urllib.parse import quote_plus

        return _strings(f, args, quote_plus)
    if f == "url_decode":
        from urllib.parse import unquote_plus

        return _strings(f, args, unquote_plus)
    if f == "space":
        out = _domain_strings(f, args[0], 1 << 12, lambda x: " " * max(x, 0))
        return DeviceColumn(out.data, validity, T.STRING, out.dictionary)
    if f in ("format_string", "printf"):
        from .javafmt import JavaFormatError, java_format

        cap = args[0].data.shape[0] if args else capacity
        if not args or not (args[0].dtype.is_string
                            or args[0].dtype.kind is T.TypeKind.NULL):
            raise PlanError("format_string: format must be a string")
        vals = [_const_typed(e) for e in arg_exprs]
        fmt = vals[0]
        if fmt is None:
            return _null_strings(cap, dev)
        try:
            s = java_format(str(fmt), vals[1:])
        except JavaFormatError as err:
            raise PlanError(f"format_string: {err}") from err
        return _constant_string(cap, s, dev)
    if f == "elt":
        idx_e = arg_exprs[0]
        idx_e = idx_e.expr if isinstance(idx_e, E.Alias) else idx_e
        choices = args[1:]
        if isinstance(idx_e, E.Literal):
            i = int(idx_e.value)
            if not 1 <= i <= len(choices):
                return _null_strings(args[0].data.shape[0], dev)
            return choices[i - 1]
        if all(not c.dtype.is_string for c in choices):
            i = args[0].data.to(torch.int64)
            data = choices[0].data
            for j in range(1, len(choices)):
                data = torch.where(i == j + 1, choices[j].data, data)
            ok = (i >= 1) & (i <= len(choices))
            v = ok if validity is None else (validity & ok)
            return DeviceColumn(data, v, choices[0].dtype)
        raise PlanError("elt with a non-literal index over strings is not "
                        "supported")

    # ---- datetime ----------------------------------------------------------
    if f == "add_months":
        return DeviceColumn(DU.add_months(args[0].data, args[1].data.to(torch.int32)),
                            validity, T.DATE32)
    if f in ("date_add", "date_sub"):
        d = args[0].data
        n = args[1].data.to(torch.int32)
        return DeviceColumn(d + (n if f == "date_add" else -n), validity, T.DATE32)
    if f in ("datediff", "date_diff"):
        return DeviceColumn(args[0].data.to(torch.int64) - args[1].data.to(torch.int64),
                            validity, T.INT64)
    if f == "last_day":
        y, m, _ = DU.civil_from_days(args[0].data)
        nxt = DU.add_months(DU.days_from_civil(y, m, torch.ones_like(m)), 1)
        return DeviceColumn(nxt - 1, validity, T.DATE32)
    if f == "next_day":
        d = args[0].data
        day = str(_lit(arg_exprs, 1, "mo"))[:2].lower()
        if day not in _DOW:
            raise PlanError(f"next_day: unknown day name {day!r}")
        target = _DOW[day]  # 0 = Monday
        dow = (d.to(torch.int64) + 3) % 7  # 1970-01-01 is a Thursday
        delta = (target - dow + 7) % 7
        delta = torch.where(delta == 0, 7, delta)
        return DeviceColumn((d.to(torch.int64) + delta).to(d.dtype), validity, T.DATE32)
    if f == "weekday":  # Monday = 0
        return DeviceColumn((args[0].data.to(torch.int64) + 3) % 7, validity, T.INT64)
    if f == "dayofweek":  # Sunday = 1
        return DeviceColumn((args[0].data.to(torch.int64) + 4) % 7 + 1, validity,
                            T.INT64)
    if f == "dayofmonth":
        _, _, dd = DU.civil_from_days(args[0].data)
        return DeviceColumn(dd.to(torch.int64), validity, T.INT64)
    if f == "months_between":
        y1, m1, d1 = DU.civil_from_days(args[0].data)
        y2, m2, d2 = DU.civil_from_days(args[1].data)
        whole = (y1 - y2) * 12 + (m1 - m2)
        frac = (d1 - d2).to(torch.float64) / 31.0
        return DeviceColumn(whole.to(torch.float64) + frac, validity, T.FLOAT64)
    if f == "unix_timestamp":
        a = args[0]
        if a.dtype.kind is T.TypeKind.TIMESTAMP:
            return DeviceColumn(a.data // 1_000_000, validity, T.INT64)
        if a.dtype.kind is T.TypeKind.DATE32:
            return DeviceColumn(a.data.to(torch.int64) * 86400, validity, T.INT64)
        raise PlanError("unix_timestamp expects a date or timestamp")

    # ---- conditional / predicate / misc ------------------------------------
    if f in ("if", "nvl2"):
        test, a, b = args
        if f == "if":
            cv = test.data.to(torch.bool)
            if test.validity is not None:
                cv = cv & test.validity
        else:
            cv = test.valid()
        if a.dtype.is_string or b.dtype.is_string:
            from ..physical.expr_compiler import unify_string_columns

            a, b = unify_string_columns(a, b)
        return DeviceColumn(torch.where(cv, a.data, b.data),
                            torch.where(cv, a.valid(), b.valid()), out_dtype,
                            a.dictionary)
    if f in ("isnull", "isnotnull"):
        v = args[0].valid()
        return DeviceColumn(~v if f == "isnull" else v, None, T.BOOL)
    if f == "monotonically_increasing_id":
        return DeviceColumn(torch.arange(capacity, dtype=torch.int64, device=dev), None,
                            T.INT64)
    if f in ("negative", "positive"):
        a = args[0]
        return DeviceColumn(-a.data if f == "negative" else a.data, validity, a.dtype,
                            a.dictionary)
    if f == "slice":
        # Spark slice(arr, start, length): 1-based start, negative counts
        # from the end; start=0 errors; negative length errors
        col = args[0]
        start = _lit(arg_exprs, 1)
        length = _lit(arg_exprs, 2)
        cap, w = col.data.shape[0], col.width
        if start is None or length is None:
            return DeviceColumn(torch.zeros((cap, w), dtype=col.data.dtype, device=dev),
                                torch.zeros(cap, dtype=torch.bool, device=dev),
                                col.dtype, col.dictionary,
                                lengths=torch.zeros(cap, dtype=torch.int32, device=dev))
        start, length = int(start), int(length)
        if start == 0:
            raise PlanError("slice: start must not be zero")
        if length < 0:
            raise PlanError("slice: length must be non-negative")
        lens = col.list_lengths()
        j0 = lens + start if start < 0 else torch.full_like(lens, start - 1)
        slots = torch.arange(w, dtype=lens.dtype, device=dev)[None, :]
        idx = j0[:, None] + slots
        ok = (idx >= 0) & (idx < lens[:, None]) & (slots < length)
        idxc = torch.clamp(idx, 0, max(w - 1, 0)).long()
        data = torch.gather(col.data, 1, idxc)
        sv = torch.gather(col.slot_valid(), 1, idxc)
        new_lens = torch.clamp(torch.minimum(lens - j0, torch.full_like(lens, length)),
                               min=0).to(torch.int32)
        return DeviceColumn(torch.where(ok, data, torch.zeros_like(data)), col.validity,
                            col.dtype, col.dictionary, lengths=new_lens,
                            elem_valid=ok & sv)
    if f == "size":
        # Spark size: length of array/map; NULL input -> -1 (legacy Spark
        # default, which the reference implements; spark/src/function/
        # collection/size.rs)
        a = args[0]
        lens = a.list_lengths().to(torch.int64) if a.dtype.is_list else \
            torch.ones(a.data.shape[0], dtype=torch.int64, device=dev)
        data = lens if a.validity is None else torch.where(a.validity, lens, -1)
        return DeviceColumn(data, None, T.INT64)
    if f in ("parse_url", "try_parse_url"):
        if not arg_exprs:
            raise PlanError(f"'{f}' does not support zero arguments")
        url = _lit(arg_exprs, 0)
        part = _lit(arg_exprs, 1)
        key = _lit(arg_exprs, 2, None)
        cap = args[0].data.shape[0]
        try:
            s = _parse_url_part(url, part, key)
        except PlanError:
            if f == "try_parse_url":
                return _null_strings(cap, dev)
            raise
        if s is None:
            return _null_strings(cap, dev)
        return _constant_string(cap, s, dev)
    if f in ("from_utc_timestamp", "to_utc_timestamp"):
        import datetime as _dt
        from zoneinfo import ZoneInfo

        tz = _lit(arg_exprs, 1)
        val = _lit(arg_exprs, 0)
        if tz is None or val is None:
            return DeviceColumn(torch.zeros(capacity, dtype=torch.int64, device=dev),
                                torch.zeros(capacity, dtype=torch.bool, device=dev),
                                T.TIMESTAMP)
        try:
            z = ZoneInfo(str(tz))
        except Exception as err:  # noqa: BLE001 - unknown tz name
            raise PlanError(f"unknown time zone {tz!r}") from err
        if isinstance(val, (int, np.integer)):
            us = int(val)
        else:
            s = str(val).strip().replace("T", " ")
            us = int(np.datetime64(s.replace(" ", "T"), "us").astype(np.int64))
        instant = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc) + \
            _dt.timedelta(microseconds=us)
        off = int(z.utcoffset(instant).total_seconds() * 1e6)
        us2 = us + off if f == "from_utc_timestamp" else us - off
        return DeviceColumn(torch.full((capacity,), us2, dtype=torch.int64, device=dev),
                            None, T.TIMESTAMP)
    if f == "make_dt_interval":
        d = [_lit(arg_exprs, i, 0) for i in range(4)]
        if any(x is None for x in d):
            return DeviceColumn(torch.zeros(capacity, dtype=torch.int64, device=dev),
                                torch.zeros(capacity, dtype=torch.bool, device=dev),
                                T.INTERVAL_US)
        days, hours, mins, secs = ([*d, 0, 0, 0, 0][:4])
        us = int(round((((float(days) * 24 + float(hours)) * 60
                         + float(mins)) * 60 + float(secs)) * 1e6))
        return DeviceColumn(torch.full((capacity,), us, dtype=torch.int64, device=dev),
                            None, T.INTERVAL_US)
    if f == "make_interval":
        d = [_lit(arg_exprs, i, 0) for i in range(7)]
        if any(x is None for x in d):
            return DeviceColumn(torch.zeros(capacity, dtype=torch.int64, device=dev),
                                torch.zeros(capacity, dtype=torch.bool, device=dev),
                                T.INTERVAL_US)
        y, mo, w, days, h, mi, s = ([*d, 0, 0, 0, 0, 0, 0, 0][:7])
        months = int(y) * 12 + int(mo)
        if len(arg_exprs) <= 2:
            return DeviceColumn(torch.full((capacity,), months, dtype=torch.int32,
                                           device=dev), None, T.INTERVAL_MONTHS)
        if months:
            raise PlanError("make_interval with both month and sub-month "
                            "parts is not representable")
        us = int(round(((((float(w) * 7 + float(days)) * 24 + float(h)) * 60
                         + float(mi)) * 60 + float(s)) * 1e6))
        return DeviceColumn(torch.full((capacity,), us, dtype=torch.int64, device=dev),
                            None, T.INTERVAL_US)

    raise PlanError(f"unknown spark function {f!r}")


def _parse_url_part(url, part, key):
    """Spark parse_url (spark/src/function/url/parse_url.rs): extract a
    component of a URL; invalid part name is an error, absent component is
    NULL."""
    from urllib.parse import parse_qs, urlsplit

    if url is None or part is None:
        return None
    s = str(url)
    if " " in s.strip() or "\t" in s:
        raise PlanError(f"parse_url: the url is invalid: {url}")
    try:
        u = urlsplit(s)
    except ValueError as err:
        raise PlanError(f"parse_url: the url is invalid: {url}") from err
    # part names are CASE-SENSITIVE (Spark): anything but the exact
    # uppercase keywords extracts nothing
    p = str(part)
    if p == "PROTOCOL":
        return u.scheme or None
    netloc = u.netloc
    host_port = netloc.rsplit("@", 1)[-1]
    if p == "HOST":
        if host_port.startswith("["):  # IPv6 literal keeps its brackets
            return host_port[:host_port.index("]") + 1] \
                if "]" in host_port else None
        return host_port.split(":")[0] or None
    if p == "PATH":
        return u.path
    if p == "QUERY":
        if key is not None:
            q = parse_qs(u.query, keep_blank_values=False)
            vals = q.get(str(key))
            return vals[0] if vals else None
        return u.query or None
    if p == "REF":
        return u.fragment or None
    if p == "FILE":
        return u.path + (f"?{u.query}" if u.query else "")
    if p == "AUTHORITY":
        return netloc or None
    if p == "USERINFO":
        ui = netloc.rsplit("@", 1)[0] if "@" in netloc else None
        return ui or None
    return None
