# Verbatim copy of datafusion_tpu/spark/javafmt.py; host-only, kept in step with the original.
"""Java-style `String.format` engine for Spark's format_string.

Reference: datafusion/spark/src/function/string/format_string.rs (which
matches java.util.Formatter for %b %s %c %d %o %x %e %f %g %a and the %t
date/time suite, with C-style trailing-zero stripping on %g). Host-side
pure-Python: format_string arguments are constants in practice (the gold
corpus), and string minting is host work in this engine anyway.
"""
from __future__ import annotations

import datetime as _dt
import re
from typing import List, Optional, Tuple


class JavaFormatError(ValueError):
    pass


class RawTemporal:
    """A temporal value that keeps its raw epoch integer: Spark's %s of an
    arrow-cast numeric timestamp/date prints the raw number, while %t*
    conversions see the calendar value."""

    __slots__ = ("raw", "dt")

    def __init__(self, raw: int, dt):
        self.raw = raw
        self.dt = dt

    def __str__(self):
        return str(self.raw)


_DIRECTIVE = re.compile(
    r"%(?:(\d+)\$|(<))?([-#+ 0,(]*)(\d+)?(?:\.(\d+))?([a-zA-Z%])")

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_DAYS = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday",
         "Sunday"]


def _check_flags(flags: str, conv: str, width, prec):
    if len(set(flags)) != len(flags):
        raise JavaFormatError(f"duplicate flags in %{flags}{conv}")
    if "+" in flags and " " in flags:
        raise JavaFormatError("the '+' and ' ' flags are incompatible")
    if "-" in flags and "0" in flags:
        raise JavaFormatError("the '-' and '0' flags are incompatible")
    if "-" in flags and width is None:
        raise JavaFormatError("'-' flag requires a width")
    if "0" in flags and width is None:
        raise JavaFormatError("'0' flag requires a width")
    if "(" in flags and conv not in "doxX":
        raise JavaFormatError(f"'(' flag invalid for %{conv}")
    if "," in flags and conv not in "defgEFG":
        raise JavaFormatError(f"',' flag invalid for %{conv}")


def _pad(s: str, width: Optional[int], left: bool, zero: bool = False) -> str:
    if width is None or len(s) >= width:
        return s
    if left:
        return s + " " * (width - len(s))
    if zero:
        sign = ""
        if s and s[0] in "+- ":
            sign, s = s[0], s[1:]
        return sign + "0" * (width - len(s) - len(sign)) + s
    return " " * (width - len(s)) + s


def _hex_float(v: float, prec: Optional[int]) -> str:
    """Hex-float body of abs(v) without the 0x prefix or sign, Java %a
    style: minimal digits by default; with a precision the mantissa is
    normalized (even for subnormals) and rounded half-up to max(prec, 1)
    hex digits."""
    av = abs(float(v))
    if av == 0.0:
        frac = "0" * max(prec, 1) if prec is not None else "0"
        return f"0.{frac}p0"
    h = av.hex()  # '0x1.fe00000000000p+3' or subnormal '0x0.0001p-1022'
    mant, _, exp_s = h[2:].partition("p")
    exp = int(exp_s)
    head, _, digits = mant.partition(".")
    if prec is None:
        return f"{head}.{digits.rstrip('0') or '0'}p{exp}"
    p = max(prec, 1)
    nd = len(digits)
    big = (int(head, 16) << (4 * nd)) | int(digits or "0", 16)
    # normalize so the integer part is exactly 1 (subnormals shift up)
    while big < (1 << (4 * nd)):
        big <<= 1
        exp -= 1
    while big >= (2 << (4 * nd)):  # defensive; head is 0 or 1 from hex()
        big >>= 1
        exp += 1
    if p < nd:
        shift = 4 * (nd - p)
        rem = big & ((1 << shift) - 1)
        big >>= shift
        if rem * 2 >= (1 << shift):  # half-up
            big += 1
            if big >= (2 << (4 * p)):
                big >>= 1
                exp += 1
        nd = p
    frac_int = big & ((1 << (4 * nd)) - 1)
    digits = format(frac_int, f"0{nd}x") if nd else ""
    return f"1.{digits.ljust(p, '0')}p{exp}"


def _as_datetime(v) -> _dt.datetime:
    if isinstance(v, RawTemporal):
        v = v.dt
    if isinstance(v, bool):
        raise JavaFormatError("%t requires a date/time argument")
    if isinstance(v, _dt.datetime):
        return v
    if isinstance(v, _dt.date):
        return _dt.datetime(v.year, v.month, v.day)
    if isinstance(v, (int, float)):
        return (_dt.datetime(1970, 1, 1)
                + _dt.timedelta(microseconds=int(v)))
    s = str(v)
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
                "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d"):
        try:
            return _dt.datetime.strptime(s[:26], fmt)
        except ValueError:
            continue
    raise JavaFormatError(f"cannot interpret {v!r} as a date/time")


def _time_conv(suffix: str, t: _dt.datetime) -> str:
    h12 = t.hour % 12 or 12
    epoch = (t - _dt.datetime(1970, 1, 1)).total_seconds()
    if suffix == "H":
        return f"{t.hour:02d}"
    if suffix == "I":
        return f"{h12:02d}"
    if suffix == "k":
        return str(t.hour)
    if suffix == "l":
        return str(h12)
    if suffix == "M":
        return f"{t.minute:02d}"
    if suffix == "S":
        return f"{t.second:02d}"
    if suffix == "L":
        return f"{t.microsecond // 1000:03d}"
    if suffix == "N":
        return f"{t.microsecond * 1000:09d}"
    if suffix == "p":
        return "am" if t.hour < 12 else "pm"
    if suffix == "z":
        return "+0000"
    if suffix == "Z":
        return "UTC"
    if suffix == "s":
        return str(int(epoch))
    if suffix == "Q":
        return str(int(epoch * 1000))
    if suffix == "B":
        return _MONTHS[t.month - 1]
    if suffix in ("b", "h"):
        return _MONTHS[t.month - 1][:3]
    if suffix == "A":
        return _DAYS[t.weekday()]
    if suffix == "a":
        return _DAYS[t.weekday()][:3]
    if suffix == "C":
        return f"{t.year // 100:02d}"
    if suffix == "Y":
        return f"{t.year:04d}"
    if suffix == "y":
        return f"{t.year % 100:02d}"
    if suffix == "j":
        return f"{t.timetuple().tm_yday:03d}"
    if suffix == "m":
        return f"{t.month:02d}"
    if suffix == "d":
        return f"{t.day:02d}"
    if suffix == "e":
        return str(t.day)
    if suffix == "R":
        return f"{t.hour:02d}:{t.minute:02d}"
    if suffix == "T":
        return f"{t.hour:02d}:{t.minute:02d}:{t.second:02d}"
    if suffix == "r":
        ampm = "AM" if t.hour < 12 else "PM"
        return f"{h12:02d}:{t.minute:02d}:{t.second:02d} {ampm}"
    if suffix == "D":
        return f"{t.month:02d}/{t.day:02d}/{t.year % 100:02d}"
    if suffix == "F":
        return f"{t.year:04d}-{t.month:02d}-{t.day:02d}"
    if suffix == "c":
        return (f"{_DAYS[t.weekday()][:3]} {_MONTHS[t.month - 1][:3]} "
                f"{t.day:02d} {t.hour:02d}:{t.minute:02d}:{t.second:02d} "
                f"UTC {t.year:04d}")
    raise JavaFormatError(f"unknown time conversion suffix %t{suffix}")


def _render_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "Infinity"
        if v == float("-inf"):
            return "-Infinity"
        s = repr(v)
        return s
    return str(v)


def _int_arg(v, conv: str) -> int:
    if isinstance(v, bool) or not isinstance(v, int):
        raise JavaFormatError(f"%{conv} requires an integer argument, "
                              f"got {v!r}")
    return v


def java_format(fmt: str, args: List) -> str:
    """Format `fmt` with `args` following java.util.Formatter semantics
    (with C-style %g). Raises JavaFormatError on invalid directives or
    argument types — those surface as query errors like the reference."""
    out = []
    pos = 0
    next_idx = 0
    last_idx: Optional[int] = None
    n = len(fmt)
    while pos < n:
        ch = fmt[pos]
        if ch != "%":
            out.append(ch)
            pos += 1
            continue
        m = _DIRECTIVE.match(fmt, pos)
        if not m:
            raise JavaFormatError(
                f"invalid format directive at {pos} in {fmt!r}")
        argn, prev, flags, width_s, prec_s, conv = m.groups()
        pos = m.end()
        width = int(width_s) if width_s else None
        prec = int(prec_s) if prec_s is not None else None
        left = "-" in flags
        zero = "0" in flags
        if conv == "%":
            out.append("%")
            continue
        if conv == "n":
            if flags or width is not None or prec is not None:
                raise JavaFormatError("%n takes no flags, width or precision")
            out.append("\n")
            continue
        suffix = None
        if conv in ("t", "T"):
            if pos >= n:
                raise JavaFormatError("%t needs a conversion suffix")
            suffix = fmt[pos]
            pos += 1
        _check_flags(flags, conv, width, prec)
        upper = conv.isupper()
        # ---- resolve the argument ------------------------------------
        if prev:
            if last_idx is None:
                raise JavaFormatError("'<' with no previous argument")
            idx = last_idx
        elif argn is not None:
            idx = int(argn) - 1
        else:
            idx = next_idx
            next_idx += 1
        last_idx = idx
        if not 0 <= idx < len(args):
            raise JavaFormatError(
                f"format directive references argument {idx + 1} but only "
                f"{len(args)} supplied")
        v = args[idx]
        # ---- null ----------------------------------------------------
        if v is None:
            if conv in ("b", "B"):
                s = "false"
            else:
                s = "null"
            if upper:
                s = s.upper()
            if prec is not None:
                s = s[:prec]
            out.append(_pad(s, width, left))
            continue
        c = conv.lower()
        if c == "b":
            if not isinstance(v, bool):
                raise JavaFormatError("%b requires a boolean argument")
            s = "true" if v else "false"
        elif c == "s" or c == "h":
            s = _render_str(v)
            if c == "h":
                s = format(abs(hash(s)) & 0xFFFFFFFF, "x")
            if prec is not None:
                s = s[:prec]
        elif c == "c":
            if isinstance(v, bool):
                raise JavaFormatError("%c requires a character argument")
            if isinstance(v, int):
                if v < 0 or v > 0x10FFFF:
                    raise JavaFormatError(f"%c: invalid codepoint {v}")
                s = chr(v)
            elif isinstance(v, str) and len(v) == 1:
                s = v
            else:
                raise JavaFormatError(f"%c: invalid argument {v!r}")
        elif c == "d":
            iv = _int_arg(v, conv)
            body = format(abs(iv), "," if "," in flags else "d")
            if iv < 0:
                s = f"({body})" if "(" in flags else f"-{body}"
            else:
                s = ("+" if "+" in flags else
                     " " if " " in flags else "") + body
        elif c in ("o", "x"):
            iv = _int_arg(v, conv)
            if iv < 0:
                iv &= 0xFFFFFFFFFFFFFFFF  # two's-complement like Java long
            s = format(iv, "o" if c == "o" else "x")
            if "#" in flags:
                s = ("0" if c == "o" else "0x") + s
        elif c in ("e", "f", "g"):
            fv = float(v)
            p = prec if prec is not None else 6
            spec = "%"
            spec += "+" if "+" in flags else " " if " " in flags else ""
            spec += "#" if "#" in flags else ""
            s = (spec + f".{p}{c}") % fv
            if "," in flags:
                # group the integer part
                mm = re.match(r"([+\- ]?)(\d+)(.*)", s)
                if mm:
                    sign, digits, rest = mm.groups()
                    s = sign + format(int(digits), ",") + rest
        elif c == "a":
            fv = float(v)
            if fv != fv or fv in (float("inf"), float("-inf")):
                s = {float("inf"): "Infinity",
                     float("-inf"): "-Infinity"}.get(fv, "NaN")
            else:
                body = _hex_float(fv, prec)
                sign = ("-" if fv < 0 else "+" if "+" in flags
                        else " " if " " in flags else "")
                s = f"{sign}0x{body}"
                if upper:
                    s = s.upper().replace("0X", "0X")
                if zero and width is not None and len(s) < width:
                    # zero padding goes between '0x' and the mantissa
                    i = s.index("x" if not upper else "X") + 1
                    s = s[:i] + "0" * (width - len(s)) + s[i:]
                out.append(_pad(s, width, left))
                continue
        elif c == "t":
            s = _time_conv(suffix, _as_datetime(v))
            if conv == "T" and suffix not in ("z",):
                s = s.upper()
        else:
            raise JavaFormatError(f"unknown conversion %{conv}")
        if upper and c in ("s", "h", "b", "c", "x", "e", "g", "a"):
            s = s.upper()
        out.append(_pad(s, width, left, zero=zero))
    return "".join(out)
