"""Vectorized civil-calendar math on epoch days (int32).

Port of datafusion_tpu/utils/dates.py. Branch-free integer algorithms
(Howard Hinnant's civil_from_days / days_from_civil). Every array function
takes torch tensors (any device) or numpy arrays and returns the same kind:
the optimizer folds `date + interval` literals on the host with numpy
(optimizer/simplify.py), the expression compiler calls the same functions on
device tensors."""
from __future__ import annotations

import numpy as np
import torch

_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _cast(x, dtype):
    """x as `dtype` ("int32"/"int64"), keeping its kind (tensor or ndarray)."""
    if isinstance(x, torch.Tensor):
        return x.to(getattr(torch, dtype))
    return np.asarray(x).astype(dtype)


def _where(cond, a, b):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return np.where(cond, a, b)


def civil_from_days(z):
    """days since 1970-01-01 -> (year, month, day), all int32 arrays."""
    z = _cast(z, "int64") + 719468
    era = _where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097  # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365  # [0, 399]
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
    mp = (5 * doy + 2) // 153  # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
    m = _where(mp < 10, mp + 3, mp - 9)  # [1, 12]
    y = _where(m <= 2, y + 1, y)
    return _cast(y, "int32"), _cast(m, "int32"), _cast(d, "int32")


def days_from_civil(y, m, d):
    y = _cast(y, "int64")
    m = _cast(m, "int64")
    d = _cast(d, "int64")
    y = _where(m <= 2, y - 1, y)
    era = _where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = _where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return _cast(era * 146097 + doe - 719468, "int32")


def add_months(days, months):
    """Calendar month addition with day clamping (SQL interval semantics)."""
    y, m, d = civil_from_days(days)
    if isinstance(y, torch.Tensor) and not isinstance(months, torch.Tensor):
        months = int(months)  # a scalar operand: no host-to-device copy
    else:
        months = _cast(months, "int64")
    tot = _cast(y, "int64") * 12 + (_cast(m, "int64") - 1) + months
    ny = _cast(tot // 12, "int32")
    nm = _cast(tot % 12, "int32") + 1
    # clamp day to target month length
    leap = ((ny % 4 == 0) & (ny % 100 != 0)) | (ny % 400 == 0)
    if isinstance(nm, torch.Tensor):
        # month lengths by arithmetic (31 for odd months up to July and even
        # ones from August, else 30; February 28 + leap): no table to copy
        maxd = torch.where(nm == 2, 28 + leap.to(torch.int32),
                           30 + (nm + nm // 8) % 2)
        nd = torch.minimum(d, maxd)
    else:
        mdays = np.array(_MONTH_DAYS, dtype=np.int32)
        maxd = mdays[nm - 1] + (leap & (nm == 2)).astype(np.int32)
        nd = np.minimum(d, maxd)
    return days_from_civil(ny, nm, nd)


def dates_from_strings(vals: np.ndarray) -> np.ndarray:
    """Vector of 'y-m-d' strings -> epoch days (int32), tolerating
    non-ISO-padded components ('1999-5-01')."""
    try:
        return vals.astype("datetime64[D]").astype(np.int32)
    except ValueError:
        return np.array([date_str_to_days(str(s)) for s in vals], np.int32)


def date_str_to_days(s: str) -> int:
    try:
        return int(np.datetime64(s, "D").astype(np.int32))
    except ValueError:
        # non-padded components ('1999-5-01') are valid SQL date literals;
        # numpy insists on ISO padding, so normalize y-m-d by hand
        y, m, d = (int(p) for p in s.strip().split("-"))
        return int(np.datetime64(f"{y:04d}-{m:02d}-{d:02d}", "D").astype(np.int32))


def time_str_to_us(s: str) -> int:
    """'HH:MM[:SS[.ffffff]]' -> microseconds since midnight (the TIME
    device representation; reference: Time64Microsecond). Out-of-range
    components are errors, as in the reference's cast."""
    parts = s.strip().split(":")
    h = int(parts[0])
    m = int(parts[1]) if len(parts) > 1 else 0
    sec = float(parts[2]) if len(parts) > 2 else 0.0
    if not (0 <= h <= 23 and 0 <= m <= 59 and 0 <= sec < 60):
        raise ValueError(f"invalid time {s!r}")
    return int(round(((h * 60 + m) * 60 + sec) * 1_000_000))


def times_from_strings(vals: np.ndarray) -> np.ndarray:
    return np.array([time_str_to_us(str(v)) for v in vals], dtype=np.int64)


def us_to_time_str(us: int) -> str:
    us = int(us)
    s, frac = divmod(us, 1_000_000)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    out = f"{h:02d}:{m:02d}:{sec:02d}"
    if frac:
        out += f".{frac:06d}".rstrip("0")
    return out
