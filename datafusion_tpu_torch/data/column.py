# Verbatim copy of datafusion_tpu/data/column.py; host-only, kept in step with the original.
"""Host-side columnar data: dictionaries and columns.

Capability analog of Arrow arrays as the reference uses them
(datafusion/common/src/scalar/mod.rs value model; ArrowBytesMap string
interning, physical-expr-common/src/binary_map.rs:210), designed for the TPU
data layout:

* every column is a fixed-width numpy array in the *device representation*
  of its logical type (common/types.py) plus an optional validity mask;
* string columns are dictionary-encoded with a SORTED dictionary, so the
  int32 codes are order-preserving (string comparisons / sorts / group-bys
  on device never touch bytes);
* decimals are scaled int64 (exact arithmetic);
* list values are object arrays of Python lists of element device-rep
  scalars (None = NULL element); the device layout pads them to a static
  max width (data/device.py).
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common import types as T


class Dictionary:
    """Sorted distinct string values of a dictionary-encoded column.

    Identity (default object hash/eq) is load-bearing: dictionaries ride
    along as STATIC pytree aux data on device columns, so two columns share
    compiled programs iff they share the same dictionary object."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = np.asarray(values, dtype=object)

    @property
    def size(self) -> int:
        return int(len(self.values))

    def __len__(self) -> int:
        return int(len(self.values))

    def __repr__(self) -> str:
        head = ", ".join(repr(v) for v in self.values[:3])
        more = "..." if len(self.values) > 3 else ""
        return f"Dictionary[{self.size}]({head}{more})"


def is_bytes_values(values) -> bool:
    for v in values:
        if v is not None:
            return isinstance(v, (bytes, np.bytes_))
    return False


def sort_unique_bytes(vals):
    """(sorted unique list, code per input) for bytes values. numpy's "S"
    dtype silently drops trailing NUL bytes (C-string semantics), so BINARY
    dictionaries sort/dedupe with Python bytes ordering instead."""
    uniq = sorted({bytes(v) for v in vals})
    lut = {v: i for i, v in enumerate(uniq)}
    codes = np.fromiter((lut[bytes(v)] for v in vals), dtype=np.int32,
                        count=len(vals))
    return uniq, codes


def as_text_array(values) -> np.ndarray:
    """Fixed-width numpy "U" view of dictionary values. Only valid for str
    values — bytes must go through sort_unique_bytes (numpy "S" truncates
    trailing NULs)."""
    return np.asarray(values, dtype="U")


def encode_strings(values: np.ndarray,
                   validity: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Dictionary]:
    """Dictionary-encode an object array of strings (None = NULL).

    Returns (codes int32, validity or None, sorted Dictionary). Codes are
    order-preserving; NULL rows get code 0."""
    n = len(values)
    if validity is None:
        nulls = np.array([v is None for v in values], dtype=bool)
        validity = ~nulls if nulls.any() else None
    if validity is not None:
        live = np.asarray(validity)
        vals = values[live]
    else:
        live = None
        vals = values
    if len(vals) == 0:
        return (np.zeros(n, dtype=np.int32), validity,
                Dictionary(np.array([], dtype=object)))
    if is_bytes_values(vals):
        buniq, bcodes = sort_unique_bytes(vals)
        codes = np.zeros(n, dtype=np.int32)
        if live is None:
            codes[:] = bcodes
        else:
            codes[live] = bcodes
        return codes, validity, Dictionary(np.array(buniq, dtype=object))
    u = as_text_array(vals)
    uniq, inv = np.unique(u, return_inverse=True)
    codes = np.zeros(n, dtype=np.int32)
    if live is None:
        codes[:] = inv.astype(np.int32)
    else:
        codes[live] = inv.astype(np.int32)
    return codes, validity, Dictionary(uniq.astype(object))


def encode_arrow_strings(arr) -> Tuple[np.ndarray, Optional[np.ndarray], Dictionary]:
    """Dictionary-encode a pyarrow string array, preferring the native C++
    interning encoder (datafusion_tpu/native/dictenc.cpp) for null-free
    arrays; numpy fallback otherwise."""
    import pyarrow as pa

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if arr.null_count == 0:
        from ..native import dict_encode_arrow

        out = dict_encode_arrow(arr)
        if out is not None:
            codes, vals = out
            return codes, None, Dictionary(vals)
    validity = np.asarray(arr.is_valid())
    if validity.all():
        validity = None
    vals = np.asarray(arr.to_numpy(zero_copy_only=False), dtype=object)
    return encode_strings(vals, validity)


class HostColumn:
    """One column on the host: device-representation data + validity +
    (strings) dictionary."""

    __slots__ = ("dtype", "data", "validity", "dictionary")

    def __init__(self, dtype: T.DataType, data: np.ndarray,
                 validity: Optional[np.ndarray] = None,
                 dictionary: Optional[Dictionary] = None):
        self.dtype = dtype
        self.data = np.asarray(data)
        self.validity = None if validity is None else np.asarray(validity, dtype=bool)
        self.dictionary = dictionary

    def __len__(self) -> int:
        return int(len(self.data))

    def valid_mask(self) -> np.ndarray:
        if self.validity is not None:
            return self.validity
        return np.ones(len(self.data), dtype=bool)

    def take(self, idx: np.ndarray) -> "HostColumn":
        v = None if self.validity is None else self.validity[idx]
        return HostColumn(self.dtype, self.data[idx], v, self.dictionary)

    def remap_dictionary(self, shared: Dictionary) -> "HostColumn":
        """Re-encode onto `shared` (a sorted superset of this column's
        dictionary); codes stay order-preserving."""
        if self.dictionary is shared:
            return self
        ownvals = (list(self.dictionary.values)
                   if self.dictionary is not None else [])
        if len(ownvals) == 0:
            return HostColumn(self.dtype, np.zeros_like(self.data),
                              self.validity, shared)
        if is_bytes_values(shared.values):
            lut = {bytes(v): i for i, v in enumerate(shared.values)}
            mapping = np.array([lut.get(bytes(v), 0) for v in ownvals],
                               dtype=np.int32)
        else:
            tgt = as_text_array(shared.values)
            own = as_text_array(ownvals)
            mapping = np.searchsorted(tgt, own).astype(np.int32)
        mapping = np.clip(mapping, 0, max(len(tgt) - 1, 0))
        codes = mapping[np.clip(self.data, 0, len(mapping) - 1)]
        return HostColumn(self.dtype, codes.astype(np.int32), self.validity,
                          shared)

    def to_numpy_logical(self) -> np.ndarray:
        """Logical (decoded) values; object array with None where NULL when
        the column is nullable or string-typed."""
        t = self.dtype
        if t.is_string:
            d = self.dictionary
            vals = (np.asarray(d.values, dtype=object) if d is not None
                    else np.array([], dtype=object))
            out = np.empty(len(self.data), dtype=object)
            if len(vals):
                out[:] = vals[np.clip(self.data, 0, len(vals) - 1)]
            else:
                out[:] = None
            if self.validity is not None:
                out[~self.validity] = None
            return out
        if t.is_decimal:
            out = self.data.astype(np.float64) / (10.0 ** t.scale)
        elif t.kind is T.TypeKind.DATE32:
            out = self.data.astype("datetime64[D]")
        elif t.kind is T.TypeKind.TIMESTAMP:
            out = self.data.astype("datetime64[us]")
        elif t.kind is T.TypeKind.TIME:
            import datetime as _dt

            base = _dt.datetime(1970, 1, 1)
            out = np.array([(base + _dt.timedelta(microseconds=int(v))).time()
                            for v in self.data], dtype=object)
        else:
            out = self.data
        if self.validity is not None:
            obj = out.astype(object)
            obj[~self.validity] = None
            return obj
        return out


# ---------------------------------------------------------------------------
# construction from Python values
# ---------------------------------------------------------------------------

_EPOCH_D = np.datetime64("1970-01-01", "D")
_EPOCH_US = np.datetime64("1970-01-01", "us")


def _date_days(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.datetime64):
        return int((v.astype("datetime64[D]") - _EPOCH_D).astype(np.int64))
    if isinstance(v, datetime.datetime):
        v = v.date()
    if isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    return int((np.datetime64(str(v), "D") - _EPOCH_D).astype(np.int64))


def _ts_micros(v) -> int:
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, np.datetime64):
        return int((v.astype("datetime64[us]") - _EPOCH_US).astype(np.int64))
    if isinstance(v, datetime.datetime):
        return _ts_micros(np.datetime64(v))
    if isinstance(v, datetime.date):
        return _date_days(v) * 86_400_000_000
    return int((np.datetime64(str(v), "us") - _EPOCH_US).astype(np.int64))


def _infer_scalar_type(v) -> Optional[T.DataType]:
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return T.BOOL
    if isinstance(v, (int, np.integer)):
        return T.INT64
    if isinstance(v, (float, np.floating)):
        return T.FLOAT64
    if isinstance(v, str):
        return T.STRING
    if isinstance(v, (bytes, bytearray, np.bytes_)):
        return T.BINARY
    if isinstance(v, np.datetime64):
        return T.TIMESTAMP
    if isinstance(v, datetime.datetime):
        return T.TIMESTAMP
    if isinstance(v, datetime.date):
        return T.DATE32
    if isinstance(v, dict):
        # python dicts ingest as STRUCT rows (pyarrow infers the same);
        # build a map with T.map_of via an explicit types= override
        fields = []
        for n, x in v.items():
            fields.append((str(n), _infer_scalar_type(x) or T.INT64))
        return T.struct(fields)
    if isinstance(v, (list, tuple, np.ndarray)):
        elem = None
        for x in v:
            elem = _infer_scalar_type(x)
            if elem is not None:
                break
        return T.list_of(elem or T.INT64)
    raise TypeError(f"cannot infer column type from {type(v)}")


def _infer_type(values) -> T.DataType:
    if isinstance(values, np.ndarray) and values.dtype != object:
        dt = values.dtype
        if dt == np.bool_:
            return T.BOOL
        if dt == np.int8:
            return T.INT8
        if dt == np.int16:
            return T.INT16
        if dt == np.int32:
            return T.INT32
        if np.issubdtype(dt, np.integer):
            return T.INT64
        if dt == np.float32:
            return T.FLOAT32
        if np.issubdtype(dt, np.floating):
            return T.FLOAT64
        if np.issubdtype(dt, np.datetime64):
            if dt == np.dtype("datetime64[D]"):
                return T.DATE32
            return T.TIMESTAMP
        raise TypeError(f"cannot infer column type from dtype {dt}")
    # dicts: equal key sets across rows -> STRUCT; varying -> MAP
    dicts = [v for v in values if isinstance(v, dict)]
    if dicts:
        keysets = {tuple(sorted(map(str, d.keys()))) for d in dicts}
        if len(keysets) > 1:
            kt = vt = None
            for d in dicts:
                for k, x in d.items():
                    kt = kt or _infer_scalar_type(k)
                    vt = vt or _infer_scalar_type(x)
            return T.map_of(kt or T.STRING, vt or T.INT64)
    for v in values:
        t = _infer_scalar_type(v)
        if t is not None:
            return t
    return T.INT64  # all-NULL column


def column_from_values(values, dtype: Optional[T.DataType] = None) -> HostColumn:
    """Build a HostColumn from Python/numpy values (None = NULL), inferring
    the logical type unless `dtype` is given."""
    if dtype is None:
        dtype = _infer_type(values)

    if isinstance(values, np.ndarray) and values.dtype != object \
            and not np.issubdtype(values.dtype, np.datetime64) \
            and not dtype.is_list and not dtype.is_string:
        data = values
        if dtype.is_decimal and np.issubdtype(values.dtype, np.floating):
            data = np.rint(values * 10 ** dtype.scale).astype(np.int64)
        elif data.dtype != dtype.np_dtype():
            data = data.astype(dtype.np_dtype())
        return HostColumn(dtype, data)

    vals = list(values)
    n = len(vals)
    nulls = np.array([v is None or (isinstance(v, float) and np.isnan(v)
                                    and not dtype.is_float)
                      for v in vals], dtype=bool)
    validity = ~nulls if nulls.any() else None

    if dtype.is_binary:
        obj = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            obj[i] = None if nulls[i] else bytes(v)
        codes, validity, d = encode_strings(obj, validity)
        return HostColumn(dtype, codes, validity, d)

    if dtype.is_string:
        obj = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            obj[i] = None if nulls[i] else str(v)
        codes, validity, d = encode_strings(obj, validity)
        return HostColumn(dtype, codes, validity, d)

    if dtype.is_list:
        obj = np.empty(n, dtype=object)
        elem = dtype.elem
        d: Optional[Dictionary] = None
        if elem.is_string:
            # encode all elements against one shared dictionary
            flat = sorted({str(x) for v in vals if v is not None
                           for x in v if x is not None})
            d = Dictionary(np.array(flat, dtype=object))
            lut = {s: i for i, s in enumerate(flat)}
            for i, v in enumerate(vals):
                obj[i] = (None if v is None else
                          [None if x is None else lut[str(x)] for x in v])
        else:
            for i, v in enumerate(vals):
                obj[i] = (None if v is None else
                          [None if x is None else _coerce_elem(x, elem)
                           for x in v])
        return HostColumn(dtype, obj, validity, d)

    if dtype.is_struct or dtype.is_map:
        codes, d = _encode_opaque(vals, nulls, dtype)
        return HostColumn(dtype, codes, validity, d)

    data = np.zeros(n, dtype=dtype.np_dtype())
    for i, v in enumerate(vals):
        if nulls[i]:
            continue
        data[i] = _coerce_elem(v, dtype)
    return HostColumn(dtype, data, validity)


def _none_safe_key(x):
    """Total order over logical values including None and nested pairs."""
    if x is None:
        return (0,)
    if isinstance(x, tuple):
        return (2,) + tuple(_none_safe_key(e) for e in x)
    if isinstance(x, bool):
        return (1, "b", int(x))
    if isinstance(x, (int, float)):
        return (1, "n", float(x), 0 if isinstance(x, int) else 1)
    return (1, "s", str(x))


def _canon_struct(v, dtype: T.DataType):
    """Canonical value tuple for one struct/map row."""
    if dtype.is_struct:
        if isinstance(v, dict):
            return tuple(v.get(n) for n, _t in dtype.fields)
        return tuple(v)  # positional tuple/list
    items = v.items() if isinstance(v, dict) else v
    return tuple(sorted(((k, x) for k, x in items),
                        key=lambda kv: _none_safe_key(kv[0])))


def _encode_opaque(vals, nulls, dtype: T.DataType):
    """Struct/map rows -> order-preserving int32 codes into a SORTED
    dictionary of canonical value tuples (the string-column encoding scheme
    generalized to composite values; codes group/sort/compare like any
    dictionary column)."""
    rows = [None if nulls[i] else _canon_struct(v, dtype)
            for i, v in enumerate(vals)]
    distinct = sorted({r for r in rows if r is not None}, key=_none_safe_key)
    lut = {r: i for i, r in enumerate(distinct)}
    codes = np.zeros(len(rows), dtype=np.int32)
    for i, r in enumerate(rows):
        if r is not None:
            codes[i] = lut[r]
    dvals = np.empty(len(distinct), dtype=object)
    for i, r in enumerate(distinct):
        dvals[i] = r
    return codes, Dictionary(dvals)


def _coerce_elem(v, dtype: T.DataType):
    if dtype.is_list:
        # nested list element (List(List(..)) ingestion)
        return None if v is None else [
            None if x is None else _coerce_elem(x, dtype.elem) for x in v]
    if dtype.is_decimal:
        return int(round(float(v) * 10 ** dtype.scale))
    if dtype.kind is T.TypeKind.DATE32:
        return _date_days(v)
    if dtype.kind is T.TypeKind.TIMESTAMP:
        return _ts_micros(v)
    if dtype.kind is T.TypeKind.TIME:
        import datetime

        if isinstance(v, datetime.time):
            return ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 \
                + v.microsecond
        if isinstance(v, str):
            from ..utils.dates import time_str_to_us

            return time_str_to_us(v)
        return int(v)
    if dtype.kind is T.TypeKind.BOOL:
        return bool(v)
    if dtype.is_integer or dtype.kind in (T.TypeKind.INTERVAL_DAYS,
                                          T.TypeKind.INTERVAL_MONTHS):
        return int(v)
    if dtype.is_float:
        return float(v)
    raise TypeError(f"cannot coerce {v!r} to {dtype}")
