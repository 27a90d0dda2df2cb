# Verbatim copy of datafusion_tpu/data/table.py; host-only, kept in step with the original.
"""Host Table: an ordered set of named HostColumns with a Schema.

Capability analog of Arrow's RecordBatch/Table as the reference consumes it
(datafusion/common/src/dfschema.rs + arrow interop): construction from
pydicts / pandas / Arrow, conversion back out, concatenation with dictionary
merging, and parquet/CSV writers (reference: DataSink writers,
datasource/src/sink.rs)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Field, Schema
from .column import (Dictionary, HostColumn, column_from_values,
                     encode_arrow_strings)


class Table:
    __slots__ = ("schema", "columns")

    def __init__(self, schema: Schema, columns: Sequence[HostColumn]):
        self.schema = schema
        self.columns = list(columns)

    # ---- introspection ----------------------------------------------------
    @property
    def num_rows(self) -> int:
        return int(len(self.columns[0].data)) if self.columns else 0

    def column(self, name: str) -> HostColumn:
        return self.columns[self.schema.index_of(name)]

    def __repr__(self) -> str:
        return f"Table[{self.num_rows} rows, {self.schema!r}]"

    # ---- construction -----------------------------------------------------
    @classmethod
    def from_pydict(cls, data: Dict, types: Optional[Dict[str, T.DataType]] = None
                    ) -> "Table":
        types = types or {}
        fields, cols = [], []
        for name, values in data.items():
            col = column_from_values(values, types.get(name))
            fields.append(Field(name, col.dtype,
                                nullable=col.validity is not None))
            cols.append(col)
        return cls(Schema(fields), cols)

    @classmethod
    def from_pandas(cls, df) -> "Table":
        import pyarrow as pa

        return cls.from_arrow(pa.Table.from_pandas(df, preserve_index=False))

    @classmethod
    def from_arrow(cls, at) -> "Table":
        import pyarrow as pa

        fields, cols = [], []
        for i, f in enumerate(at.schema):
            arr = at.column(i)
            if isinstance(arr, pa.ChunkedArray):
                arr = arr.combine_chunks()
            col = _column_from_arrow(arr, f.type)
            fields.append(Field(f.name, col.dtype,
                                nullable=col.validity is not None or f.nullable))
            cols.append(col)
        return cls(Schema(fields), cols)

    @classmethod
    def concat(cls, tables: List["Table"]) -> "Table":
        """Concatenate tables sharing a schema; string columns with differing
        dictionaries are remapped onto a merged sorted dictionary."""
        if not tables:
            raise PlanError("concat of no tables")
        if len(tables) == 1:
            return tables[0]
        base = tables[0]
        cols = []
        for i, f in enumerate(base.schema.fields):
            chunk_cols = [t.columns[i] for t in tables]
            if f.dtype.is_string:
                dicts = {id(c.dictionary) for c in chunk_cols}
                if len(dicts) > 1:
                    vals = sorted(set().union(*(
                        set(np.asarray(c.dictionary.values, dtype="U"))
                        for c in chunk_cols if c.dictionary is not None)))
                    shared = Dictionary(np.array(vals, dtype=object))
                    chunk_cols = [c.remap_dictionary(shared) for c in chunk_cols]
            data = np.concatenate([c.data for c in chunk_cols])
            validity = None
            if any(c.validity is not None for c in chunk_cols):
                validity = np.concatenate([c.valid_mask() for c in chunk_cols])
            cols.append(HostColumn(f.dtype, data, validity,
                                   chunk_cols[0].dictionary))
        return cls(base.schema, cols)

    # ---- transforms ---------------------------------------------------------
    def take(self, idx) -> "Table":
        idx = np.asarray(idx)
        return Table(self.schema, [c.take(idx) for c in self.columns])

    # ---- conversion out ----------------------------------------------------
    def to_pydict(self) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for f, c in zip(self.schema.fields, self.columns):
            out[f.name] = _to_pylist(f.dtype, c)
        return out

    def to_pandas(self):
        import pandas as pd

        # positional construction: duplicate output names are legal SQL
        # (e.g. TPC-DS q64 selects cs1.syear and cs2.syear unaliased) and a
        # dict would silently collapse them
        series = [_to_pandas_series(f.dtype, c)
                  for f, c in zip(self.schema.fields, self.columns)]
        if not series:
            return pd.DataFrame()
        df = pd.concat(series, axis=1, keys=range(len(series)))
        df.columns = [f.name for f in self.schema.fields]
        return df

    def to_arrow(self):
        import pyarrow as pa

        arrays, names = [], []
        for f, c in zip(self.schema.fields, self.columns):
            arrays.append(_to_arrow_array(f.dtype, c))
            names.append(f.name)
        if not arrays:
            return pa.table({})
        return pa.table(dict(zip(names, arrays)))

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        # page index + bloom filters power the scan's pruning ladder
        # (io/parquet.plan_units: stats -> bloom -> page index)
        pq.write_table(self.to_arrow(), path, write_page_index=True)

    def write_csv(self, path: str) -> None:
        import pyarrow.csv as pcsv

        pcsv.write_csv(self.to_arrow(), path)


# ---------------------------------------------------------------------------
# arrow -> host column
# ---------------------------------------------------------------------------


def _arrow_validity(arr) -> Optional[np.ndarray]:
    if arr.null_count == 0:
        return None
    return np.asarray(arr.is_valid())


def _column_from_arrow(arr, at) -> HostColumn:
    import pyarrow as pa
    import pyarrow.types as pt

    if pt.is_struct(at):
        from ..common import types as _T

        fields = [(f.name, _arrow_scalar_dtype(f.type)) for f in at]
        return column_from_values(arr.to_pylist(), _T.struct(fields))
    if pt.is_map(at):
        from ..common import types as _T

        dt = _T.map_of(_arrow_scalar_dtype(at.key_type),
                       _arrow_scalar_dtype(at.item_type))
        return column_from_values(arr.to_pylist(), dt)

    if pt.is_dictionary(at):
        arr = arr.cast(at.value_type)
        at = at.value_type
    if pt.is_null(at):
        n = len(arr)
        return HostColumn(T.INT32, np.zeros(n, np.int32),
                          np.zeros(n, dtype=bool))
    if pt.is_string(at) or pt.is_large_string(at):
        codes, validity, d = encode_arrow_strings(
            arr.cast(pa.string()) if pt.is_large_string(at) else arr)
        return HostColumn(T.STRING, codes, validity, d)
    if pt.is_binary(at) or pt.is_large_binary(at) \
            or pt.is_fixed_size_binary(at):
        from .column import encode_strings

        vals = np.asarray([None if x is None else bytes(x)
                           for x in arr.to_pylist()], dtype=object)
        codes, validity, d = encode_strings(vals)
        return HostColumn(T.BINARY, codes, validity, d)
    if pt.is_boolean(at):
        v = _arrow_validity(arr)
        data = np.asarray(arr.fill_null(False)) if v is not None else np.asarray(arr)
        return HostColumn(T.BOOL, data.astype(np.bool_), v)
    if pt.is_integer(at):
        dtype = {8: T.INT8, 16: T.INT16, 32: T.INT32}.get(at.bit_width, T.INT64)
        if pt.is_unsigned_integer(at):
            dtype = T.INT64
        v = _arrow_validity(arr)
        a = arr.fill_null(0) if v is not None else arr
        data = np.asarray(a.cast(pa.int64() if dtype is T.INT64 else pa.int32()))
        return HostColumn(dtype, data.astype(dtype.np_dtype()), v)
    if pt.is_floating(at):
        dtype = T.FLOAT32 if at == pa.float32() else T.FLOAT64
        data = np.asarray(arr.cast(pa.float64() if dtype is T.FLOAT64
                                   else pa.float32()).to_numpy(zero_copy_only=False))
        return HostColumn(dtype, data.astype(dtype.np_dtype()),
                          _arrow_validity(arr))
    if pt.is_decimal(at):
        dtype = T.decimal(at.precision, at.scale)
        v = _arrow_validity(arr)
        if at.precision <= 15:
            a = arr.fill_null(0) if v is not None else arr
            f = np.asarray(a.cast(pa.float64(), safe=False))
            data = np.rint(f * 10 ** at.scale).astype(np.int64)
        else:
            data = np.array(
                [0 if x is None else int(x.scaleb(at.scale))
                 for x in arr.to_pylist()], dtype=np.int64)
        return HostColumn(dtype, data, v)
    if pt.is_date32(at):
        v = _arrow_validity(arr)
        a = arr.fill_null(0) if v is not None else arr
        data = np.asarray(a.cast(pa.int32()))
        return HostColumn(T.DATE32, data.astype(np.int32), v)
    if pt.is_date64(at) or pt.is_timestamp(at):
        v = _arrow_validity(arr)
        us = arr.cast(pa.timestamp("us"))
        a = us.fill_null(0) if v is not None else us
        data = np.asarray(a.cast(pa.int64()))
        return HostColumn(T.TIMESTAMP, data.astype(np.int64), v)
    if pt.is_time(at):
        v = _arrow_validity(arr)
        us = arr.cast(pa.time64("us"))
        a = us.fill_null(0) if v is not None else us
        data = np.asarray(a.cast(pa.int64()))
        return HostColumn(T.TIME, data.astype(np.int64), v)
    if pt.is_list(at) or pt.is_large_list(at) or pt.is_fixed_size_list(at):
        elem = _arrow_scalar_dtype(at.value_type)
        v = _arrow_validity(arr)
        # rebuild per-row lists of element device-rep scalars
        pylists = arr.to_pylist()
        obj = np.empty(len(pylists), dtype=object)
        if elem.is_string:
            flat = sorted({str(x) for row in pylists if row is not None
                           for x in row if x is not None})
            d = Dictionary(np.array(flat, dtype=object))
            lut = {s: i for i, s in enumerate(flat)}
            for i, row in enumerate(pylists):
                obj[i] = (None if row is None else
                          [None if x is None else lut[str(x)] for x in row])
        else:
            from .column import _coerce_elem

            d = None
            for i, row in enumerate(pylists):
                obj[i] = (None if row is None else
                          [None if x is None else _coerce_elem(x, elem)
                           for x in row])
        return HostColumn(T.list_of(elem), obj, v, d)
    raise PlanError(f"unsupported arrow type {at}")


def _arrow_scalar_dtype(at) -> T.DataType:
    import pyarrow as pa
    import pyarrow.types as pt

    if pt.is_string(at) or pt.is_large_string(at) or pt.is_dictionary(at):
        return T.STRING
    if pt.is_binary(at) or pt.is_large_binary(at):
        return T.BINARY
    if pt.is_boolean(at):
        return T.BOOL
    if pt.is_integer(at):
        if pt.is_unsigned_integer(at) or at.bit_width == 64:
            return T.INT64
        return {8: T.INT8, 16: T.INT16, 32: T.INT32}[at.bit_width]
    if pt.is_floating(at):
        return T.FLOAT32 if at == pa.float32() else T.FLOAT64
    if pt.is_decimal(at):
        return T.decimal(at.precision, at.scale)
    if pt.is_date32(at):
        return T.DATE32
    if pt.is_date64(at) or pt.is_timestamp(at):
        return T.TIMESTAMP
    raise PlanError(f"unsupported arrow list element type {at}")


# ---------------------------------------------------------------------------
# host column -> python / pandas / arrow
# ---------------------------------------------------------------------------


def pa_type(dtype: T.DataType):
    """Our logical DataType -> the pyarrow type it round-trips through
    (reference: arrow DataType, common/src/scalar/mod.rs)."""
    import pyarrow as pa

    K = T.TypeKind
    table = {
        K.BOOL: pa.bool_(), K.INT8: pa.int8(), K.INT16: pa.int16(),
        K.INT32: pa.int32(), K.INT64: pa.int64(),
        K.FLOAT32: pa.float32(), K.FLOAT64: pa.float64(),
        K.DATE32: pa.date32(), K.TIMESTAMP: pa.timestamp("us"),
        K.TIME: pa.time64("us"), K.STRING: pa.string(),
        K.BINARY: pa.binary(), K.NULL: pa.null(),
    }
    if dtype.kind in table:
        return table[dtype.kind]
    if dtype.is_decimal:
        return pa.decimal128(dtype.precision, dtype.scale)
    if dtype.is_list:
        return pa.list_(pa_type(dtype.elem))
    raise PlanError(f"no arrow type for {dtype!r}")


def _elem_logical(dtype: T.DataType, v, dictionary):
    if v is None:
        return None
    if dtype.is_struct:
        tup = dictionary.values[int(v)]
        return {n: x for (n, _t), x in zip(dtype.fields, tup)}
    if dtype.is_map:
        return dict(dictionary.values[int(v)])
    if dtype.is_binary:
        vals = dictionary.values if dictionary is not None else None
        return bytes(vals[int(v)]) if vals is not None and len(vals) else None
    if dtype.is_string:
        vals = dictionary.values if dictionary is not None else None
        return str(vals[int(v)]) if vals is not None and len(vals) else None
    if dtype.is_decimal:
        return round(int(v) / 10 ** dtype.scale, dtype.scale)
    if dtype.kind is T.TypeKind.DATE32:
        import datetime

        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
    if dtype.kind is T.TypeKind.TIMESTAMP:
        return np.datetime64(int(v), "us").astype("datetime64[us]").item()
    if dtype.kind is T.TypeKind.TIME:
        import datetime

        return (datetime.datetime(1970, 1, 1)
                + datetime.timedelta(microseconds=int(v))).time()
    if dtype.kind is T.TypeKind.BOOL:
        return bool(v)
    if dtype.is_integer:
        return int(v)
    if dtype.is_float:
        return float(v)
    return v


def _to_pylist(dtype: T.DataType, c: HostColumn) -> list:
    valid = c.valid_mask()
    if dtype.is_list:
        out = []
        for i, row in enumerate(c.data):
            if not valid[i] or row is None:
                out.append(None)
            else:
                out.append([_elem_logical(dtype.elem, x, c.dictionary)
                            for x in row])
        return out
    out = []
    for i, v in enumerate(c.data):
        out.append(_elem_logical(dtype, v, c.dictionary) if valid[i] else None)
    return out


def _to_pandas_series(dtype: T.DataType, c: HostColumn):
    import pandas as pd

    v = c.validity
    if dtype.is_string or dtype.is_list or dtype.is_struct or dtype.is_map:
        return pd.Series(_to_pylist_pandas(dtype, c), dtype=object)
    if dtype.is_decimal:
        data = c.data.astype(np.float64) / (10.0 ** dtype.scale)
        if v is not None:
            data = np.where(v, data, np.nan)
        return pd.Series(data)
    if dtype.kind is T.TypeKind.DATE32:
        s = pd.Series(c.data.astype("datetime64[D]").astype("datetime64[ns]"))
        if v is not None:
            s[~v] = pd.NaT
        return s
    if dtype.kind is T.TypeKind.TIMESTAMP:
        s = pd.Series(c.data.astype("datetime64[us]").astype("datetime64[ns]"))
        if v is not None:
            s[~v] = pd.NaT
        return s
    if dtype.is_float:
        # nullable floats keep the float64 dtype (NULL -> NaN): float
        # consumers compare to tolerance, and pandas float semantics match
        data = c.data.astype(np.float64) if v is not None else c.data
        if v is not None:
            data = np.where(v, data, np.nan)
        return pd.Series(data)
    if v is not None:
        # nullable ints/bools surface as object series with None: the
        # engine's NULL is not pandas' NaN, and widening to float64 would
        # corrupt large int64 values
        obj = c.data.astype(object)
        obj[~v] = None
        return pd.Series(obj, dtype=object)
    return pd.Series(c.data)


def _to_pylist_pandas(dtype: T.DataType, c: HostColumn) -> list:
    # strings stay str/None; lists stay python lists (pandas object column)
    return _to_pylist(dtype, c)


def _to_arrow_array(dtype: T.DataType, c: HostColumn):
    import pyarrow as pa

    v = c.validity
    mask = None if v is None else ~v
    k = dtype.kind
    if dtype.is_binary:
        return pa.array([None if x is None else bytes(x)
                         for x in c.to_numpy_logical()], type=pa.binary())
    if dtype.is_string:
        return pa.array(c.to_numpy_logical(), type=pa.string())
    if dtype.is_list:
        return pa.array(_to_pylist(dtype, c))
    if dtype.is_decimal:
        data = c.data.astype(np.float64) / (10.0 ** dtype.scale)
        return pa.array(data, type=pa.float64(), mask=mask)
    if k is T.TypeKind.DATE32:
        return pa.array(c.data.astype(np.int32), type=pa.date32(), mask=mask)
    if k is T.TypeKind.TIMESTAMP:
        return pa.array(c.data.astype(np.int64), type=pa.timestamp("us"),
                        mask=mask)
    if k is T.TypeKind.TIME:
        return pa.array(c.data.astype(np.int64), type=pa.time64("us"),
                        mask=mask)
    if k is T.TypeKind.BOOL:
        return pa.array(c.data.astype(np.bool_), mask=mask)
    if dtype.is_integer:
        t = {T.TypeKind.INT8: pa.int8(), T.TypeKind.INT16: pa.int16(),
             T.TypeKind.INT32: pa.int32()}.get(k, pa.int64())
        return pa.array(c.data, type=t, mask=mask)
    if dtype.is_float:
        t = pa.float32() if k is T.TypeKind.FLOAT32 else pa.float64()
        return pa.array(c.data, type=t, mask=mask)
    return pa.array(c.data, mask=mask)
