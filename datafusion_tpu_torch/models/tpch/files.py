"""TPC-H tables as files: Parquet (the layout the reference's `tpch`
benchmark reads) and pipe-delimited `.tbl` text (what dbgen writes), with
the `CREATE EXTERNAL TABLE` statements that register them.

`Table.write_parquet` stores a decimal column as float64; here decimals
stay decimal128(p, s), exact, as the reference's TPC-H Parquet files hold
them, so a query over the files answers as it does over the in-memory
tables. Every Parquet file carries a page index."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ...common import types as T
from ...data.table import Table


def to_arrow_exact(table: Table):
    """`Table.to_arrow`, but a decimal column becomes decimal128(p, s) built
    from its unscaled integers (no float rounding)."""
    import pyarrow as pa

    at = table.to_arrow()
    for i, (f, c) in enumerate(zip(table.schema.fields, table.columns)):
        if not f.dtype.is_decimal:
            continue
        lo = np.asarray(c.data, dtype=np.int64)
        words = np.empty((len(lo), 2), dtype=np.int64)  # little-endian i128
        words[:, 0] = lo
        words[:, 1] = lo >> 63
        validity = None
        if c.validity is not None:
            validity = pa.py_buffer(np.packbits(c.validity, bitorder="little"))
        arr = pa.Array.from_buffers(
            pa.decimal128(f.dtype.precision, f.dtype.scale), len(lo),
            [validity, pa.py_buffer(words.tobytes())])
        at = at.set_column(i, f.name, arr)
    return at


def _write_parquet(at, path: str) -> None:
    """One Parquet file with a page index, in pyarrow's default row groups
    of 2^20 rows (as `Table.write_parquet`)."""
    import pyarrow.parquet as pq

    pq.write_table(at, path, write_page_index=True)


def write_tpch_parquet(tables: Dict[str, Table], directory: str,
                       lineitem_files: int = 8) -> Dict[str, str]:
    """Each table as `<name>.parquet`; `lineitem` as `lineitem_files`
    files in a directory of its own (one listing table). Returns the
    LOCATION of each table."""
    out = {}
    for name, t in tables.items():
        if name == "lineitem" and lineitem_files > 1:
            d = os.path.join(directory, "lineitem")
            os.makedirs(d, exist_ok=True)
            at = to_arrow_exact(t)
            step = -(-t.num_rows // lineitem_files)
            for k in range(lineitem_files):
                _write_parquet(at.slice(k * step, step),
                               os.path.join(d, f"part-{k}.parquet"))
            out[name] = d
        else:
            out[name] = os.path.join(directory, f"{name}.parquet")
            _write_parquet(to_arrow_exact(t), out[name])
    return out


def write_sorted_lineitem(lineitem: Table, path: str,
                          row_group_size: int = 1 << 17) -> None:
    """`lineitem` sorted by l_shipdate (stable), in row groups of
    `row_group_size` rows, with a bloom filter on l_orderkey: the
    statistics of l_shipdate prune row groups, and l_orderkey, whose values
    overlap across row groups, leaves pruning to the bloom filters."""
    import pyarrow.parquet as pq

    at = to_arrow_exact(lineitem)
    at = at.take(np.argsort(np.asarray(at.column("l_shipdate").to_numpy()),
                            kind="stable"))
    pq.write_table(at, path, row_group_size=row_group_size,
                   write_page_index=True,
                   bloom_filter_options={"l_orderkey": True})


def write_tbl(table: Table, path: str) -> None:
    """Pipe-delimited text without a header, as dbgen's `.tbl` files (no
    trailing delimiter)."""
    import pyarrow.csv as pcsv

    pcsv.write_csv(to_arrow_exact(table), path, pcsv.WriteOptions(
        include_header=False, delimiter="|"))


_SQL_TYPES = {T.TypeKind.INT32: "INT", T.TypeKind.INT64: "BIGINT",
              T.TypeKind.DATE32: "DATE", T.TypeKind.STRING: "VARCHAR",
              T.TypeKind.FLOAT64: "DOUBLE"}


def _sql_type(dt: T.DataType) -> str:
    if dt.is_decimal:
        return f"DECIMAL({dt.precision},{dt.scale})"
    return _SQL_TYPES[dt.kind]


def external_table_sql(name: str, location: str, fmt: str = "parquet",
                       table: Optional[Table] = None) -> str:
    """CREATE EXTERNAL TABLE for a file written above. A `.tbl` table
    (fmt "tbl") declares its columns from `table` and reads with '|'."""
    if fmt == "parquet":
        return (f"CREATE EXTERNAL TABLE {name} STORED AS PARQUET "
                f"LOCATION '{location}'")
    cols = ", ".join(f"{f.name} {_sql_type(f.dtype)}"
                     for f in table.schema.fields)
    return (f"CREATE EXTERNAL TABLE {name} ({cols}) STORED AS CSV "
            f"OPTIONS ('format.delimiter' '|') LOCATION '{location}'")
