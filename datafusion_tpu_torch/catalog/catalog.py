"""Catalog: table registration and providers.

Port of datafusion_tpu/catalog/catalog.py (reference:
datafusion/catalog/src/{catalog.rs,table.rs,memory/}; ListingTable in
catalog-listing/src/table.rs). A MemTable caches the torch encoding of the
columns it has been asked for, per device, so repeated queries find their
columns resident on the card. The file providers (Parquet, CSV, JSON, Arrow
IPC, Avro) read through the copied io/ layer and cache the uploaded relation
per device (and, for Parquet, per pruned scan). Out-of-core scans
(`scan_chunks`) upload one capacity-bounded chunk at a time and go through
neither cache: a chunked query holds one chunk of a table on the card, not
the table. A StreamingTable is a (possibly unbounded) stream of batches.
A WorkTable holds the previous step of a recursive CTE while
RecursiveQueryExec runs its recursive arm."""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

from ..common.errors import PlanError
from ..common.schema import Schema
from ..data.device import DeviceRelation, resolve_device, to_device
from ..data.table import Table, pa_type as _pa_type


class TableProvider:
    def schema(self) -> Schema:
        raise NotImplementedError

    def host_table(self) -> Table:
        raise NotImplementedError

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        """Device-resident scan. `filters`/`projection` are pushed-down hints;
        providers may ignore them -- the engine always re-applies filters
        exactly (Inexact pushdown semantics)."""
        raise NotImplementedError

    def statistics(self):
        """Table statistics for cost-based planning (reference: Statistics,
        common/src/stats.rs:368), computed once from the host table."""
        cached = getattr(self, "_stats", None)
        if cached is None:
            from ..common.stats import Statistics, table_statistics

            try:
                cached = table_statistics(self.host_table())
            except Exception:  # noqa: BLE001 -- unreadable table: no stats
                cached = Statistics(0.0)
            self._stats = cached
        return cached

    def is_unique(self, cols: tuple) -> bool:
        """Whether `cols` is a unique key of this table: declared keys
        answer immediately, otherwise one exact host pass (cached) decides.
        Columns with NULLs are never a unique key here."""
        cols = tuple(cols)
        for k in getattr(self, "_unique_keys", ()):
            if set(k) <= set(cols):
                return True  # a superset of a unique key is unique
        cache = getattr(self, "_unique_cache", None)
        if cache is None:
            cache = self._unique_cache = {}
        hit = cache.get(cols)
        if hit is not None:
            return hit
        import numpy as np

        try:
            t = self.host_table()
            arrs = []
            for name in cols:
                c = t.column(name)
                if c.validity is not None and not c.validity.all():
                    cache[cols] = False
                    return False
                arrs.append(np.asarray(c.data))
            n = t.num_rows
            if n == 0:
                uniq = True
            elif len(arrs) == 1:
                uniq = len(np.unique(arrs[0])) == n
            else:
                uniq = len(np.unique(np.stack(arrs, axis=1), axis=0)) == n
        except Exception:  # noqa: BLE001 -- unknown column / unloadable table
            uniq = False
        cache[cols] = uniq
        return uniq

    # every chunk of scan_chunks carries one dictionary per string column
    # and one bounds tuple per column (a StreamingTable's do not)
    shared_chunk_metadata = True

    def scan_chunks(self, ctx, filters=(), projection=None, chunk_rows=1 << 20):
        """Capacity-bounded device chunks of this table, uploaded one at a
        time from slices of the host table (reference analog: partitioned
        FileStream batches). Every chunk shares ONE capacity, one dictionary
        per string column and one bounds tuple per column, so the per-chunk
        operators see the same static metadata in every chunk. The device
        caches of scan_device are not touched."""
        from ..data.device import bucket_capacity, table_bounds

        t = _project(self.host_table(), projection)
        bounds = table_bounds(t)
        cap = bucket_capacity(min(max(chunk_rows, 1), max(t.num_rows, 1)))
        device = resolve_device(ctx.device if ctx is not None else None)
        if t.num_rows == 0:
            yield to_device(t, capacity=cap, device=device, bounds=bounds)
            return
        for start in range(0, t.num_rows, cap):
            yield to_device(t, capacity=cap, device=device,
                            row_range=(start, min(start + cap, t.num_rows)),
                            bounds=bounds)


def _project(t: Table, projection) -> Table:
    """The table's columns named in `projection` (all of them for None; the
    first one for an empty projection, whose scan still needs its rows)."""
    if projection is None:
        return t
    idxs = [t.schema.index_of(c) for c in projection] or [0][:len(t.columns)]
    return Table(Schema([t.schema.fields[i] for i in idxs]),
                 [t.columns[i] for i in idxs])


class StreamingTable(TableProvider):
    """A (possibly unbounded) stream of record batches (reference:
    StreamingTableExec, physical-plan/src/streaming.rs:63). `batches` is a
    zero-argument factory returning an iterator of host Tables or pydicts;
    each call starts a fresh scan. Queries over an unbounded stream run
    through the chunked executor, which pulls batches as it needs them and
    stops early under a LIMIT; a pipeline breaker over an unbounded stream
    is rejected at plan time (physical/chunked.plan_boundedness). Each
    batch uploads with its own dictionaries and bounds (a stream cannot be
    read ahead for shared ones), so the chunked executor makes no decision
    for all chunks from one of them."""

    shared_chunk_metadata = False

    def __init__(self, schema: Schema, batches, unbounded: bool = False):
        self._schema = schema
        self._batches = batches
        self.unbounded = unbounded

    def schema(self) -> Schema:
        return self._schema

    def is_unique(self, cols: tuple) -> bool:
        return False  # a stream cannot be scanned at plan time

    def statistics(self):
        from ..common.stats import Statistics

        return Statistics(float("inf") if self.unbounded else 0.0)

    def host_table(self) -> Table:
        if self.unbounded:
            raise PlanError("cannot materialize an unbounded stream")
        from ..physical.chunked import concat_host

        return concat_host([self._coerce(b) for b in self._batches()],
                           self._schema)

    def _coerce(self, b) -> Table:
        if isinstance(b, Table):
            return b
        return Table.from_pydict(b, {f.name: f.dtype for f in self._schema.fields})

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        return to_device(self.host_table(),
                         device=resolve_device(ctx.device if ctx is not None
                                               else None))

    def scan_chunks(self, ctx, filters=(), projection=None, chunk_rows=1 << 20):
        from ..data.device import bucket_capacity

        cap = None
        device = resolve_device(ctx.device if ctx is not None else None)
        for b in self._batches():
            t = _project(self._coerce(b), projection)
            if cap is None:
                cap = bucket_capacity(min(max(t.num_rows, 1), chunk_rows))
            for start in range(0, max(t.num_rows, 1), cap):
                yield to_device(t, capacity=cap, device=device,
                                row_range=(start, min(start + cap, t.num_rows)))


class WorkTable(TableProvider):
    """The recursive CTE's working table: RecursiveQueryExec binds the
    previous iteration's device relation before each step (reference:
    WorkTable, physical-plan/src/work_table.rs). Nothing is cached: each
    scan returns the relation bound at that moment."""

    def __init__(self, name: str, schema: Schema):
        self.name = name
        self._schema = schema
        self._rel: Optional[DeviceRelation] = None

    def schema(self) -> Schema:
        return self._schema

    def host_table(self) -> Table:
        raise PlanError(f"worktable {self.name!r} has no host data")

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        if self._rel is None:
            raise PlanError(
                f"worktable {self.name!r} scanned outside its recursion")
        return self._rel


class MemTable(TableProvider):
    def __init__(self, table: Table, unique_keys=()):
        self._table = table
        self._unique_keys = tuple(tuple(k) for k in unique_keys)
        # per-device lazy COLUMN cache: only projected columns are encoded
        # and uploaded
        self._device: Dict[str, Dict[str, object]] = {}
        self._device_sel: Dict[str, object] = {}

    def schema(self) -> Schema:
        return self._table.schema

    def host_table(self) -> Table:
        return self._table

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        device = resolve_device(ctx.device if ctx is not None else None)
        key = str(device)
        schema = self._table.schema
        all_names = [f.name for f in schema.fields]
        want = list(projection if projection is not None else all_names)
        if not want:  # zero-column scan (COUNT(*)): sel still needed
            want = all_names[:1]
        cache = self._device.setdefault(key, {})
        missing = [n for n in want if n not in cache]
        if missing:
            idx = [schema.find(n) for n in missing]
            sub = Table(Schema([schema.fields[i] for i in idx]),
                        [self._table.columns[i] for i in idx])
            rel = to_device(sub, device=device)
            for f, c in zip(rel.schema.fields, rel.columns):
                cache[f.name] = c
            self._device_sel.setdefault(key, rel.sel)
        fields = [schema.fields[schema.find(n)] for n in want]
        return DeviceRelation(Schema(fields), tuple(cache[n] for n in want),
                              self._device_sel[key])


# uploaded scans a ParquetTable keeps, least recently used first out: each
# filter set that prunes to other units or pages uploads a relation of its
# own, and a session sees a new set for every new literal (an EXECUTE with a
# new parameter). A steady state keeps the scans it reads alive itself, and
# one whose scan was dropped re-uploads and captures anew.
PARQUET_DEVICE_SCANS = 8


def _device_key(ctx):
    """(cache key, torch device) of the device a scan runs on."""
    device = resolve_device(ctx.device if ctx is not None else None)
    return str(device), device


class FileTable(TableProvider):
    """Base for file-backed tables: lazy host read, cached device encoding."""

    def __init__(self, path: str):
        self.path = path
        self._table: Optional[Table] = None
        self._device: Dict[str, DeviceRelation] = {}

    def _read(self) -> Table:
        raise NotImplementedError

    def schema(self) -> Schema:
        return self.host_table().schema

    def host_table(self) -> Table:
        if self._table is None:
            self._table = self._read()
        return self._table

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        key, device = _device_key(ctx)
        if key not in self._device:
            self._device[key] = to_device(self.host_table(), device=device)
        return self._device[key]


class ParquetTable(TableProvider):
    """Parquet scan through the file-group scanner (io/parquet.py): per-file
    row-group reads, projection pushdown to disk, hive partition columns, and
    statistics-, bloom-filter- and page-index-based pruning of pushed-down
    filter conjuncts (reference: datasource-parquet/src/opener/mod.rs:388-593,
    pruning/src/pruning_predicate.rs:365)."""

    def __init__(self, path: str):
        self.path = path
        from ..io.parquet import ParquetDataset

        self._ds = ParquetDataset(path)
        self._schema: Optional[Schema] = None
        self._table: Optional[Table] = None
        self._device: "OrderedDict[tuple, DeviceRelation]" = OrderedDict()
        self._chunk_dicts: Dict[str, object] = {}

    @property
    def last_scan(self) -> Dict:
        """Pruning counters of the most recent scan (for EXPLAIN/tests)."""
        return self._ds.last_scan

    def schema(self) -> Schema:
        if self._schema is None:
            from ..common.schema import Field

            # footer metadata only -- no data read
            empty = Table.from_arrow(self._ds.arrow_schema().empty_table())
            self._schema = Schema([Field(f.name, c.dtype, nullable=True)
                                   for f, c in zip(empty.schema.fields,
                                                   empty.columns)])
        return self._schema

    def host_table(self) -> Table:
        if self._table is None:
            self._table = Table.from_arrow(self._ds.read())
        return self._table

    def statistics(self):
        """Footer-derived Statistics (no data read) in the cost model's
        shape (reference: ListingTable statistics collection,
        catalog-listing/src/table.rs; Statistics common/src/stats.rs:368)."""
        cached = getattr(self, "_stats", None)
        if cached is None:
            from ..common.stats import ColumnStatistics, Statistics, _ordinal

            rows = float(self._ds.num_rows())
            cols = {}
            for name, s in self._ds.column_stats().items():
                lo, hi = _ordinal(s.lo), _ordinal(s.hi)
                ndv = None
                if lo is not None and hi is not None:
                    # near-dense key heuristic shared with table_statistics
                    ndv = max(1.0, min(hi - lo + 1.0, rows))
                cols[name] = ColumnStatistics(float(s.null_count or 0),
                                              lo, hi, ndv)
            cached = self._stats = Statistics(rows, cols, exact_rows=True)
        return cached

    def scan_device(self, ctx, filters=(), projection=None) -> DeviceRelation:
        """Plan the pruned (file, row groups) units for these filters, then
        upload them once per (device, units, page masks, projection): a warm
        scan with the same filters returns the same relation, so a captured
        steady state finds its scan tensors where it left them. The last
        PARQUET_DEVICE_SCANS relations stay cached."""
        use_bloom = bool(ctx.opt("execution.parquet_bloom_pruning", True)) \
            if ctx is not None else True
        units = tuple((p, tuple(rgs))
                      for p, rgs in self._ds.plan_units(list(filters),
                                                        use_bloom=use_bloom))
        proj = tuple(projection) if projection is not None else None
        # page-index row masks change WHICH rows a unit yields, so they are
        # part of the cache identity (same units, different filters)
        mask_sig = tuple(sorted(
            (p, rg, hash(m.tobytes()))
            for (p, rg), m in self._ds._unit_masks.items()))
        dkey, device = _device_key(ctx)
        key = (dkey, units, mask_sig, proj)
        rel = self._device.get(key)
        if rel is not None:
            self._device.move_to_end(key)
            return rel
        threads = int(ctx.opt("execution.parquet_scan_threads", 8)) \
            if ctx is not None else 8
        at = self._ds.read_units([(p, list(rgs)) for p, rgs in units],
                                 projection, threads=threads)
        rel = self._device[key] = to_device(Table.from_arrow(at), device=device)
        while len(self._device) > PARQUET_DEVICE_SCANS:
            self._device.popitem(last=False)
        return rel

    def _shared_dictionary(self, name: str):
        """One interned Dictionary per string column for chunked scans (see
        ParquetDataset.global_dictionary): every chunk's codes index it."""
        if name not in self._chunk_dicts:
            import numpy as np

            from ..data.column import Dictionary

            if name in self._ds.partition_keys:
                vals = np.array(sorted({str(f.partitions[name])
                                        for f in self._ds.files
                                        if f.partitions.get(name) is not None}),
                                dtype=object)
            else:
                vals = self._ds.global_dictionary(name)
            self._chunk_dicts[name] = None if vals is None else Dictionary(vals)
        return self._chunk_dicts[name]

    def _chunk_bounds(self, table: Table):
        """Dataset-wide device-representation bounds per chunk column, from
        footer statistics only, the same for every chunk."""
        stats = self._ds.column_stats()
        out = []
        for f in table.schema.fields:
            s = stats.get(f.name)
            b = None
            if s is not None and s.lo is not None and s.hi is not None:
                try:
                    if f.dtype.is_decimal:
                        k = 10 ** f.dtype.scale
                        b = (min(int(round(s.lo * k)), 0),
                             max(int(round(s.hi * k)), 0))
                    elif f.dtype.is_integer or f.dtype.is_temporal:
                        b = (min(int(s.lo), 0), max(int(s.hi), 0))
                except (TypeError, ValueError):
                    b = None
            out.append(b)
        return out

    def scan_chunks(self, ctx, filters=(), projection=None, chunk_rows=1 << 20):
        """Out-of-core Parquet scan: batches of pruned row groups stream from
        disk one at a time (the next batch is read on a worker thread while
        this one runs, `execution.parquet_scan_ahead`); string columns are
        re-encoded onto dataset-wide dictionaries and bounds come from footer
        statistics, so every chunk carries the same static metadata. Nothing
        is kept in the uploaded-scan cache."""
        from ..data.device import bucket_capacity

        batches = self._ds.chunk_units(list(filters), max(chunk_rows, 1))
        cap = bucket_capacity(max(chunk_rows, 1))
        device = resolve_device(ctx.device if ctx is not None else None)
        if not batches:
            at = self._ds.read(filters, projection)  # empty, schema-correct
            yield to_device(Table.from_arrow(at), device=device)
            return
        threads = int(ctx.opt("execution.parquet_scan_threads", 8)) \
            if ctx is not None else 8
        ahead = bool(ctx.opt("execution.parquet_scan_ahead", True)) \
            if ctx is not None else True

        def fetch(units):
            return Table.from_arrow(
                self._ds.read_units(units, projection, threads=threads))

        pool = pending = None
        if ahead and len(batches) > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=1)
            pending = pool.submit(fetch, batches[0])
        bounds = None
        try:
            for bi, units in enumerate(batches):
                if pending is not None:
                    t = pending.result()
                    pending = (pool.submit(fetch, batches[bi + 1])
                               if bi + 1 < len(batches) else None)
                else:
                    t = fetch(units)
                cols = []
                for f, c in zip(t.schema.fields, t.columns):
                    if f.dtype.is_string:
                        shared = self._shared_dictionary(f.name)
                        if shared is not None:
                            c = c.remap_dictionary(shared)
                    cols.append(c)
                t = Table(t.schema, cols)
                if bounds is None:
                    bounds = self._chunk_bounds(t)
                for start in range(0, t.num_rows, cap):
                    yield to_device(t, capacity=cap, device=device,
                                    row_range=(start, min(start + cap, t.num_rows)),
                                    bounds=bounds)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)


def _expand_files(path: str, exts) -> List[str]:
    if os.path.isdir(path):
        out = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(exts)
        )
        if not out:
            raise PlanError(f"no files matching {exts} under {path}")
        return out
    return [path]


def _concat(tables):
    import pyarrow as pa

    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


class JsonTable(FileTable):
    """Newline-delimited JSON via the Arrow C++ reader (reference:
    datasource-json)."""

    def _read(self) -> Table:
        import pyarrow.json as pjson

        paths = _expand_files(self.path, (".json", ".ndjson", ".jsonl"))
        return Table.from_arrow(_concat([pjson.read_json(p) for p in paths]))


class ArrowTable(FileTable):
    """Arrow IPC (feather v2) files (reference: datasource-arrow crate)."""

    def _read(self) -> Table:
        import pyarrow.ipc as pipc

        paths = _expand_files(self.path, (".arrow", ".feather", ".ipc"))
        return Table.from_arrow(_concat([pipc.open_file(p).read_all()
                                         for p in paths]))


class AvroTable(FileTable):
    """Avro object container files via the native decoder (reference:
    datasource-avro crate, read-only)."""

    def _read(self) -> Table:
        from ..io.avro import read_avro

        paths = _expand_files(self.path, (".avro",))
        return Table.from_arrow(_concat([read_avro(p) for p in paths]))


class CsvTable(FileTable):
    def __init__(self, path: str, has_header: bool = True, delimiter: str = ",",
                 schema=None):
        super().__init__(path)
        self.has_header = has_header
        self.delimiter = delimiter
        # declared (name, DataType) pairs (CREATE EXTERNAL TABLE column
        # list): names override the header positionally and values parse
        # straight into the declared arrow types (exact for decimals)
        self.declared = schema

    def _read(self) -> Table:
        import re

        import pyarrow as pa
        import pyarrow.csv as pcsv

        paths = _expand_files(self.path, (".csv", ".tbl", ".txt"))
        opts = pcsv.ParseOptions(delimiter=self.delimiter)
        if self.declared:
            names = [n for n, _ in self.declared]
            ropts = pcsv.ReadOptions(column_names=names,
                                     skip_rows=1 if self.has_header else 0)
            types = {n: _pa_type(dt) for n, dt in self.declared}
        else:
            ropts = pcsv.ReadOptions(
                autogenerate_column_names=not self.has_header)
            types = None

        def read_one(p):
            # a declared BIGINT UNSIGNED column can hold values beyond
            # int64 (this engine has no u64 kind); rather than failing the
            # whole table, re-read the offending column as float64 --
            # queries needing its exact value then mismatch individually
            t = dict(types) if types is not None else None
            for _ in range(len(t) + 1 if t else 1):
                try:
                    return pcsv.read_csv(
                        p, parse_options=opts, read_options=ropts,
                        convert_options=pcsv.ConvertOptions(column_types=t)
                        if t is not None else None)
                except pa.lib.ArrowInvalid as exc:
                    m = re.search(r"CSV column #(\d+)", str(exc))
                    if t is None or m is None:
                        raise
                    col = list(t)[int(m.group(1))]
                    if t[col] == pa.float64():
                        raise
                    t[col] = pa.float64()
            raise PlanError(f"csv read failed for {p}")

        return Table.from_arrow(_concat([read_one(p) for p in paths]))


class SchemaProvider:
    """One namespace of tables (reference: SchemaProvider,
    datafusion/catalog/src/schema.rs)."""

    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, TableProvider] = {}

    def register(self, name: str, provider: TableProvider):
        self.tables[name.lower()] = provider

    def deregister(self, name: str):
        self.tables.pop(name.lower(), None)

    def table(self, name: str) -> Optional[TableProvider]:
        return self.tables.get(name.lower())

    def names(self) -> List[str]:
        return sorted(self.tables)


class CatalogProvider:
    """A named collection of schemas (reference: CatalogProvider,
    datafusion/catalog/src/catalog.rs)."""

    def __init__(self, name: str):
        self.name = name
        self.schemas: Dict[str, SchemaProvider] = {}

    def schema(self, name: str, create: bool = False) -> Optional[SchemaProvider]:
        s = self.schemas.get(name.lower())
        if s is None and create:
            s = self.schemas[name.lower()] = SchemaProvider(name.lower())
        return s

    def schema_names(self) -> List[str]:
        return sorted(self.schemas)


DEFAULT_CATALOG = "datafusion"
DEFAULT_SCHEMA = "public"


class Catalog:
    """Session catalog list with a three-level namespace
    catalog.schema.table. Bare names resolve against the default
    catalog/schema."""

    def __init__(self):
        self.catalogs: Dict[str, CatalogProvider] = {}
        self.default_catalog = DEFAULT_CATALOG
        self.default_schema = DEFAULT_SCHEMA
        self.register_catalog(DEFAULT_CATALOG)
        self.views: Dict[str, object] = {}  # name -> LogicalPlan

    # ---- catalogs/schemas -------------------------------------------------
    def register_catalog(self, name: str) -> CatalogProvider:
        c = self.catalogs.get(name.lower())
        if c is None:
            c = self.catalogs[name.lower()] = CatalogProvider(name.lower())
            c.schema(DEFAULT_SCHEMA, create=True)
        return c

    def catalog(self, name: str) -> Optional[CatalogProvider]:
        return self.catalogs.get(name.lower())

    def register_schema(self, catalog: str, schema: str) -> SchemaProvider:
        return self.register_catalog(catalog).schema(schema, create=True)

    def _split(self, name: str):
        parts = name.split(".")
        if len(parts) == 1:
            return self.default_catalog, self.default_schema, parts[0]
        if len(parts) == 2:
            return self.default_catalog, parts[0], parts[1]
        if len(parts) == 3:
            return parts[0], parts[1], parts[2]
        raise PlanError(f"invalid table reference {name!r}")

    # ---- tables -------------------------------------------------------------
    def register(self, name: str, provider: TableProvider):
        c, s, t = self._split(name)
        self.register_catalog(c).schema(s, create=True).register(t, provider)

    def deregister(self, name: str):
        c, s, t = self._split(name)
        cat = self.catalog(c)
        sch = cat.schema(s) if cat else None
        if sch:
            sch.deregister(t)

    def get(self, name: str) -> TableProvider:
        c, s, t = self._split(name)
        cat = self.catalog(c)
        sch = cat.schema(s) if cat else None
        p = sch.table(t) if sch else None
        if p is None:
            raise PlanError(
                f"table {name!r} not found; registered: {self.names()}")
        return p

    def names(self) -> List[str]:
        """Registered table names: bare for the default schema, qualified
        elsewhere."""
        out = []
        for cn, cat in sorted(self.catalogs.items()):
            for sn, sch in sorted(cat.schemas.items()):
                for t in sch.names():
                    if cn == self.default_catalog and sn == self.default_schema:
                        out.append(t)
                    elif cn == self.default_catalog:
                        out.append(f"{sn}.{t}")
                    else:
                        out.append(f"{cn}.{sn}.{t}")
        return sorted(out)
