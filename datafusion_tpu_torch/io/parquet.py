# Verbatim copy of datafusion_tpu/io/parquet.py; host-only, kept in step with the original.
"""Native parquet scan path: file groups, hive partitions, row-group pruning.

TPU-native redesign of the reference's parquet source (datasource-parquet/
src/opener/mod.rs multi-stage pruning; pruning/src/pruning_predicate.rs:365
predicate-over-statistics rewriting; datasource/src/file_scan_config/ file
groups + partition columns). Instead of rewriting the predicate into a
min/max-column expression evaluated over a stats record batch, pruning here
is a host-side tri-state interval evaluation of the pushed-down filter
conjuncts against per-row-group column statistics:

    eval(pred, stats) in {TRUE, FALSE, UNKNOWN}
      FALSE  = provably no row in the unit passes  -> skip the row group
      TRUE   = provably every row passes           (usable for file-level
               partition pruning and future filter elision)
      UNKNOWN = must read

Statistics values are coerced to the engine's LOGICAL value space (dates as
days-since-epoch ints, decimals as floats, timestamps as micros) so they
compare directly against planner literals. Hive-style `key=value` path
segments become constant partition columns with exact (lo == hi) statistics,
so the same evaluator prunes whole files on partition predicates."""
from __future__ import annotations

import dataclasses
import datetime
import decimal
import os
from typing import Dict, List, Optional, Sequence, Tuple

from ..common.errors import PlanError
from ..expr import nodes as E

_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)


def _logical(v):
    """Coerce a parquet statistics / partition value to the engine's logical
    value space (matching planner Literal values)."""
    if v is None:
        return None
    if isinstance(v, bytes):
        try:
            return v.decode("utf-8")
        except UnicodeDecodeError:
            return None
    if isinstance(v, datetime.datetime):
        if v.tzinfo is not None:
            v = v.replace(tzinfo=None)
        return int((v - _EPOCH_TS).total_seconds() * 1_000_000)
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    if isinstance(v, decimal.Decimal):
        return float(v)
    return v


@dataclasses.dataclass
class ColStats:
    lo: object          # logical-space min, or None if unknown
    hi: object          # logical-space max, or None if unknown
    null_count: Optional[int]
    num_rows: int

    @property
    def has_nulls(self) -> Optional[bool]:
        return None if self.null_count is None else self.null_count > 0

    @property
    def all_null(self) -> Optional[bool]:
        return None if self.null_count is None else self.null_count >= self.num_rows


TRUE, FALSE, UNKNOWN = True, False, None


def _cmp(op: E.Op, a: ColStats, b: ColStats):
    """Tri-state comparison of two interval stats (TRUE = every row passes,
    FALSE = no row passes; SQL NULL never passes a filter, so nulls can only
    demote TRUE to UNKNOWN — they never rescue FALSE)."""
    if a.all_null or b.all_null:
        return FALSE  # comparison with NULL is NULL -> filtered out
    if a.lo is None or a.hi is None or b.lo is None or b.hi is None:
        return UNKNOWN
    nullfree = a.has_nulls is False and b.has_nulls is False
    try:
        if op is E.Op.LT:
            if a.hi < b.lo:
                return TRUE if nullfree else UNKNOWN
            if a.lo >= b.hi:
                return FALSE
        elif op is E.Op.LE:
            if a.hi <= b.lo:
                return TRUE if nullfree else UNKNOWN
            if a.lo > b.hi:
                return FALSE
        elif op is E.Op.GT:
            if a.lo > b.hi:
                return TRUE if nullfree else UNKNOWN
            if a.hi <= b.lo:
                return FALSE
        elif op is E.Op.GE:
            if a.lo >= b.hi:
                return TRUE if nullfree else UNKNOWN
            if a.hi < b.lo:
                return FALSE
        elif op is E.Op.EQ:
            if a.hi < b.lo or b.hi < a.lo:
                return FALSE
            if a.lo == a.hi == b.lo == b.hi:
                return TRUE if nullfree else UNKNOWN
        elif op is E.Op.NEQ:
            if a.hi < b.lo or b.hi < a.lo:
                return TRUE if nullfree else UNKNOWN
            if a.lo == a.hi == b.lo == b.hi:
                return FALSE
    except TypeError:
        return UNKNOWN
    return UNKNOWN


def _interval(e: E.Expr, stats: Dict[str, ColStats]) -> Optional[ColStats]:
    if isinstance(e, E.Column):
        return stats.get(e.cname)
    if isinstance(e, E.Literal):
        if e.value is None:
            return ColStats(None, None, 1, 1)  # all-null singleton
        v = e.value
        return ColStats(v, v, 0, 1)
    if isinstance(e, E.BinaryOp) and e.op in (E.Op.ADD, E.Op.SUB, E.Op.MUL):
        l = _interval(e.left, stats)
        r = _interval(e.right, stats)
        if l is None or r is None or None in (l.lo, l.hi, r.lo, r.hi):
            return None
        try:
            if e.op is E.Op.ADD:
                cands = [l.lo + r.lo, l.hi + r.hi]
            elif e.op is E.Op.SUB:
                cands = [l.lo - r.hi, l.hi - r.lo]
            else:
                cands = [l.lo * r.lo, l.lo * r.hi, l.hi * r.lo, l.hi * r.hi]
        except TypeError:
            return None
        nc = None
        if l.null_count is not None and r.null_count is not None:
            nc = min(l.null_count + r.null_count, max(l.num_rows, r.num_rows))
        return ColStats(min(cands), max(cands), nc, max(l.num_rows, r.num_rows))
    return None


def eval_predicate(e: E.Expr, stats: Dict[str, ColStats]):
    """Tri-state evaluation of a filter over a scan unit's statistics."""
    if isinstance(e, E.Literal):
        if e.value is None:
            return FALSE
        return TRUE if bool(e.value) else FALSE
    if isinstance(e, E.BinaryOp):
        if e.op is E.Op.AND:
            l = eval_predicate(e.left, stats)
            r = eval_predicate(e.right, stats)
            if l is FALSE or r is FALSE:
                return FALSE
            if l is TRUE and r is TRUE:
                return TRUE
            return UNKNOWN
        if e.op is E.Op.OR:
            l = eval_predicate(e.left, stats)
            r = eval_predicate(e.right, stats)
            if l is TRUE or r is TRUE:
                return TRUE
            if l is FALSE and r is FALSE:
                return FALSE
            return UNKNOWN
        if e.op.is_comparison:
            a = _interval(e.left, stats)
            b = _interval(e.right, stats)
            if a is None or b is None:
                return UNKNOWN
            return _cmp(e.op, a, b)
        return UNKNOWN
    if isinstance(e, E.Not):
        inner = eval_predicate(e.expr, stats)
        # NOT(NULL) = NULL: nulls stay non-passing under negation, so a
        # definite TRUE flips, but FALSE may include null rows (which must
        # not pass NOT either) — except under IS NULL, which is never NULL
        # itself.
        if inner is TRUE:
            return FALSE
        if inner is FALSE and isinstance(e.expr, E.IsNull):
            return TRUE
        return UNKNOWN
    if isinstance(e, E.IsNull):
        s = _interval(e.expr, stats)
        if s is None:
            return UNKNOWN
        if s.all_null:
            return TRUE
        if s.has_nulls is False:
            return FALSE
        return UNKNOWN
    if isinstance(e, E.Between):
        lo = E.BinaryOp(E.Op.GE, e.expr, e.low)
        hi = E.BinaryOp(E.Op.LE, e.expr, e.high)
        both = E.BinaryOp(E.Op.AND, lo, hi)
        return eval_predicate(E.Not(both) if e.negated else both, stats)
    if isinstance(e, E.InList):
        if e.negated:
            return UNKNOWN
        verdict = FALSE
        for v in e.values:
            r = eval_predicate(E.BinaryOp(E.Op.EQ, e.expr, v), stats)
            if r is TRUE:
                return TRUE
            if r is UNKNOWN:
                verdict = UNKNOWN
        return verdict
    return UNKNOWN


# ---------------------------------------------------------------------------
# dataset discovery + scan
# ---------------------------------------------------------------------------


def _parse_partition_value(raw: str):
    if raw == "__HIVE_DEFAULT_PARTITION__":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


@dataclasses.dataclass
class ScanFile:
    path: str
    partitions: Dict[str, object]


def _equality_constraints(filters: Sequence[E.Expr]) -> List[Tuple[str, List[object]]]:
    """Per-conjunct `column ∈ {values}` constraints usable for bloom pruning:
    `col = lit` and `col IN (lits)` (reference: bloom-filter candidate
    extraction in datasource-parquet/src/row_group_filter.rs)."""
    out: List[Tuple[str, List[object]]] = []
    for p in filters:
        if isinstance(p, E.BinaryOp) and p.op is E.Op.EQ:
            l, r = p.left, p.right
            if isinstance(r, E.Column) and isinstance(l, E.Literal):
                l, r = r, l
            if (isinstance(l, E.Column) and isinstance(r, E.Literal)
                    and r.value is not None):
                out.append((l.cname, [r.value]))
        elif isinstance(p, E.InList) and not p.negated and isinstance(p.expr, E.Column):
            vals = [v.value for v in p.values
                    if isinstance(v, E.Literal) and v.value is not None]
            if vals and len(vals) == len(p.values):
                out.append((p.expr.cname, vals))
    return out


def discover(path: str, exts=(".parquet",)) -> Tuple[List[ScanFile], List[str]]:
    """Expand a file/dir/URL into scan files, extracting hive `key=value`
    path segments as partition columns (reference: hive partition discovery
    in datasource/src/url.rs + listing table). Paths resolve through the
    object-store registry (io/object_store.py, the ObjectStoreRegistry
    analog); local directory walks go through the session list-files cache
    (reference: CacheManager list-files cache), keyed by the top directory's
    mtime."""
    from .object_store import LocalFileSystem, resolve as resolve_store

    store, spath = resolve_store(path)
    if not isinstance(store, LocalFileSystem):
        return _store_listing(store, spath, tuple(exts))
    path = spath
    if not os.path.isdir(path):
        return [ScanFile(path, {})], []
    from ..runtime.cache import default_cache_manager

    return default_cache_manager().listing(
        path, tuple(exts), lambda: _walk(path, tuple(exts)))


def _store_listing(store, prefix: str,
                   exts: Tuple[str, ...]) -> Tuple[List[ScanFile], List[str]]:
    files: List[ScanFile] = []
    pkeys: List[str] = []
    base = prefix.strip("/")
    for key, _size in store.list(prefix):
        if not key.endswith(exts):
            continue
        rel = key.strip("/")
        if base and rel.startswith(base):
            rel = rel[len(base):].lstrip("/")
        parts: Dict[str, object] = {}
        for seg in rel.split("/")[:-1]:
            if "=" in seg:
                k, _, v = seg.partition("=")
                parts[k] = _parse_partition_value(v)
                if k not in pkeys:
                    pkeys.append(k)
        files.append(ScanFile(key, parts))
    if not files:
        raise PlanError(f"no files matching {exts} under {prefix}")
    return files, pkeys


def _walk(path: str, exts: Tuple[str, ...]) -> Tuple[List[ScanFile], List[str]]:
    files: List[ScanFile] = []
    pkeys: List[str] = []
    for root, _dirs, names in sorted(os.walk(path)):
        rel = os.path.relpath(root, path)
        parts: Dict[str, object] = {}
        if rel != ".":
            for seg in rel.split(os.sep):
                if "=" in seg:
                    k, _, v = seg.partition("=")
                    parts[k] = _parse_partition_value(v)
                    if k not in pkeys:
                        pkeys.append(k)
        for f in sorted(names):
            if f.endswith(exts):
                files.append(ScanFile(os.path.join(root, f), parts))
    if not files:
        raise PlanError(f"no files matching {exts} under {path}")
    return files, pkeys


class ParquetDataset:
    """File-group parquet scanner with row-group pruning.

    Metadata (footers) is read once and cached; `read` returns an Arrow table
    holding only the surviving row groups and requested columns, with hive
    partition columns attached as constants."""

    def __init__(self, path: str):
        from .object_store import resolve as resolve_store

        self.store, _ = resolve_store(path)
        self.files, self.partition_keys = discover(path)
        self._meta: Dict[str, object] = {}   # path -> pq.ParquetFile
        self._global_dicts: Dict[str, object] = {}
        self._bloom: Dict[str, object] = {}  # path -> BloomIndex
        self._pageidx: Dict[str, object] = {}  # path -> PageIndex
        # (path, rg) -> bool keep-mask from page-index pruning, for the
        # most recent plan_units call (applied by read_units)
        self._unit_masks: Dict[Tuple[str, int], object] = {}
        self._phys_types: Optional[Dict[str, str]] = None
        self.last_scan: Dict[str, int] = {}

    def _bloom_index(self, path: str):
        if path not in self._bloom:
            from .bloom import BloomIndex

            self._bloom[path] = BloomIndex(path, opener=self.store.open)
        return self._bloom[path]

    def _physical_types(self) -> Dict[str, str]:
        """column name -> parquet physical type (from the first file)."""
        if self._phys_types is None:
            out: Dict[str, str] = {}
            md = self._pf(self.files[0].path).metadata
            if md.num_row_groups:
                g = md.row_group(0)
                for ci in range(g.num_columns):
                    col = g.column(ci)
                    if "." not in col.path_in_schema:
                        out[col.path_in_schema] = col.physical_type
            self._phys_types = out
        return self._phys_types

    def _page_index(self, path: str):
        if path not in self._pageidx:
            from .pageindex import PageIndex

            self._pageidx[path] = PageIndex(path, opener=self.store.open)
        return self._pageidx[path]

    def _logical_types(self) -> Dict[str, str]:
        return {f.name: str(f.type) for f in self.arrow_schema()}

    def _bloom_pruned(self, path: str, rg: int,
                      constraints: Sequence[Tuple[str, List[bytes]]]) -> bool:
        """True if any equality constraint's values are all provably absent
        from this row group per its bloom filter."""
        idx = self._bloom_index(path)
        for col, encoded in constraints:
            if idx.might_contain_any(rg, col, encoded) is FALSE:
                return True
        return False

    def _pf(self, path: str):
        if path not in self._meta:
            from .object_store import LocalFileSystem

            if isinstance(self.store, LocalFileSystem):
                from ..runtime.cache import default_cache_manager

                # footers parse once per process (reference: CacheManager's
                # parquet-metadata cache), not once per dataset/session
                self._meta[path] = default_cache_manager().parquet_file(path)
            else:
                import pyarrow.parquet as pq

                self._meta[path] = pq.ParquetFile(self.store.open(path))
        return self._meta[path]

    def arrow_schema(self):
        import pyarrow as pa

        base = self._pf(self.files[0].path).schema_arrow
        fields = list(base)
        for k in self.partition_keys:
            v = next(f.partitions.get(k) for f in self.files
                     if k in f.partitions)
            if isinstance(v, int):
                t = pa.int64()
            elif isinstance(v, float):
                t = pa.float64()
            else:
                t = pa.string()
            fields.append(pa.field(k, t, nullable=True))
        return pa.schema(fields)

    def num_rows(self) -> int:
        return sum(self._pf(f.path).metadata.num_rows for f in self.files)

    def column_stats(self) -> Dict[str, ColStats]:
        """Dataset-wide per-column min/max/null-count statistics from footers
        only (reference: Statistics in common/src/stats.rs:368; consumed by
        the cost-based join planner). Cached in the session file-statistics
        cache keyed by the file set."""
        from ..runtime.cache import default_cache_manager

        key = tuple(f.path for f in self.files)
        return default_cache_manager().stats(key, self._column_stats)

    def _column_stats(self) -> Dict[str, ColStats]:
        merged: Dict[str, ColStats] = {}
        total = 0
        for f in self.files:
            md = self._pf(f.path).metadata
            total += md.num_rows
            for rg in range(md.num_row_groups):
                for s, name in _rg_stats(md, rg):
                    prev = merged.get(name)
                    if prev is None:
                        merged[name] = ColStats(s.lo, s.hi, s.null_count,
                                                s.num_rows)
                    else:
                        merged[name] = _merge_stats(prev, s)
        for name, s in merged.items():
            merged[name] = ColStats(s.lo, s.hi, s.null_count, total)
        return merged

    # -- pruning -----------------------------------------------------------

    def _unit_stats(self, f: ScanFile, rg: Optional[int]) -> Dict[str, ColStats]:
        md = self._pf(f.path).metadata
        out: Dict[str, ColStats] = {}
        nrows = md.num_rows if rg is None else md.row_group(rg).num_rows
        rgs = range(md.num_row_groups) if rg is None else (rg,)
        for g in rgs:
            for s, name in _rg_stats(md, g):
                prev = out.get(name)
                out[name] = s if prev is None else _merge_stats(prev, s)
        for k, v in f.partitions.items():
            out[k] = (ColStats(None, None, nrows, nrows) if v is None
                      else ColStats(v, v, 0, nrows))
        return out

    def plan_units(self, filters: Sequence[E.Expr],
                   use_bloom: bool = True) -> List[Tuple[str, List[int]]]:
        """(path, surviving row-group ids) per file, after file-level,
        row-group statistics, then bloom-filter pruning
        (reference: opener/mod.rs:388-593 stages)."""
        units: List[Tuple[str, List[int]]] = []
        self._unit_masks = {}
        files_pruned = rgs_pruned = rgs_total = bloom_pruned = 0
        pages_masked_rows = page_pruned_rgs = 0
        bloom_constraints: List[Tuple[str, List[bytes]]] = []
        if use_bloom and filters:
            from .bloom import encode_plain

            ptypes = self._physical_types()
            for col, values in _equality_constraints(filters):
                pt = ptypes.get(col)
                if pt is None:
                    continue
                encoded = [encode_plain(v, pt) for v in values]
                if all(e is not None for e in encoded):
                    bloom_constraints.append((col, encoded))
        for f in self.files:
            md = self._pf(f.path).metadata
            rgs_total += md.num_row_groups
            if filters:
                fstats = self._unit_stats(f, None)
                if any(eval_predicate(p, fstats) is FALSE for p in filters):
                    files_pruned += 1
                    rgs_pruned += md.num_row_groups
                    continue
            keep: List[int] = []
            for g in range(md.num_row_groups):
                if filters:
                    gstats = self._unit_stats(f, g)
                    if any(eval_predicate(p, gstats) is FALSE for p in filters):
                        rgs_pruned += 1
                        continue
                if bloom_constraints and self._bloom_pruned(f.path, g,
                                                            bloom_constraints):
                    rgs_pruned += 1
                    bloom_pruned += 1
                    continue
                if filters:
                    # page-index pruning within the kept row group
                    # (reference: page_filter.rs -> RowSelection)
                    from .pageindex import prune_rows

                    rg_rows = md.row_group(g).num_rows
                    mask = prune_rows(self._page_index(f.path), g, rg_rows,
                                      filters, self._unit_stats(f, g),
                                      self._logical_types())
                    if mask is not None:
                        if not mask.any():
                            rgs_pruned += 1
                            continue
                        self._unit_masks[(f.path, g)] = mask
                        page_pruned_rgs += 1
                        pages_masked_rows += int((~mask).sum())
                keep.append(g)
            if keep:
                units.append((f.path, keep))
        self.last_scan = {
            "files_total": len(self.files), "files_pruned": files_pruned,
            "row_groups_total": rgs_total, "row_groups_pruned": rgs_pruned,
            "row_groups_bloom_pruned": bloom_pruned,
            "row_groups_page_masked": page_pruned_rgs,
            "rows_page_pruned": pages_masked_rows,
        }
        return units

    # -- reading -----------------------------------------------------------

    def _split_columns(self, columns):
        """(physical file columns, wanted partition keys) for a projection."""
        want_parts = [k for k in self.partition_keys
                      if columns is None or k in columns]
        file_cols = None
        if columns is not None:
            phys = set(self.arrow_schema().names) - set(self.partition_keys)
            file_cols = [c for c in columns if c in phys]
        return file_cols, want_parts

    def read_units(self, units: Sequence[Tuple[str, List[int]]],
                   columns: Optional[Sequence[str]] = None,
                   threads: int = 1):
        """Arrow table of the given (path, row-group ids) units; only
        `columns` are read from disk; partition columns attached.

        threads > 1 reads units concurrently (reference analog: the
        datasource's per-partition async file openers overlapping IO with
        decode, datasource/src/file_stream.rs); pyarrow releases the GIL
        during IO/decompression so a small thread pool overlaps for real.
        Each task opens a private ParquetFile handle -- shared handles are
        not safe for concurrent reads."""
        import pyarrow as pa

        import os

        file_cols, want_parts = self._split_columns(columns)
        by_file = {f.path: f for f in self.files}
        # object-store URLs must resolve through the shared (store-backed)
        # handle, which is not safe for concurrent reads: parallelize only
        # all-local unit lists
        parallel = threads > 1 and len(units) > 1 \
            and all(os.path.isfile(p) for p, _ in units)

        def read_one(path, rgs):
            if parallel:
                import pyarrow.parquet as pq

                pf = pq.ParquetFile(path)
            else:
                pf = self._pf(path)
            t = pf.read_row_groups(list(rgs), columns=file_cols)
            if self._unit_masks:
                # page-index row masks: drop definitely-false pages' rows
                # before dictionary-encoding / device upload
                md = pf.metadata
                parts = []
                import numpy as np

                for rg in rgs:
                    m = self._unit_masks.get((path, rg))
                    n = md.row_group(rg).num_rows
                    parts.append(m if m is not None
                                 else np.ones(n, dtype=bool))
                full = np.concatenate(parts) if parts else np.ones(0, bool)
                if not full.all():
                    t = t.filter(pa.array(full))
            for k in want_parts:
                v = by_file[path].partitions.get(k)
                arr = pa.nulls(t.num_rows) if v is None else pa.array(
                    [v] * t.num_rows)
                t = t.append_column(k, arr)
            return t

        if parallel:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    max_workers=min(int(threads), len(units))) as ex:
                chunks = list(ex.map(lambda u: read_one(*u), units))
        else:
            chunks = [read_one(*u) for u in units]
        if not chunks:
            sch = self.arrow_schema()
            if columns is not None:
                sch = pa.schema([sch.field(c) for c in columns])
            return sch.empty_table()
        return pa.concat_tables(chunks, promote_options="default")

    def read(self, filters: Sequence[E.Expr] = (),
             columns: Optional[Sequence[str]] = None):
        """Arrow table of surviving row groups; only `columns` are read from
        disk (projection pushdown); partition columns are attached."""
        return self.read_units(self.plan_units(list(filters)), columns)

    def chunk_units(self, filters: Sequence[E.Expr],
                    target_rows: int) -> List[List[Tuple[str, List[int]]]]:
        """Group surviving scan units into batches of ~target_rows, splitting
        per row group (the natural IO granule) so each batch reads bounded
        memory. Chunked scans iterate these (reference analog: FileStream over
        file groups, datasource/src/file_stream.rs)."""
        batches: List[List[Tuple[str, List[int]]]] = []
        cur: List[Tuple[str, List[int]]] = []
        cur_rows = 0
        for path, rgs in self.plan_units(list(filters)):
            md = self._pf(path).metadata
            for rg in rgs:
                n = md.row_group(rg).num_rows
                if cur and cur_rows + n > target_rows:
                    batches.append(cur)
                    cur, cur_rows = [], 0
                if cur and cur[-1][0] == path:
                    cur[-1][1].append(rg)
                else:
                    cur.append((path, [rg]))
                cur_rows += n
        if cur:
            batches.append(cur)
        return batches

    def global_dictionary(self, column: str) -> Optional["np.ndarray"]:
        """Sorted unique values of a string column across the whole dataset,
        streamed one row group at a time (bounded host memory). Chunked scans
        encode every chunk against this ONE dictionary so the static column
        metadata (pytree aux) is identical across chunks -- without it each
        chunk would carry its own dictionary and recompile every kernel."""
        if column in self._global_dicts:
            return self._global_dicts[column]
        import numpy as np
        import pyarrow as pa
        import pyarrow.compute as pc

        uniq: Optional[pa.Array] = None
        for f in self.files:
            pf = self._pf(f.path)
            if column not in pf.schema_arrow.names:
                self._global_dicts[column] = None
                return None
            for rg in range(pf.metadata.num_row_groups):
                col = pf.read_row_groups([rg], columns=[column]).column(0)
                u = pc.unique(col.combine_chunks())
                uniq = u if uniq is None else pc.unique(
                    pa.concat_arrays([uniq.cast(pa.string()), u.cast(pa.string())]))
        vals = (np.array([], dtype=object) if uniq is None
                else np.asarray(uniq.drop_null().to_numpy(zero_copy_only=False),
                                dtype=object))
        out = np.array(sorted(vals.astype(str)), dtype=object)
        self._global_dicts[column] = out
        return out


def _merge_stats(a: ColStats, b: ColStats) -> ColStats:
    lo = None if (a.lo is None or b.lo is None) else min(a.lo, b.lo)
    hi = None if (a.hi is None or b.hi is None) else max(a.hi, b.hi)
    nc = None if (a.null_count is None or b.null_count is None) else \
        a.null_count + b.null_count
    return ColStats(lo, hi, nc, a.num_rows + b.num_rows)


def _rg_stats(md, rg: int):
    """Yield (ColStats, column name) for each leaf column of row group rg."""
    g = md.row_group(rg)
    for ci in range(g.num_columns):
        col = g.column(ci)
        name = col.path_in_schema
        if "." in name:
            continue  # nested leaves: no pruning support
        st = col.statistics
        if st is None:
            yield ColStats(None, None, None, g.num_rows), name
            continue
        lo = _logical(st.min) if st.has_min_max else None
        hi = _logical(st.max) if st.has_min_max else None
        nc = st.null_count if st.has_null_count else None
        yield ColStats(lo, hi, nc, g.num_rows), name
