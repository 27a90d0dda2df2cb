# Verbatim copy of datafusion_tpu/io/pageindex.py; host-only, kept in step with the original.
"""Parquet page-index pruning (ColumnIndex / OffsetIndex).

Capability analog of the reference's page-level pruning stage
(datasource-parquet/src/page_filter.rs:1-622): within a row group that
survived statistics + bloom pruning, per-page min/max from the ColumnIndex
prove whole pages cannot match, and the OffsetIndex's first_row_index turns
the kept pages into row ranges -- the scan then drops definitely-false rows
before they are decoded into device batches. pyarrow exposes only
`has_column_index`, so the offsets and both index structures are parsed from
the file ourselves with the same thrift compact-protocol reader the bloom
stage uses (io/bloom.py).

Pruning is exact-safe in the same sense as row-group pruning: a page is
dropped only when every predicate evaluates definitely-FALSE over its
min/max interval, and the engine re-applies the full filter to whatever the
scan returns.
"""
from __future__ import annotations

import datetime
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bloom import parse_struct

# parquet physical type enum (parquet.thrift Type)
_BOOLEAN, _INT32, _INT64, _INT96, _FLOAT, _DOUBLE, _BYTE_ARRAY, _FLBA = range(8)

_EPOCH = datetime.date(1970, 1, 1)


def _decode_plain(raw: bytes, ptype: int, logical: str):
    """PLAIN-encoded page-index bound -> the engine's logical value space
    (io/parquet._logical conventions: dates as epoch days, timestamps as
    micros, strings as str)."""
    try:
        if ptype == _BOOLEAN:
            return bool(raw[0])
        if ptype == _INT32:
            v = struct.unpack("<i", raw)[0]
            return v  # date32 raw IS epoch days
        if ptype == _INT64:
            v = struct.unpack("<q", raw)[0]
            if logical.startswith("timestamp[ns"):
                return v // 1000
            if logical.startswith("timestamp[ms"):
                return v * 1000
            if logical.startswith("timestamp[s"):
                return v * 1_000_000
            return v
        if ptype == _FLOAT:
            return struct.unpack("<f", raw)[0]
        if ptype == _DOUBLE:
            return struct.unpack("<d", raw)[0]
        if ptype == _BYTE_ARRAY:
            return raw.decode("utf-8")
    except (struct.error, UnicodeDecodeError, IndexError):
        return None
    return None  # INT96 / FLBA (decimals): no page pruning


class PageIndex:
    """Lazy per-file access to parquet page indexes."""

    def __init__(self, path: str, opener=None):
        self.path = path
        self._open = opener or (lambda p: open(p, "rb"))
        # {(rg, column): (ci_off, ci_len, oi_off, oi_len, physical_type)}
        self._offsets: Optional[Dict] = None

    def _load(self) -> Dict:
        if self._offsets is not None:
            return self._offsets
        out: Dict = {}
        try:
            with self._open(self.path) as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(size - 8)
                tail = f.read(8)
                if tail[4:] != b"PAR1":
                    self._offsets = out
                    return out
                (meta_len,) = struct.unpack("<I", tail[:4])
                f.seek(size - 8 - meta_len)
                meta = f.read(meta_len)
            fmd, _ = parse_struct(meta)
            # RowGroup.1 = columns; ColumnChunk.4/5 = offset_index off/len,
            # .6/.7 = column_index off/len; ColumnMetaData.1 = physical type,
            # .3 = path_in_schema
            for rg, rgroup in enumerate(fmd.get(4) or []):
                for chunk in rgroup.get(1) or []:
                    cmd = chunk.get(3)
                    if not isinstance(cmd, dict) or 6 not in chunk \
                            or 4 not in chunk:
                        continue
                    name = b".".join(cmd.get(3) or []).decode("utf-8", "replace")
                    out[(rg, name)] = (chunk[6], chunk.get(7),
                                       chunk[4], chunk.get(5), cmd.get(1))
        except (OSError, ValueError, KeyError, IndexError, struct.error):
            out = {}
        self._offsets = out
        return out

    def has_index(self, rg: int, column: str) -> bool:
        return (rg, column) in self._load()

    def page_bounds(self, rg: int, column: str, logical_type: str,
                    rg_rows: int):
        """[(row_start, row_end, lo, hi, null_count, all_null)] per page of
        the column chunk, in logical values; None when absent/undecodable."""
        ent = self._load().get((rg, column))
        if ent is None:
            return None
        ci_off, ci_len, oi_off, oi_len, ptype = ent
        if ci_len is None or oi_len is None or ptype is None:
            return None
        try:
            with self._open(self.path) as f:
                f.seek(ci_off)
                ci, _ = parse_struct(f.read(ci_len))
                f.seek(oi_off)
                oi, _ = parse_struct(f.read(oi_len))
        except (OSError, ValueError, IndexError, struct.error):
            return None
        null_pages = ci.get(1) or []
        mins, maxs = ci.get(2) or [], ci.get(3) or []
        null_counts = ci.get(5)
        locs = oi.get(1) or []
        n = len(locs)
        if not (len(null_pages) == len(mins) == len(maxs) == n) or n == 0:
            return None
        starts = [loc.get(3, 0) for loc in locs]
        ends = starts[1:] + [rg_rows]
        out = []
        for i in range(n):
            if null_pages[i]:
                lo = hi = None
                allnull = True
            else:
                lo = _decode_plain(mins[i], ptype, logical_type)
                hi = _decode_plain(maxs[i], ptype, logical_type)
                allnull = False
                if lo is None or hi is None:
                    lo = hi = None  # undecodable: page stays UNKNOWN
            nc = null_counts[i] if null_counts else None
            out.append((starts[i], ends[i], lo, hi, nc, allnull))
        return out


def prune_rows(pi: PageIndex, rg: int, rg_rows: int, filters,
               rg_stats: Dict, logical_types: Dict[str, str]):
    """Boolean keep-mask over the row group's rows after page-level pruning,
    or None when no page can be excluded. Each predicate is evaluated per
    page with that column's page interval substituted into the row-group
    stats (other columns keep their rg-level intervals)."""
    from .parquet import FALSE, ColStats, eval_predicate
    from ..expr import nodes as E

    mask = None
    for p in filters:
        cols = {c.cname for c in E.collect_columns(p)}
        for col in cols:
            bounds = pi.page_bounds(rg, col, logical_types.get(col, ""),
                                    rg_rows) if pi.has_index(rg, col) else None
            if not bounds or len(bounds) <= 1:
                continue
            for (r0, r1, lo, hi, nc, allnull) in bounds:
                page_rows = max(r1 - r0, 1)
                st = dict(rg_stats)
                st[col] = ColStats(lo, hi,
                                   page_rows if allnull else nc, page_rows)
                if eval_predicate(p, st) is FALSE:
                    if mask is None:
                        mask = np.ones(rg_rows, dtype=bool)
                    mask[r0:r1] = False
    if mask is not None and mask.all():
        return None
    return mask
