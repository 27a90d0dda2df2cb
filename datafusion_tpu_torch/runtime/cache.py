# Verbatim copy of datafusion_tpu/runtime/cache.py; host-only, kept in step with the original.
"""Session/process-level metadata caches.

Capability analog of the reference's CacheManager
(datafusion/execution/src/cache/cache_manager.rs:307 + lru_queue.rs): a
list-files cache, a file-statistics cache, and a parquet-metadata cache, each
an LRU keyed by path and invalidated by (mtime, size) so external rewrites of
a file are noticed. The default process-wide manager is shared by every
ParquetDataset/discover call; sessions can install their own sized manager."""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple


class LruCache:
    """O(1) LRU with hit/miss counters (reference: lru_queue.rs)."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = max_entries
        self._d: "OrderedDict[Any, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def get_or(self, key, compute: Callable[[], Any]):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        value = compute()
        self.put(key, value)
        return value

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


def _fingerprint(path: str) -> Tuple[float, int]:
    st = os.stat(path)
    return (st.st_mtime, st.st_size)


class CacheManager:
    """Three caches, mirroring the reference's cache_manager.rs surface:
    list_files (directory walks), file_stats (per-dataset column statistics),
    parquet_meta (open pq.ParquetFile handles, footer parsed once)."""

    def __init__(self, list_entries: int = 64, stats_entries: int = 256,
                 meta_entries: int = 1024):
        self.list_files = LruCache(list_entries)
        self.file_stats = LruCache(stats_entries)
        self.parquet_meta = LruCache(meta_entries)

    # -- parquet footers ----------------------------------------------------

    def parquet_file(self, path: str):
        """A pq.ParquetFile with its footer parsed, shared across datasets
        and sessions; re-opened if the file changed on disk."""
        fp = _fingerprint(path)
        cached = self.parquet_meta.get(path)
        if cached is not None and cached[0] == fp:
            return cached[1]
        import pyarrow.parquet as pq

        pf = pq.ParquetFile(path)
        self.parquet_meta.put(path, (fp, pf))
        return pf

    # -- directory listings ---------------------------------------------------

    def listing(self, path: str, exts: tuple, compute: Callable[[], Any]):
        """Cache a directory walk keyed by (path, exts, dir mtime). File
        additions/removals bump the directory mtime and invalidate."""
        try:
            fp = _fingerprint(path)
        except OSError:
            return compute()
        key = (path, exts)
        cached = self.list_files.get(key)
        if cached is not None and cached[0] == fp:
            return cached[1]
        value = compute()
        self.list_files.put(key, (fp, value))
        return value

    # -- statistics -----------------------------------------------------------

    def stats(self, key, compute: Callable[[], Any]):
        return self.file_stats.get_or(key, compute)

    def metrics(self) -> dict:
        return {name: {"entries": len(c), "hits": c.hits, "misses": c.misses}
                for name, c in (("list_files", self.list_files),
                                ("file_stats", self.file_stats),
                                ("parquet_meta", self.parquet_meta))}


_DEFAULT: Optional[CacheManager] = None


def default_cache_manager() -> CacheManager:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = CacheManager()
    return _DEFAULT


def set_default_cache_manager(mgr: Optional[CacheManager]) -> None:
    global _DEFAULT
    _DEFAULT = mgr
