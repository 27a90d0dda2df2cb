# Verbatim copy of datafusion_tpu/io/object_store.py; host-only, kept in step with the original.
"""Object-store abstraction + registry.

Capability analog of the reference's ObjectStoreRegistry
(datafusion/execution/src/object_store.rs:1-334): every data-source path is
resolved through a registry keyed by URL scheme (+ bucket/authority), so
scans work identically over the local filesystem, an in-memory store, or a
user-registered remote store. The reference delegates the actual transports
to the `object_store` crate; here the local filesystem and an in-memory
store ship built-in (this image has no network egress -- S3/GCS/HTTP slots
exist for user implementations via register_object_store).

Store interface (the minimal surface the scan stack needs):
  * list(prefix)            -> [(path, size)] under a directory-ish prefix
  * is_dir(path)            -> bool
  * open(path)              -> seekable binary file-like (parquet footers,
                               bloom filters and page indexes read ranges)
  * read(path)              -> bytes (whole object, for row-group reads via
                               pyarrow on non-local stores)
  * mtime(path)             -> listing-cache invalidation token
"""
from __future__ import annotations

import io
import os
import threading
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..common.errors import PlanError


class ObjectStore:
    scheme = "abstract"

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def open(self, path: str):
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        with self.open(path) as f:
            return f.read()

    def mtime(self, path: str) -> float:
        return 0.0


class LocalFileSystem(ObjectStore):
    scheme = "file"

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        out = []
        if os.path.isfile(prefix):
            return [(prefix, os.path.getsize(prefix))]
        for root, _dirs, names in sorted(os.walk(prefix)):
            for f in sorted(names):
                p = os.path.join(root, f)
                try:
                    out.append((p, os.path.getsize(p)))
                except OSError:
                    pass
        return out

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def open(self, path: str):
        return open(path, "rb")

    def mtime(self, path: str) -> float:
        try:
            return os.path.getmtime(path)
        except OSError:
            return 0.0


class InMemoryStore(ObjectStore):
    """Blob dict behind memory:// URLs -- the test double for remote stores
    (reference: object_store::memory::InMemory used all over the
    reference's own tests)."""

    scheme = "memory"

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self._version = 0

    def put(self, path: str, data: bytes) -> None:
        with self._lock:
            self._blobs[path.lstrip("/")] = bytes(data)
            self._version += 1

    def list(self, prefix: str) -> List[Tuple[str, int]]:
        p = prefix.lstrip("/")
        with self._lock:
            return sorted((k, len(v)) for k, v in self._blobs.items()
                          if k == p or k.startswith(p.rstrip("/") + "/")
                          or p == "")

    def is_dir(self, path: str) -> bool:
        p = path.lstrip("/").rstrip("/")
        with self._lock:
            return any(k.startswith(p + "/") for k in self._blobs) or p == ""

    def open(self, path: str):
        p = path.lstrip("/")
        with self._lock:
            data = self._blobs.get(p)
        if data is None:
            raise FileNotFoundError(path)
        return io.BytesIO(data)

    def mtime(self, path: str) -> float:
        return float(self._version)


class ObjectStoreRegistry:
    """scheme[://authority] -> ObjectStore. Bare paths resolve to the local
    filesystem (reference: DefaultObjectStoreRegistry's object_store_url
    keying)."""

    def __init__(self):
        self._stores: Dict[str, ObjectStore] = {}
        self._local = LocalFileSystem()

    def register(self, url: str, store: ObjectStore) -> None:
        u = urlparse(url if "://" in url else url + "://")
        self._stores[f"{u.scheme}://{u.netloc}"] = store

    def resolve(self, path: str) -> Tuple[ObjectStore, str]:
        """(store, store-local path) for a path or URL."""
        if "://" not in path:
            return self._local, path
        u = urlparse(path)
        if u.scheme == "file":
            return self._local, u.path
        store = self._stores.get(f"{u.scheme}://{u.netloc}") \
            or self._stores.get(f"{u.scheme}://")
        if store is None:
            raise PlanError(
                f"no object store registered for scheme {u.scheme!r}; "
                f"register one with SessionContext.register_object_store")
        return store, (f"/{u.netloc}{u.path}" if False else u.path) or "/"


_DEFAULT = ObjectStoreRegistry()


def default_registry() -> ObjectStoreRegistry:
    return _DEFAULT


def resolve(path: str) -> Tuple[ObjectStore, str]:
    return _DEFAULT.resolve(path)
