# Verbatim copy of datafusion_tpu/interchange/ffi.py; host-only, kept in step with the original.
"""Dynamic-library plugin loading over a stable C ABI.

Capability analog of the reference's `datafusion-ffi` crate
(ffi/src/lib.rs:28-55): plugins are shared libraries exporting
`dft_plugin_init(DftRegistry*)` (see native/plugin.h); they register table
providers — whose data crosses the boundary as Arrow record batches through
the Arrow C Data Interface, exactly like the reference FFI — and vectorized
scalar functions. The host side here is ctypes; no compiler or Python
headers are needed at load time."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Tuple

from ..common.errors import PlanError

ABI_VERSION = 1

# Arrow C Data Interface structs (consumer side: we only allocate zeroed
# memory for the producer to fill, then hand addresses to pyarrow).
_SCHEMA_NBYTES = 72   # sizeof(struct ArrowSchema) on LP64
_ARRAY_NBYTES = 80    # sizeof(struct ArrowArray) on LP64

_SCAN_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p)
_SCALAR_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
                              ctypes.c_int32,
                              ctypes.POINTER(ctypes.c_double),
                              ctypes.c_int64)
_REG_TABLE_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_char_p, ctypes.c_void_p, _SCAN_FN)
_REG_SCALAR_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_char_p, ctypes.c_int32,
                                  ctypes.c_void_p, _SCALAR_FN)


class _DftRegistry(ctypes.Structure):
    _fields_ = [
        ("abi_version", ctypes.c_uint32),
        ("host", ctypes.c_void_p),
        ("register_table", _REG_TABLE_FN),
        ("register_scalar_f64", _REG_SCALAR_FN),
    ]


def _scan_record_batch(scan: _SCAN_FN, user: int):
    """Call a plugin scan and import the filled ArrowSchema/ArrowArray."""
    import pyarrow as pa

    schema_buf = ctypes.create_string_buffer(_SCHEMA_NBYTES)
    array_buf = ctypes.create_string_buffer(_ARRAY_NBYTES)
    rc = scan(user, ctypes.addressof(schema_buf), ctypes.addressof(array_buf))
    if rc != 0:
        raise PlanError(f"plugin scan failed with code {rc}")
    return pa.RecordBatch._import_from_c(ctypes.addressof(array_buf),
                                         ctypes.addressof(schema_buf))


class PluginTable:
    """Lazy TableProvider over a plugin scan callback."""

    def __init__(self, name: str, scan: _SCAN_FN, user: int):
        self._name = name
        self._scan = scan
        self._user = user
        self._table = None
        self._device: Dict = {}

    def _host(self):
        from ..data.table import Table

        if self._table is None:
            rb = _scan_record_batch(self._scan, self._user)
            import pyarrow as pa

            self._table = Table.from_arrow(pa.Table.from_batches([rb]))
        return self._table

    def schema(self):
        return self._host().schema

    def host_table(self):
        return self._host()

    def scan_device(self, ctx, filters=(), projection=None):
        from ..data.device import to_device

        key = (ctx.device if ctx else None,)
        if key not in self._device:
            self._device[key] = to_device(self._host(),
                                          device=ctx.device if ctx else None)
        return self._device[key]

    def statistics(self) -> Dict:
        return {"num_rows": self._host().num_rows}


class LoadedPlugin:
    """Keeps the dlopened library and every ctypes callback alive."""

    def __init__(self, path: str):
        self.path = path
        self.lib = ctypes.CDLL(path)
        self.tables: List[Tuple[str, PluginTable]] = []
        self.scalars: List[Tuple[str, int, Callable]] = []
        self._keepalive: list = []

    def init(self) -> None:
        try:
            entry = self.lib.dft_plugin_init
        except AttributeError:
            raise PlanError(
                f"{self.path}: missing dft_plugin_init export") from None
        entry.restype = ctypes.c_int
        entry.argtypes = [ctypes.POINTER(_DftRegistry)]

        @_REG_TABLE_FN
        def reg_table(_host, name, user, scan):
            pname = name.decode()
            self.tables.append((pname, PluginTable(pname, scan, user)))
            self._keepalive.append(scan)
            return 0

        @_REG_SCALAR_FN
        def reg_scalar(_host, name, nargs, user, fn):
            self.scalars.append((name.decode(), int(nargs),
                                 _wrap_scalar(fn, user, int(nargs))))
            self._keepalive.append(fn)
            return 0

        reg = _DftRegistry(ABI_VERSION, None, reg_table, reg_scalar)
        self._keepalive.extend([reg_table, reg_scalar, reg])
        rc = entry(ctypes.byref(reg))
        if rc != 0:
            raise PlanError(f"{self.path}: dft_plugin_init returned {rc}")


def _wrap_scalar(fn: _SCALAR_FN, user: int, nargs: int) -> Callable:
    """Host batch function (numpy f64 in/out) over the C pointer."""
    import numpy as np

    def call(*arrays):
        if len(arrays) != nargs:
            raise PlanError(f"plugin scalar expects {nargs} args, "
                            f"got {len(arrays)}")
        ins = [np.ascontiguousarray(np.asarray(a, dtype=np.float64))
               for a in arrays]
        n = len(ins[0]) if ins else 0
        out = np.empty(n, dtype=np.float64)
        ptrs = (ctypes.POINTER(ctypes.c_double) * max(nargs, 1))(
            *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in ins])
        fn(user, ptrs, nargs, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)), n)
        return out

    return call


def load_plugin(ctx, path: str) -> Dict[str, list]:
    """Load a plugin shared library into a SessionContext: its tables appear
    in the catalog and its scalar functions become SQL-callable. Returns
    {"tables": [...], "scalars": [...]} with the registered names."""
    from ..common import types as T

    plugin = LoadedPlugin(path)
    plugin.init()
    for name, provider in plugin.tables:
        ctx.catalog.register(name, provider)
    for name, _nargs, call in plugin.scalars:
        ctx.register_async_udf(name, call, T.DataType(T.TypeKind.FLOAT64))
    # keep callbacks alive for the session's lifetime
    ctx._plugins = getattr(ctx, "_plugins", [])
    ctx._plugins.append(plugin)
    return {"tables": [n for n, _p in plugin.tables],
            "scalars": [n for n, _a, _c in plugin.scalars]}
