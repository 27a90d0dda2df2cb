# Verbatim copy of datafusion_tpu/native/__init__.py; host-only, kept in step with the original.
"""Native (C++) host-side kernels, loaded via ctypes.

Compiled on first use into ~/.cache/datafusion_tpu_native/libdictenc.so;
falls back to numpy implementations when no C++ toolchain is available."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_dir() -> str:
    d = os.environ.get("DATAFUSION_TPU_NATIVE_DIR",
                       os.path.expanduser("~/.cache/datafusion_tpu_native"))
    os.makedirs(d, exist_ok=True)
    return d


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(os.path.dirname(__file__), "dictenc.cpp")
        so = os.path.join(_build_dir(), "libdictenc.so")
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", so],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(so)
            lib.dict_encode.restype = ctypes.c_int64
            lib.dict_encode.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.dict_total_bytes.restype = ctypes.c_int64
            lib.dict_extract.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def dict_encode_arrow(arr) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Dictionary-encode a pyarrow StringArray with the native encoder.

    Returns (codes[int32], sorted_values[np object array]) or None if the
    native library is unavailable / the array has an unsupported layout.
    """
    lib = load_library()
    if lib is None:
        return None
    import pyarrow as pa

    if arr.null_count:
        # keep nulls on the numpy fallback path for now
        return None
    buffers = arr.buffers()
    if len(buffers) < 3 or buffers[2] is None:
        return None
    if arr.offset != 0:
        arr = arr.combine_chunks() if hasattr(arr, "combine_chunks") else arr
        if arr.offset != 0:
            return None
    offsets = np.frombuffer(buffers[1], dtype=np.int32, count=len(arr) + 1)
    offsets64 = offsets.astype(np.int64)
    values = bytes(buffers[2])  # contiguous utf-8
    n = len(arr)
    codes = np.empty(n, dtype=np.int32)
    k = lib.dict_encode(
        values,
        offsets64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    total = lib.dict_total_bytes()
    buf = ctypes.create_string_buffer(int(total))
    out_offsets = np.empty(k + 1, dtype=np.int64)
    lib.dict_extract(buf, out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    raw = buf.raw[:total]
    vals = np.empty(k, dtype=object)
    try:
        s = raw.decode("ascii")  # byte offsets == char offsets
        for i in range(k):
            vals[i] = s[out_offsets[i]:out_offsets[i + 1]]
    except UnicodeDecodeError:
        for i in range(k):
            vals[i] = raw[out_offsets[i]:out_offsets[i + 1]].decode("utf-8")
    return codes, vals
