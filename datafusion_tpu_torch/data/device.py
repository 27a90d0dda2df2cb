"""Device-resident relations: capacity-padded columns + selection masks.

Port of datafusion_tpu/data/device.py to torch tensors. The layout is kept
as it is so that operator outputs compare slot by slot with the reference:

* a DeviceRelation holds one tensor per column, all padded to ONE
  power-of-two `capacity` (bucket_capacity), plus a bool selection mask
  `sel` marking live rows. Filters only flip mask bits.
* a DeviceColumn is (data, validity, dtype, dictionary, bounds, lengths,
  elem_valid, meta):
    - scalar columns: data [capacity], optional bool validity [capacity]
      (padded/NULL slots hold 0 in data);
    - string columns: data are int32 codes into a host-side SORTED
      Dictionary (order-preserving, so comparisons/sorts work on codes);
    - list columns: data [capacity, width] (a List(List) column: [capacity,
      width, w2], inner lists at full width), int32 `lengths`, bool
      `elem_valid` [capacity, width];
    - struct and map columns: int32 codes into a sorted dictionary of value
      tuples (data/column.py), like strings;
    - `bounds` is optional static (lo, hi) interval metadata over the device
      representation (always containing 0, the padding value); the dense
      aggregation kernel path uses it to prove factors fit int32.

Tensors live on one torch device. Entry points default to the CUDA card
(`resolve_device`); callers that want the CPU pass it explicitly.
"""
from __future__ import annotations

import gc
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from .column import Dictionary, HostColumn
from .table import Table

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """torch dtype of a numpy dtype (or of a logical type's device
    representation)."""
    if isinstance(dt, T.DataType):
        dt = dt.np_dtype()
    try:
        return _TORCH_DTYPES[np.dtype(dt)]
    except KeyError:
        raise PlanError(f"no device dtype for {dt}") from None


def is_integer(t: torch.Tensor) -> bool:
    """Integer (not bool, not float) tensor."""
    return not t.dtype.is_floating_point and not t.dtype.is_complex \
        and t.dtype is not torch.bool


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None; raises when this process
    has no card (pass a device such as "cpu" explicitly to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "datafusion_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "on the CPU")
    return torch.device("cuda")


def bucket_capacity(n: int) -> int:
    """Smallest power of two >= n, with a floor of 128."""
    n = max(int(n), 1)
    return max(1 << (n - 1).bit_length(), 128)


class DeviceColumn:
    """One column on device; see module docstring for the layout."""

    __slots__ = ("data", "validity", "dtype", "dictionary", "bounds",
                 "lengths", "elem_valid", "meta")

    def __init__(self, data, validity=None, dtype: Optional[T.DataType] = None,
                 dictionary: Optional[Dictionary] = None,
                 bounds: Optional[Tuple[int, int]] = None,
                 lengths=None, elem_valid=None, meta=None):
        self.data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary
        self.bounds = bounds
        self.lengths = lengths
        self.elem_valid = elem_valid
        # host-side rendering tag, e.g. ("string_agg", delim): a [capacity,
        # W] code matrix whose rows to_host joins with delim
        self.meta = meta

    def sort_bounds(self) -> Optional[Tuple[int, int]]:
        """(lo, hi) covering the column's whole physical device array (dead
        slots included), for packing this column as a fixed-width field of a
        single int64 sort key: integer interval bounds, the code range of
        dictionary-encoded strings, (0, 1) for bools. None when unbounded."""
        if self.data.ndim != 1:
            return None
        if self.dictionary is not None:
            return (0, max(int(self.dictionary.size) - 1, 0))
        if self.data.dtype is torch.bool:
            return (0, 1)
        if self.bounds is not None and is_integer(self.data):
            return (int(self.bounds[0]), int(self.bounds[1]))
        return None

    # ---- shape -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def width(self) -> int:
        """List width (1 for scalar columns)."""
        return int(self.data.shape[1]) if self.data.ndim >= 2 else 1

    def valid(self) -> torch.Tensor:
        """The validity mask, all True when the column has none."""
        if self.validity is not None:
            return self.validity
        return torch.ones(self.data.shape[0], dtype=torch.bool, device=self.data.device)

    def slot_valid(self) -> torch.Tensor:
        """[capacity, width] mask of the live list slots."""
        if self.elem_valid is not None:
            return self.elem_valid
        cap, w, dev = self.data.shape[0], self.width, self.data.device
        if self.lengths is not None:
            return torch.arange(w, dtype=torch.int32, device=dev)[None, :] \
                < self.lengths[:, None]
        return torch.ones((cap, w), dtype=torch.bool, device=dev)

    def list_lengths(self) -> torch.Tensor:
        """Per-row list length (int32)."""
        if self.lengths is not None:
            return self.lengths
        if self.elem_valid is not None:
            return self.elem_valid.sum(1, dtype=torch.int32)
        return torch.full((self.data.shape[0],), self.width, dtype=torch.int32,
                          device=self.data.device)

    # ---- metadata ----------------------------------------------------------
    def fits_i32(self) -> bool:
        """True when every value (including the 0 padding) provably fits
        int32 -- from the device dtype or the static bounds interval."""
        if self.data.dtype in (torch.bool, torch.int8, torch.int16,
                               torch.int32, torch.uint8):
            return True
        if self.bounds is None:
            return False
        lo, hi = self.bounds
        return lo >= _I32_MIN and hi <= _I32_MAX

    def __repr__(self) -> str:
        shape = tuple(self.data.shape)
        return (f"DeviceColumn({self.dtype!r}, shape={shape}, "
                f"nullable={self.validity is not None})")


class DeviceRelation:
    """A set of equally-padded DeviceColumns + the live-row selection mask."""

    __slots__ = ("schema", "columns", "sel")

    def __init__(self, schema: Schema, columns: Sequence[DeviceColumn], sel):
        self.schema = schema
        self.columns = tuple(columns)
        self.sel = sel

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def num_rows(self):
        """Live row count (0-d int64 tensor)."""
        return self.sel.sum(dtype=torch.int64)

    def with_sel(self, sel) -> "DeviceRelation":
        return DeviceRelation(self.schema, self.columns, sel)

    def column(self, name: str) -> DeviceColumn:
        i = self.schema.find(name)
        if i is None:
            raise PlanError(
                f"column {name!r} not found; available: "
                f"{[f.qualified_name for f in self.schema.fields]}")
        return self.columns[i]

    def __repr__(self) -> str:
        return f"DeviceRelation[cap={self.capacity}, {self.schema!r}]"


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def table_bounds(table: Table) -> List[Optional[Tuple[int, int]]]:
    """Per-column (lo, hi) device-representation bounds for integer-like
    columns (always containing 0, the padding value); None elsewhere."""
    out: List[Optional[Tuple[int, int]]] = []
    for f, c in zip(table.schema.fields, table.columns):
        t = f.dtype
        if not (t.is_integer or t.is_decimal or t.is_temporal):
            out.append(None)
            continue
        data = np.asarray(c.data)
        if data.dtype == object or data.ndim != 1:
            out.append(None)
            continue
        live = data if c.validity is None else data[c.validity]
        if live.size == 0:
            out.append((0, 0))
            continue
        out.append((min(int(live.min()), 0), max(int(live.max()), 0)))
    return out


def _list_device_arrays(rows: np.ndarray, elem: T.DataType, cap: int):
    """Pad an object array of per-row lists to [cap, width] + lengths +
    elem_valid. A List(List) column becomes [cap, width, w2]: the inner
    lists are padded the same way and their lengths dropped (one level of
    length metadata, as in the reference)."""
    n = len(rows)
    width = max([1] + [len(r) for r in rows if r is not None])
    if elem.is_list:
        inner = np.empty(n * width, dtype=object)
        for i in range(n):
            r = rows[i]
            for j in range(width):
                inner[i * width + j] = r[j] if r is not None and j < len(r) else None
        idata, _, _ = _list_device_arrays(inner, elem.elem, n * width)
        data = np.zeros((cap, width, idata.shape[1]), dtype=idata.dtype)
        data[:n] = idata.reshape(n, width, idata.shape[1])
    else:
        data = np.zeros((cap, width), dtype=elem.np_dtype())
    ev = np.zeros((cap, width), dtype=bool)
    lengths = np.zeros(cap, dtype=np.int32)
    for i in range(n):
        r = rows[i]
        if r is None:
            continue
        lengths[i] = len(r)
        for j, x in enumerate(r):
            if x is not None:
                if not elem.is_list:
                    data[i, j] = x
                ev[i, j] = True
    return data, lengths, ev


def _tensor(a: Optional[np.ndarray], device: torch.device):
    if a is None:
        return None
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch would alias a read-only buffer
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_device(table: Table, capacity: Optional[int] = None, device=None,
              row_range: Optional[Tuple[int, int]] = None,
              bounds: Optional[List[Optional[Tuple[int, int]]]] = None
              ) -> DeviceRelation:
    """Upload a host Table as a capacity-padded DeviceRelation on `device`
    (default: the CUDA card).

    row_range=(lo, hi) uploads only that slice; `bounds` overrides the
    computed per-column bounds. NULL slots are normalized to 0 in data (the
    padding value), so bounds always contain 0."""
    device = resolve_device(device)
    lo, hi = row_range if row_range is not None else (0, table.num_rows)
    n = hi - lo
    cap = capacity if capacity is not None else bucket_capacity(max(n, 1))
    if n > cap:
        raise PlanError(f"row range {n} exceeds capacity {cap}")
    if bounds is None:
        bounds = table_bounds(table)

    cols: List[DeviceColumn] = []
    for f, c, b in zip(table.schema.fields, table.columns, bounds):
        t = f.dtype
        validity = None
        if c.validity is not None:
            validity = np.zeros(cap, dtype=bool)
            validity[:n] = c.validity[lo:hi]
        if t.is_list:
            data, lengths, ev = _list_device_arrays(c.data[lo:hi], t.elem, cap)
            cols.append(DeviceColumn(_tensor(data, device),
                                     _tensor(validity, device), t,
                                     c.dictionary, None,
                                     _tensor(lengths, device),
                                     _tensor(ev, device)))
            continue
        data = np.zeros(cap, dtype=t.np_dtype())
        chunk = np.asarray(c.data[lo:hi])
        if chunk.dtype != data.dtype:
            chunk = chunk.astype(data.dtype)
        if c.validity is not None:
            chunk = np.where(c.validity[lo:hi], chunk, data.dtype.type(0))
        data[:n] = chunk
        cols.append(DeviceColumn(_tensor(data, device),
                                 _tensor(validity, device), t, c.dictionary, b))

    sel = np.zeros(cap, dtype=bool)
    sel[:n] = True
    return DeviceRelation(table.schema, tuple(cols), _tensor(sel, device))


def _download(tensors: Sequence[Optional[torch.Tensor]]):
    """(the tensors as numpy arrays, whether those arrays are fresh buffers
    no one else holds). From a CUDA device: one non-blocking copy each into
    new pinned host memory, then ONE wait for the stream (the counterpart of
    the reference's single jax.device_get); a pinned buffer goes back to
    torch's host cache when its last array dies. On the CPU: views of the
    tensors themselves."""
    live = [t for t in tensors if t is not None]
    if not live or live[0].device.type != "cuda":
        return [None if t is None else t.detach().numpy() for t in tensors], False
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out.append(host)
    torch.cuda.current_stream(live[0].device).synchronize()
    return [None if h is None else h.numpy() for h in out], True


def to_host(rel: DeviceRelation) -> Table:
    """Download a DeviceRelation as a host Table holding only the LIVE rows
    (in capacity order). When the live rows are a prefix of the capacity (a
    compacted or aggregated result) and the arrays are fresh downloads, the
    columns are views of them; otherwise boolean indexing copies them. Every
    tensor, list lengths and slot masks included, comes down in the one
    batched copy."""
    parts = [rel.sel]
    for c in rel.columns:
        parts.extend((c.data, c.validity, c.lengths, c.elem_valid))
    host, fresh = _download(parts)
    sel = host[0]
    n = int(np.count_nonzero(sel))
    if fresh and sel[:n].all():
        def live(a):
            return a[:n]
    else:
        def live(a):
            return a[sel]
    cols: List[HostColumn] = []
    for i, (f, c) in enumerate(zip(rel.schema.fields, rel.columns)):
        data, validity, lengths, elem_valid = host[1 + 4 * i:5 + 4 * i]
        v = None if validity is None else live(validity)
        if c.meta is not None and c.meta[0] == "string_agg":
            cols.append(_joined_strings(f.dtype, c, live(data), v,
                                        None if lengths is None else live(lengths)))
            continue
        if f.dtype.is_list:
            if lengths is None:
                lengths = (elem_valid.sum(1).astype(np.int32) if elem_valid is not None
                           else np.full(data.shape[0], data.shape[1], dtype=np.int32))
            ev = (elem_valid if elem_valid is not None else
                  np.arange(data.shape[1])[None, :] < lengths[:, None])
            rows = _list_rows(live(data), live(lengths), live(ev))
            if v is not None:
                for r in np.nonzero(~v)[0]:
                    rows[r] = None
            cols.append(HostColumn(f.dtype, rows, v, c.dictionary))
            continue
        cols.append(HostColumn(f.dtype, live(data), v, c.dictionary))
    return Table(rel.schema, cols)


def _list_rows(data: np.ndarray, lengths: np.ndarray, ev: np.ndarray) -> np.ndarray:
    """One Python list per row: its first `lengths` slots, a slot that is
    not valid as None. Nested lists (3-D data) render their inner lists at
    full width. The cyclic garbage collector is paused meanwhile: with it
    on, making 1.5M small lists costs about 8x as much."""
    lengths = np.minimum(lengths.astype(np.int64), data.shape[1])
    within = np.arange(data.shape[1])[None, :] < lengths[:, None]
    ends = np.cumsum(lengths)
    on = gc.isenabled()
    gc.disable()
    try:
        flat = data[within].tolist()  # the slots within each list, row by row
        rows = list(map(flat.__getitem__, map(slice, (ends - lengths).tolist(),
                                              ends.tolist())))
        for r in np.nonzero(~(ev | ~within).all(axis=1))[0].tolist():  # NULL elements
            rows[r] = [x if e else None
                       for x, e in zip(rows[r], ev[r, :len(rows[r])].tolist())]
        return np.fromiter(rows, dtype=object, count=len(rows))
    finally:
        if on:
            gc.enable()


def _joined_strings(dtype: T.DataType, c: DeviceColumn, codes: np.ndarray,
                    validity: Optional[np.ndarray],
                    lengths: Optional[np.ndarray]) -> HostColumn:
    """A ("string_agg", delim) column: each row's first `lengths` codes,
    decoded through the dictionary and joined with delim (the device makes
    no new strings)."""
    from .column import column_from_values

    delim = c.meta[1]
    words = [str(w) for w in c.dictionary.values] if c.dictionary is not None else []
    if lengths is None:
        lengths = np.full(len(codes), codes.shape[1], dtype=np.int32)
    ok = [True] * len(codes) if validity is None else validity.tolist()
    rows = [delim.join(words[k] for k in row[:ln]) if good else None
            for row, ln, good in zip(codes.tolist(), lengths.tolist(), ok)]
    return column_from_values(rows, dtype)


def empty_relation(schema: Schema, device=None) -> DeviceRelation:
    """An all-dead relation of minimal capacity (every column NULL-capable,
    so PlaceholderRow semantics read NULL from any column)."""
    device = resolve_device(device)
    cap = bucket_capacity(1)
    validity = torch.zeros(cap, dtype=torch.bool, device=device)
    cols: List[DeviceColumn] = []
    for f in schema.fields:
        t = f.dtype
        d = Dictionary(np.array([], dtype=object)) if t.is_string else None
        if t.is_list:
            et = torch_dtype(t.elem)
            cols.append(DeviceColumn(
                torch.zeros((cap, 1), dtype=et, device=device), validity, t, d,
                None, torch.zeros(cap, dtype=torch.int32, device=device),
                torch.zeros((cap, 1), dtype=torch.bool, device=device)))
        else:
            cols.append(DeviceColumn(
                torch.zeros(cap, dtype=torch_dtype(t), device=device),
                validity, t, d, (0, 0) if _boundable(t) else None))
    sel = torch.zeros(cap, dtype=torch.bool, device=device)
    return DeviceRelation(schema, tuple(cols), sel)


def _boundable(t: T.DataType) -> bool:
    return t.is_integer or t.is_decimal or t.is_temporal


# ---------------------------------------------------------------------------
# construction from numpy leaves (differential tests, data handed across)
# ---------------------------------------------------------------------------


def relation_from_numpy(schema: Schema, columns, sel: np.ndarray,
                        device=None) -> DeviceRelation:
    """A DeviceRelation from numpy leaves. `columns` holds one tuple
    (data, validity_or_None, dictionary_values_or_None, bounds_or_None) per
    schema field; this is how a reference relation's leaves are fed to the
    port's operators."""
    device = resolve_device(device)
    if len(columns) != len(schema.fields):
        raise PlanError(f"{len(columns)} columns for a "
                        f"{len(schema.fields)}-field schema")
    cols = []
    for f, (data, validity, dict_values, bounds) in zip(schema.fields, columns):
        d = None if dict_values is None else Dictionary(dict_values)
        b = None if bounds is None else (int(bounds[0]), int(bounds[1]))
        cols.append(DeviceColumn(_tensor(np.asarray(data), device),
                                 _tensor(None if validity is None
                                         else np.asarray(validity, bool),
                                         device),
                                 f.dtype, d, b))
    return DeviceRelation(schema, cols, _tensor(np.asarray(sel, bool), device))


def table_from_numpy(fields, data, validity=None, dictionaries=None) -> Table:
    """A host Table from numpy columns. `fields` are (name, DataType) pairs
    or Fields; `validity` and `dictionaries` are optional per-column lists
    (None entries allowed) of bool masks and dictionary values."""
    from ..common.schema import Field

    n = len(data)
    validity = list(validity) if validity is not None else [None] * n
    dictionaries = (list(dictionaries) if dictionaries is not None
                    else [None] * n)
    fs, cols = [], []
    for f, d, v, dv in zip(fields, data, validity, dictionaries):
        if not isinstance(f, Field):
            f = Field(f[0], f[1], nullable=v is not None)
        fs.append(f)
        cols.append(HostColumn(f.dtype, np.asarray(d), v,
                               None if dv is None else Dictionary(dv)))
    return Table(Schema(fs), cols)
