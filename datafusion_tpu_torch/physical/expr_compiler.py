"""Vectorized expression evaluation over device relations.

Port of datafusion_tpu/physical/expr_compiler.py to eager torch ops. Each
logical Expr evaluates to a DeviceColumn with Arrow-style null semantics
(three-valued AND/OR, null-propagating arithmetic and comparison); dictionary
work (dictionary merges, string literals, IN lists) runs on the host once per
dictionary (`dictionary_work`) and becomes small index tensors on the
relation's device. A comparison of a dictionary column with a string literal
compares codes with the literal's position in the sorted dictionary.

Ported: columns, literals, aliases, sort keys, numeric/decimal/temporal
casts, casts of strings to numbers, DATE32, TIMESTAMP and TIME (each
dictionary value parsed once; a comparison of a string with a temporal value
casts the string side), UTF8 <-> BINARY (a re-encoded dictionary, invalid
values NULL), casts of numbers, booleans and temporal values to strings and
to_char (string_cast_column: a dictionary of the live values rendered at
discovery, a sorted-table lookup per row), negation, NOT, IS NULL, binary
operators (logic, comparison, arithmetic, decimal and date arithmetic),
BETWEEN, IN lists, LIKE (a host regex over the dictionary, gathered per
row), CASE, interval bounds propagation and predicates, the scalar
functions of physical/functions.py and the list, struct, map and lambda
functions of physical/nested.py.

While the steady state's walker runs (physical/fused.py), it installs its
overflow-flag list and a dict of values fixed for the life of that steady
state (set_flag_sink): a string cast whose value table misses a live value
appends a flag, which sends the query back to discovery, and the clock
functions read the time once per steady state (steady_value).
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import PlanError
from ..common.schema import Schema
from ..data.column import Dictionary
from ..data.device import DeviceColumn, DeviceRelation, is_integer, torch_dtype
from ..expr import nodes as E
from ..expr.typing import arith_result
from ..utils import dates as DU

# Host work over string dictionaries runs once per dictionary, not once per
# execution: merges, LIKE and IN-list tables, substring remaps, literal
# dictionaries and literal positions are kept in one bounded LRU keyed by the
# identities of the dictionaries they read, the operation and its literal
# arguments. An entry holds its dictionaries, so no other object can take
# their ids while it lives, and the lookup tables it has copied to each
# device, so that a steady state (physical/fused.py) finds every table
# already there: a copy from pageable host memory is a host sync, and
# illegal inside a CUDA graph capture.
_DICT_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_DICT_CACHE_LIMIT = 512
# while set (hold_tables), every lookup table handed out is appended here:
# a captured CUDA graph reads them at their addresses, so its owner keeps them
_HOLD: Optional[list] = None
EMPTY_DICTIONARY = Dictionary(np.array([], dtype=object))


class DictionaryWork:
    """One cached host result over dictionaries (`value`, a tuple) and the
    per-device copies of its numpy tables."""

    __slots__ = ("dicts", "value", "_tables")

    def __init__(self, dicts, value):
        self.dicts = dicts
        self.value = value
        self._tables = {}

    def table(self, i: int, device) -> torch.Tensor:
        """value[i], a numpy array, as a tensor on `device` (copied once)."""
        key = (i, str(device))
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = torch.from_numpy(
                np.ascontiguousarray(self.value[i])).to(device)
        if _HOLD is not None:
            _HOLD.append(t)
        return t

    def lookup(self, i: int, codes: torch.Tensor) -> torch.Tensor:
        """value[i][codes] on the codes' device (codes clamped into it)."""
        lut = self.table(i, codes.device)
        return lut[torch.clamp(codes, 0, len(self.value[i]) - 1).long()]


def dictionary_work(dicts: Tuple[Dictionary, ...], op: str, args: tuple,
                    compute) -> DictionaryWork:
    """The cached DictionaryWork of `op` over `dicts` with literal `args`;
    `compute()` (returning the value tuple) runs on a miss only."""
    key = (tuple(id(d) for d in dicts), op, args)
    hit = _DICT_CACHE.get(key)
    if hit is not None:
        _DICT_CACHE.move_to_end(key)
        return hit
    work = _DICT_CACHE[key] = DictionaryWork(tuple(dicts), tuple(compute()))
    while len(_DICT_CACHE) > _DICT_CACHE_LIMIT:
        _DICT_CACHE.popitem(last=False)
    return work


# the steady state's overflow flags and fixed values, while its walker runs
_FLAG_SINK: Optional[list] = None
_STEADY_VALUES: Optional[dict] = None


def set_flag_sink(sink: Optional[list], values: Optional[dict] = None):
    """Install the running steady state's flag list and values (None, None:
    not in a steady state); returns the previous pair."""
    global _FLAG_SINK, _STEADY_VALUES
    prev = (_FLAG_SINK, _STEADY_VALUES)
    _FLAG_SINK, _STEADY_VALUES = sink, values
    return prev


def steady_value(key, make):
    """make() outside a steady state; inside one, the value its first run
    made (so a CUDA graph captures it, and the CPU's eager runs reuse it)."""
    if _STEADY_VALUES is None:
        return make()
    if key not in _STEADY_VALUES:
        _STEADY_VALUES[key] = make()
    return _STEADY_VALUES[key]


def hold_tables(sink: Optional[list]) -> Optional[list]:
    """Append every lookup table handed out from now on to `sink` (None
    stops); returns the previous sink."""
    global _HOLD
    prev, _HOLD = _HOLD, sink
    return prev


def merge_dictionaries(a: Dictionary, b: Dictionary) -> DictionaryWork:
    """Merged sorted dictionary and the code translation arrays of both
    inputs: value (merged, amap, bmap)."""

    def compute():
        from ..data.column import as_text_array, is_bytes_values

        if is_bytes_values(a.values) or is_bytes_values(b.values):
            # bytes dictionaries merge in Python (numpy "S" drops trailing NULs)
            mlist = sorted({bytes(v) for v in a.values}
                           | {bytes(v) for v in b.values})
            lut = {v: i for i, v in enumerate(mlist)}
            amap = np.array([lut[bytes(v)] for v in a.values], dtype=np.int32)
            bmap = np.array([lut[bytes(v)] for v in b.values], dtype=np.int32)
            return Dictionary(np.array(mlist, dtype=object)), amap, bmap
        av = as_text_array(a.values) if len(a.values) else np.array([], "U1")
        bv = as_text_array(b.values) if len(b.values) else np.array([], "U1")
        m = np.union1d(av, bv)
        return (Dictionary(m.astype(object)),
                np.searchsorted(m, av).astype(np.int32),
                np.searchsorted(m, bv).astype(np.int32))

    return dictionary_work((a, b), "merge", (), compute)


def _translate_codes(col: DeviceColumn, work: DictionaryWork,
                     i: int) -> DeviceColumn:
    """col's codes through the translation array work.value[i], onto the
    merged dictionary work.value[0]."""
    merged = work.value[0]
    t = col.dtype if col.dtype is not None and col.dtype.is_string else T.STRING
    if len(work.value[i]) == 0:
        return DeviceColumn(torch.zeros_like(col.data), col.validity, t, merged)
    return DeviceColumn(work.lookup(i, col.data), col.validity, t, merged)


def unify_many_string_columns(cols):
    """Re-encode string columns onto one merged dictionary (n-way)."""
    dicts = [c.dictionary for c in cols]
    ids = {id(d) for d in dicts if d is not None}
    if len(ids) <= 1 and all(d is not None for d in dicts):
        return list(cols)
    uniq = []
    seen = set()
    for d in dicts:
        if d is not None and id(d) not in seen:
            seen.add(id(d))
            uniq.append(d)

    def compute():
        from ..data.column import as_text_array, is_bytes_values

        if any(is_bytes_values(d.values) for d in uniq):
            mlist = sorted({bytes(v) for d in uniq for v in d.values})
            lut = {v: i for i, v in enumerate(mlist)}
            return (Dictionary(np.array(mlist, dtype=object)),
                    *(np.array([lut[bytes(v)] for v in d.values], dtype=np.int32)
                      for d in uniq))
        vals = [as_text_array(d.values) for d in uniq if len(d.values)]
        merged_np = (np.unique(np.concatenate(vals)) if vals
                     else np.array([], "U1"))
        maps = []
        for d in uniq:
            dv = (as_text_array(d.values) if len(d.values)
                  else np.array([], merged_np.dtype))
            maps.append(np.searchsorted(merged_np, dv).astype(np.int32))
        return (Dictionary(merged_np.astype(object)), *maps)

    work = dictionary_work(tuple(uniq), "merge_many", (), compute)
    merged = work.value[0]
    slot = {id(d): 1 + i for i, d in enumerate(uniq)}
    out = []
    for c in cols:
        if c.dictionary is None:
            out.append(DeviceColumn(torch.zeros_like(c.data), c.validity,
                                    T.STRING, merged))
        else:
            out.append(_translate_codes(c, work, slot[id(c.dictionary)]))
    return out


def unify_string_columns(l: DeviceColumn, r: DeviceColumn
                         ) -> Tuple[DeviceColumn, DeviceColumn]:
    if l.dictionary is r.dictionary and l.dictionary is not None:
        return l, r
    work = merge_dictionaries(l.dictionary or EMPTY_DICTIONARY,
                              r.dictionary or EMPTY_DICTIONARY)
    return _translate_codes(l, work, 1), _translate_codes(r, work, 2)


def literal_dictionary(value, binary: bool = False) -> Dictionary:
    """The one-value dictionary of a string (or bytes) literal, one object
    per value, so that the merges over it are cached too."""
    v = bytes(value) if binary else str(value)
    return dictionary_work((), "literal", (binary, v),
                           lambda: (Dictionary(np.array([v], dtype=object)),)
                           ).value[0]


def dictionary_text(d: Dictionary) -> np.ndarray:
    """The dictionary's values as a numpy "U" array (text dictionaries)."""
    from ..data.column import as_text_array

    return as_text_array(d.values) if len(d.values) else np.array([], "U1")


def _string_literal_side(e: E.BinaryOp):
    """(column side, literal value, op as column OP literal) when e compares
    an expression with a non-NULL string literal; else None."""
    mirror = {E.Op.LT: E.Op.GT, E.Op.LE: E.Op.GE, E.Op.GT: E.Op.LT,
              E.Op.GE: E.Op.LE, E.Op.EQ: E.Op.EQ, E.Op.NEQ: E.Op.NEQ}

    def lit(x):
        return (isinstance(x, E.Literal) and x.value is not None
                and x.dtype.is_string and not x.dtype.is_binary)

    if lit(e.right) and not lit(e.left):
        return e.left, str(e.right.value), e.op
    if lit(e.left) and not lit(e.right):
        return e.right, str(e.left.value), mirror[e.op]
    return None


def _is_text_dict(c: DeviceColumn) -> bool:
    """A dictionary-encoded text (not binary) column."""
    return (c.dtype.is_string and not c.dtype.is_binary
            and c.dictionary is not None and c.data.ndim == 1)


def _compare_with_literal(c: DeviceColumn, value: str, op) -> DeviceColumn:
    """A dictionary column compared with a string literal, on its codes: the
    dictionary is sorted, so the literal's position in it (found once per
    dictionary and literal) splits the codes into less, equal and greater."""
    def compute():
        text = dictionary_text(c.dictionary)
        return (int(np.searchsorted(text, value, "left")),
                int(np.searchsorted(text, value, "right")))

    work = dictionary_work((c.dictionary,), "position", (value,), compute)
    lo, hi = work.value
    codes = c.data
    data = {E.Op.EQ: lambda: (codes >= lo) & (codes < hi),
            E.Op.NEQ: lambda: (codes < lo) | (codes >= hi),
            E.Op.LT: lambda: codes < lo,
            E.Op.LE: lambda: codes < hi,
            E.Op.GT: lambda: codes >= hi,
            E.Op.GE: lambda: codes >= lo}[op]()
    return DeviceColumn(data, c.validity, T.BOOL)


def _in_string_literals(c: DeviceColumn, values) -> DeviceColumn:
    """`c IN (literals)` over a dictionary column: a membership table over
    the dictionary (built once per dictionary and list), one gather."""
    want = tuple(sorted(set(values)))
    work = dictionary_work(
        (c.dictionary,), "in", want,
        lambda: (np.isin(dictionary_text(c.dictionary),
                         np.array(want, dtype="U")),))
    if not len(work.value[0]):
        data = torch.zeros(c.data.shape[0], dtype=torch.bool, device=c.data.device)
    else:
        data = work.lookup(0, c.data)
    if c.validity is not None:
        data = data & c.validity
    return DeviceColumn(data, c.validity, T.BOOL)


def _combine_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    out = None
    for v in vs:
        if v is not None:
            out = v if out is None else (out & v)
    return out


def _to_float(col: DeviceColumn) -> torch.Tensor:
    """float64 values (decimals descaled); never torch's float32 default."""
    if col.dtype.is_decimal:
        return col.data.to(torch.float64) / (10.0 ** col.dtype.scale)
    return col.data.to(torch.float64)


def _bounds_binop(op, b1, b2):
    """Interval propagation for +,-,* (reference analog: interval_arithmetic,
    datafusion/expr-common/src/interval_arithmetic.rs)."""
    if b1 is None or b2 is None:
        return None
    lo1, hi1 = b1
    lo2, hi2 = b2
    if op is E.Op.ADD:
        return (lo1 + lo2, hi1 + hi2)
    if op is E.Op.SUB:
        return (lo1 - hi2, hi1 - lo2)
    if op is E.Op.MUL:
        corners = (lo1 * lo2, lo1 * hi2, hi1 * lo2, hi1 * hi2)
        return (min(corners), max(corners))
    return None


def _scale_bounds(b, from_scale: int, to_scale: int):
    if b is None:
        return None
    if to_scale >= from_scale:
        f = 10 ** (to_scale - from_scale)
        return (b[0] * f, b[1] * f)
    f = 10 ** (from_scale - to_scale)
    return (b[0] // f - 1, b[1] // f + 1)


def _rescale_decimal(data: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return data // (10 ** (from_scale - to_scale))  # floors, as jnp does


def _parse_strings(col: DeviceColumn, dtype: T.DataType) -> DeviceColumn:
    """A string column cast to a number, DATE32, TIMESTAMP or TIME: each
    dictionary value parsed once (cached per dictionary), one gather per
    row. A value that does not parse raises numpy's ValueError, as in the
    reference."""
    d = col.dictionary or EMPTY_DICTIONARY
    k = dtype.kind

    def compute():
        vals = dictionary_text(d)
        if not len(vals):
            return (np.zeros(1, dtype.np_dtype()),)
        if k is T.TypeKind.DATE32:
            return (DU.dates_from_strings(vals),)
        if k is T.TypeKind.TIMESTAMP:
            return (vals.astype("datetime64[us]").astype(np.int64),)
        if k is T.TypeKind.TIME:
            return (DU.times_from_strings(vals),)
        fl = vals.astype(np.float64)
        if dtype.is_decimal:
            return (np.rint(fl * 10 ** dtype.scale).astype(np.int64),)
        return (fl.astype(dtype.np_dtype()),)

    key = (k.value, dtype.scale if dtype.is_decimal else None)
    work = dictionary_work((d,), "parse", key, compute)
    return DeviceColumn(work.lookup(0, col.data), col.validity, dtype)


def _recode_strings(col: DeviceColumn, dtype: T.DataType) -> DeviceColumn:
    """UTF8 <-> BINARY: the dictionary re-encoded on the host (bytes sort
    differently from text, so codes remap through a new sorted dictionary);
    a value that does not convert becomes NULL."""
    d = col.dictionary or EMPTY_DICTIONARY
    to_bytes = dtype.is_binary

    def compute():
        new_vals, ok = [], []
        for v in d.values:
            try:
                new_vals.append(v.encode("utf-8") if to_bytes else v.decode("utf-8"))
                ok.append(True)
            except (UnicodeDecodeError, UnicodeEncodeError, AttributeError):
                new_vals.append(b"" if to_bytes else "")
                ok.append(False)
        uniq = sorted(set(new_vals))
        lut = {v: i for i, v in enumerate(uniq)}
        return (Dictionary(np.array(uniq, dtype=object)),
                np.array([lut[v] for v in new_vals] or [0], dtype=np.int32),
                np.array(ok or [True]))

    work = dictionary_work((d,), "recode", (to_bytes,), compute)
    new_dict, _, ok = work.value
    validity = col.validity
    if not ok.all():
        validity = _combine_validity(validity, work.lookup(2, col.data))
    return DeviceColumn(work.lookup(1, col.data), validity, dtype, new_dict)


def cast_column(col: DeviceColumn, dtype: T.DataType, capacity: int) -> DeviceColumn:
    if col.dtype == dtype:
        return col
    v = col.validity
    if dtype.is_string:
        if col.dtype.is_string:
            if col.dtype.kind == dtype.kind:
                return col
            return _recode_strings(col, dtype)
        if col.dtype.kind is T.TypeKind.NULL:
            # an untyped NULL (arrow_cast(NULL, 'Utf8')): an all-NULL column
            dev = col.data.device
            return DeviceColumn(torch.zeros(capacity, dtype=torch.int32, device=dev),
                                torch.zeros(capacity, dtype=torch.bool, device=dev),
                                dtype, EMPTY_DICTIONARY)
        # numbers and dates to strings need the live values (string_cast_column)
        raise PlanError(f"cast {col.dtype} -> string not supported on device")
    if col.dtype.is_string:
        if col.dtype.is_binary:
            raise PlanError(f"cast binary -> {dtype} not supported")
        if dtype.kind in (T.TypeKind.DATE32, T.TypeKind.TIMESTAMP, T.TypeKind.TIME) \
                or dtype.is_numeric:
            return _parse_strings(col, dtype)
        raise PlanError(f"cast string -> {dtype} not supported")
    if dtype.is_decimal:
        if col.dtype.is_decimal:
            return DeviceColumn(_rescale_decimal(col.data, col.dtype.scale, dtype.scale), v, dtype,
                                bounds=_scale_bounds(col.bounds, col.dtype.scale, dtype.scale))
        if col.dtype.is_float:
            return DeviceColumn(torch.round(col.data.to(torch.float64) * 10 ** dtype.scale)
                                .to(torch.int64), v, dtype)
        return DeviceColumn(col.data.to(torch.int64) * (10 ** dtype.scale), v, dtype)
    out_t = torch_dtype(dtype)
    if col.dtype.is_decimal:
        if dtype.is_float:
            return DeviceColumn(_to_float(col).to(out_t), v, dtype)
        # decimal -> int truncates toward zero
        f = 10 ** col.dtype.scale
        q = col.data // f
        neg_fix = ((col.data % f) != 0) & (col.data < 0)
        return DeviceColumn((q + neg_fix.to(q.dtype)).to(out_t), v, dtype)
    us_day = 86_400_000_000
    if dtype.kind is T.TypeKind.TIME and col.dtype.kind is T.TypeKind.TIMESTAMP:
        return DeviceColumn(((col.data % us_day) + us_day) % us_day, v, dtype)
    if dtype.kind is T.TypeKind.TIMESTAMP and col.dtype.kind is T.TypeKind.DATE32:
        return DeviceColumn(col.data.to(torch.int64) * us_day, v, dtype)
    if dtype.kind is T.TypeKind.DATE32 and col.dtype.kind is T.TypeKind.TIMESTAMP:
        return DeviceColumn((col.data // us_day).to(torch.int32), v, dtype)
    # integer-representation casts (int widths, int<->date) keep the ordinal
    # value, so interval bounds carry over -- this is what lets dense
    # grouping see through CASTs
    b = None
    if col.bounds is not None and is_integer(col.data) \
            and not col.dtype.is_float and dtype.np_dtype().kind in "iu" \
            and not dtype.is_float:
        info = np.iinfo(dtype.np_dtype())
        if info.min <= int(col.bounds[0]) and int(col.bounds[1]) <= info.max:
            b = col.bounds  # narrowing can't wrap: bounds prove fit
    return DeviceColumn(col.data.to(out_t), v, dtype, bounds=b)


# ---------------------------------------------------------------------------
# numeric / boolean / temporal -> string casts (discovery-time dictionaries)
# ---------------------------------------------------------------------------


def render_strings(vals: np.ndarray, dtype: T.DataType,
                   fmt: Optional[str] = None) -> np.ndarray:
    """Host rendering of concrete values, as CAST(x AS VARCHAR) and
    to_char(x, fmt) give them: Arrow's display conventions (bool
    'true'/'false', dates ISO, decimals at full scale); to_char formats with
    strftime."""
    k = dtype.kind
    if fmt is not None:
        if k is T.TypeKind.DATE32:
            objs = vals.astype("datetime64[D]").tolist()
        elif k is T.TypeKind.TIMESTAMP:
            objs = vals.astype("datetime64[us]").tolist()
        else:
            raise PlanError(f"to_char: unsupported input type {dtype}")
        return np.array([o.strftime(fmt) if o is not None else "" for o in objs],
                        dtype=object)
    if k is T.TypeKind.BOOL:
        return np.array(["true" if v else "false" for v in vals], dtype=object)
    if dtype.is_decimal:
        s = dtype.scale
        out = []
        for v in vals:
            v = int(v)
            if s == 0:
                out.append(str(v))
            else:
                sign = "-" if v < 0 else ""
                a = abs(v)
                out.append(f"{sign}{a // 10 ** s}.{a % 10 ** s:0{s}d}")
        return np.array(out, dtype=object)
    if dtype.is_integer:
        return np.array([str(int(v)) for v in vals], dtype=object)
    if dtype.is_float:
        return np.array([str(float(v)) for v in vals], dtype=object)
    if k is T.TypeKind.DATE32:
        return np.datetime_as_string(vals.astype("datetime64[D]")).astype(object)
    if k is T.TypeKind.TIMESTAMP:
        return np.datetime_as_string(vals.astype("datetime64[us]"),
                                     unit="auto").astype(object)
    if k is T.TypeKind.TIME:
        return np.array([DU.us_to_time_str(v) for v in vals], dtype=object)
    raise PlanError(f"cast {dtype} -> string not supported")


def string_cast_column(node: E.Expr, col: DeviceColumn, rel: DeviceRelation,
                       fmt: Optional[str] = None) -> DeviceColumn:
    """CAST(non-string AS VARCHAR) / to_char(x, fmt). Outside a steady state
    (discovery, per-operator execution) the live values are concrete: their
    distinct values are read to the host once, rendered, and kept on the
    expression node with the sorted value table. Every run, the steady
    state's too, maps each row to its code by a sorted-table lookup on the
    device; inside a steady state a live value missing from the table
    raises an overflow flag, and the query goes back to discovery, which
    renders the new values."""
    live = rel.sel if col.validity is None else rel.sel & col.validity
    data = col.data.to(torch.int8) if col.data.dtype is torch.bool else col.data
    cache_key = (fmt, col.dtype)
    state = getattr(node, "_str_cast_state", None)
    if state is not None and state[0] != cache_key:
        state = None
    if _FLAG_SINK is None:
        vals = data[live].cpu().numpy()  # discovery's one host read
        uniq = np.unique(vals) if vals.size else np.zeros(1, vals.dtype)
        dict_vals, codes = np.unique(render_strings(uniq, col.dtype, fmt),
                                     return_inverse=True)
        # the search keys: np.unique puts NaN last; as +inf they stay sorted
        # for a binary search (a NaN query is sent to the last slot)
        keys = np.where(np.isnan(uniq), np.inf, uniq) if uniq.dtype.kind == "f" else uniq
        state = (cache_key, DictionaryWork(
            (), (keys, codes.astype(np.int32).reshape(-1),
                 Dictionary(np.asarray(dict_vals, dtype=object)), uniq)))
        object.__setattr__(node, "_str_cast_state", state)  # a frozen dataclass
    if state is None:
        raise PlanError("string cast requires a concrete discovery pass before "
                        "the steady state")
    work = state[1]
    n, dictionary = len(work.value[0]), work.value[2]
    keys = work.table(0, data.device)
    d = data.to(keys.dtype).contiguous()
    idx = torch.clamp(torch.searchsorted(keys, d), 0, n - 1)
    if keys.dtype.is_floating_point:
        idx = torch.where(torch.isnan(d), n - 1, idx)
    got = work.table(3, data.device)[idx]
    hit = got == d
    if keys.dtype.is_floating_point:
        hit = hit | (torch.isnan(got) & torch.isnan(d))
    if _FLAG_SINK is not None:
        _FLAG_SINK.append((~hit & live).any())
    out_codes = torch.where(hit, work.table(1, data.device)[idx], 0).to(torch.int32)
    return DeviceColumn(out_codes, col.validity, T.STRING, dictionary)


def _literal_column(e: E.Literal, capacity: int, device) -> DeviceColumn:
    t = e.dtype

    def full(value, dt):
        return torch.full((capacity,), value, dtype=dt, device=device)

    if e.value is None:
        dt = t if t.kind is not T.TypeKind.NULL else T.INT64
        return DeviceColumn(full(0, torch_dtype(dt)), full(False, torch.bool), dt)
    if t.is_binary:
        return DeviceColumn(full(0, torch.int32), None, T.BINARY,
                            literal_dictionary(e.value, binary=True))
    if t.is_string:
        return DeviceColumn(full(0, torch.int32), None, T.STRING,
                            literal_dictionary(e.value))
    if t.is_decimal:
        raw = int(round(float(e.value) * 10 ** t.scale))
        return DeviceColumn(full(raw, torch.int64), None, t, bounds=(raw, raw))
    if t.kind is T.TypeKind.DATE32:
        v = e.value if isinstance(e.value, (int, np.integer)) \
            else DU.date_str_to_days(str(e.value))
        return DeviceColumn(full(int(v), torch.int32), None, t)
    if t.kind is T.TypeKind.TIMESTAMP:
        v = e.value if isinstance(e.value, (int, np.integer)) \
            else int(np.datetime64(str(e.value), "us").astype(np.int64))
        return DeviceColumn(full(int(v), torch.int64), None, t)
    b = (int(e.value), int(e.value)) if t.is_integer else None
    value = e.value
    if t.is_integer:  # past the type's range it wraps, as numpy's cast does
        bits = 8 * np.dtype(t.np_dtype()).itemsize
        value = (int(value) + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))
    return DeviceColumn(full(value, torch_dtype(t)), None, t, bounds=b)


_CMP = {
    E.Op.EQ: lambda a, b: a == b,
    E.Op.NEQ: lambda a, b: a != b,
    E.Op.LT: lambda a, b: a < b,
    E.Op.LE: lambda a, b: a <= b,
    E.Op.GT: lambda a, b: a > b,
    E.Op.GE: lambda a, b: a >= b,
}


def _unwrap_cast_comparison(e: E.BinaryOp, schema: Schema) -> E.BinaryOp:
    """A float literal compared against a decimal expression becomes a
    decimal literal AT THE DECIMAL SIDE'S SCALE (round half away from zero),
    as the reference's unwrap_cast_in_comparison does: TPC-H Q6's
    `l_discount <= 0.06 + 0.01` folds to the f64 0.06999999999999999 and must
    still keep the 0.07 rows."""
    from ..expr.typing import infer

    def rewrite(lit: E.Literal, other: E.Expr):
        try:
            dt, _ = infer(other, schema)
        except Exception:  # noqa: BLE001 -- untypeable side: leave as-is
            return None
        if not dt.is_decimal or lit.value is None:
            return None
        v = float(lit.value)
        raw = math.floor(abs(v) * 10 ** dt.scale + 0.5)
        raw = -raw if v < 0 else raw
        return E.Literal(raw / 10 ** dt.scale, T.decimal(dt.precision,
                                                         dt.scale))

    l, r = e.left, e.right
    if isinstance(l, E.Literal) and l.dtype.is_float \
            and not isinstance(r, E.Literal):
        nl = rewrite(l, r)
        if nl is not None:
            return E.BinaryOp(e.op, nl, r)
    if isinstance(r, E.Literal) and r.dtype.is_float \
            and not isinstance(l, E.Literal):
        nr = rewrite(r, l)
        if nr is not None:
            return E.BinaryOp(e.op, l, nr)
    return e


def _eval_logic(op, l: DeviceColumn, r: DeviceColumn) -> DeviceColumn:
    vl, vr = l.validity, r.validity
    ld, rd = l.data, r.data
    if op is E.Op.AND:
        data = (ld if vl is None else (ld | ~vl)) & (rd if vr is None else (rd | ~vr))
    else:
        data = (ld if vl is None else (ld & vl)) | (rd if vr is None else (rd & vr))
    if vl is None and vr is None:
        return DeviceColumn(data, None, T.BOOL)
    vl_ = vl if vl is not None else torch.ones_like(ld)
    vr_ = vr if vr is not None else torch.ones_like(rd)
    if op is E.Op.AND:
        valid = (vl_ & vr_) | (vl_ & ~ld) | (vr_ & ~rd)
    else:
        valid = (vl_ & vr_) | (vl_ & ld) | (vr_ & rd)
    return DeviceColumn(data, valid, T.BOOL)


def eval_binary(e: E.BinaryOp, l: DeviceColumn, r: DeviceColumn, schema: Schema) -> DeviceColumn:
    op = e.op
    if op.is_logic:
        return _eval_logic(op, l, r)

    if op.is_comparison:
        # string vs temporal: the string side is parsed as the temporal type
        if l.dtype.is_string != r.dtype.is_string and (
                l.dtype.is_temporal or r.dtype.is_temporal):
            if l.dtype.is_string:
                l = cast_column(l, r.dtype, l.data.shape[0])
            else:
                r = cast_column(r, l.dtype, r.data.shape[0])
        if l.dtype.is_string or r.dtype.is_string:
            # binary vs utf8: the utf8 side is cast to bytes
            if l.dtype.is_binary != r.dtype.is_binary \
                    and l.dtype.is_string and r.dtype.is_string:
                if l.dtype.is_binary:
                    r = cast_column(r, T.BINARY, r.data.shape[0])
                else:
                    l = cast_column(l, T.BINARY, l.data.shape[0])
            l2, r2 = unify_string_columns(l, r)
            data = _CMP[op](l2.data, r2.data)
        else:
            ld, rd = _align_numeric(l, r)
            data = _CMP[op](ld, rd)
        return DeviceColumn(data, _combine_validity(l.validity, r.validity), T.BOOL)

    # arithmetic
    valid = _combine_validity(l.validity, r.validity)
    lt, rt = l.dtype, r.dtype
    out_t = arith_result(op, lt, rt)
    day = 86_400_000_000

    # temporal arithmetic
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.INTERVAL_DAYS:
        delta = r.data if op is E.Op.ADD else -r.data
        return DeviceColumn(l.data + delta.to(torch.int32), valid, T.DATE32)
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.INTERVAL_MONTHS:
        months = r.data.to(torch.int64) if op is E.Op.ADD else -r.data.to(torch.int64)
        return DeviceColumn(DU.add_months(l.data, months), valid, T.DATE32)
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.INTERVAL_US:
        # date +/- sub-day interval stays Date32; arrow truncates the
        # interval to WHOLE days toward zero
        us = r.data.to(torch.int64)
        wd = (torch.sign(us) * (torch.abs(us) // day)).to(torch.int32)
        return DeviceColumn(l.data + (wd if op is E.Op.ADD else -wd), valid, T.DATE32)
    if lt.kind is T.TypeKind.INTERVAL_DAYS and rt.kind is T.TypeKind.DATE32 and op is E.Op.ADD:
        return DeviceColumn(r.data + l.data.to(torch.int32), valid, T.DATE32)
    if lt.kind is T.TypeKind.DATE32 and rt.kind is T.TypeKind.DATE32 and op is E.Op.SUB:
        return DeviceColumn(l.data - r.data, valid, T.INT32)
    if lt.kind is T.TypeKind.TIMESTAMP and rt.kind in (T.TypeKind.INTERVAL_US,
                                                       T.TypeKind.INTERVAL_DAYS):
        us = r.data.to(torch.int64)
        if rt.kind is T.TypeKind.INTERVAL_DAYS:
            us = us * day
        return DeviceColumn(l.data + (us if op is E.Op.ADD else -us), valid, T.TIMESTAMP)
    if lt.kind is T.TypeKind.TIME and rt.kind is T.TypeKind.INTERVAL_US:
        delta = r.data.to(torch.int64) if op is E.Op.ADD else -r.data.to(torch.int64)
        return DeviceColumn(((l.data + delta) % day + day) % day, valid, T.TIME)

    if op is E.Op.DIV:
        if lt.is_integer and rt.is_integer:
            ld, rd = _align_numeric(l, r)
            safe = torch.where(rd == 0, torch.ones_like(rd), rd)
            q = torch.where(rd == 0, torch.zeros_like(ld), ld // safe)
            # SQL integer division truncates toward zero
            rem = ld - q * safe
            q = q + ((rem != 0) & ((ld < 0) != (rd < 0))).to(q.dtype)
            return DeviceColumn(q, valid, out_t)
        if out_t.is_decimal:
            # decimal / decimal-or-int at scale s1+4 (arrow-rs decimal div):
            # raw = round(l_raw * 10^(so - ls + rs) / r_raw), computed in f64
            ls = lt.scale if lt.is_decimal else 0
            rs = rt.scale if rt.is_decimal else 0
            num = l.data.to(torch.float64) * (10.0 ** (out_t.scale - ls + rs))
            den = r.data.to(torch.float64)
            safe = torch.where(den == 0.0, 1.0, den)
            q = torch.where(den == 0.0, 0.0, num / safe)
            return DeviceColumn(torch.round(q).to(torch.int64), valid, out_t)
        return DeviceColumn(_to_float(l) / _to_float(r), valid, T.FLOAT64)

    if op is E.Op.MOD:
        ld, rd = _align_numeric(l, r)
        safe = torch.where(rd == 0, torch.ones_like(rd), rd)
        if ld.dtype.is_floating_point:
            m = torch.fmod(ld, safe)
        else:
            # truncated (C-style) remainder to match SQL
            fq = ld // safe
            tq = fq + (((ld - fq * safe) != 0) & ((ld < 0) != (rd < 0))).to(ld.dtype)
            m = ld - tq * safe
        return DeviceColumn(torch.where(rd == 0, torch.zeros_like(m), m), valid, out_t)

    if out_t.is_decimal and op is E.Op.MUL:
        nb = _bounds_binop(op, l.bounds, r.bounds)
        return DeviceColumn(l.data.to(torch.int64) * r.data.to(torch.int64),
                            valid, out_t, bounds=nb)

    if out_t.is_decimal:
        s = out_t.scale
        ls = lt.scale if lt.is_decimal else 0
        rs = rt.scale if rt.is_decimal else 0
        ld = _rescale_decimal(l.data.to(torch.int64), ls, s)
        rd = _rescale_decimal(r.data.to(torch.int64), rs, s)
        data = ld + rd if op is E.Op.ADD else ld - rd
        nb = _bounds_binop(op, _scale_bounds(l.bounds, ls, s), _scale_bounds(r.bounds, rs, s))
        return DeviceColumn(data, valid, out_t, bounds=nb)

    if out_t.is_float:
        lf, rf = _to_float(l), _to_float(r)
        data = {E.Op.ADD: torch.add, E.Op.SUB: torch.sub, E.Op.MUL: torch.mul}[op](lf, rf)
        return DeviceColumn(data.to(torch_dtype(out_t)), valid, out_t)

    ld = l.data.to(torch_dtype(out_t))
    rd = r.data.to(torch_dtype(out_t))
    data = {E.Op.ADD: torch.add, E.Op.SUB: torch.sub, E.Op.MUL: torch.mul}[op](ld, rd)
    return DeviceColumn(data, valid, out_t, bounds=_bounds_binop(op, l.bounds, r.bounds))


def _align_numeric(l: DeviceColumn, r: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    lt, rt = l.dtype, r.dtype
    if lt == rt:
        return l.data, r.data
    if lt.is_float or rt.is_float:
        return _to_float(l), _to_float(r)
    if lt.is_decimal or rt.is_decimal:
        s = max(lt.scale if lt.is_decimal else 0, rt.scale if rt.is_decimal else 0)
        ld = _rescale_decimal(l.data.to(torch.int64), lt.scale if lt.is_decimal else 0, s)
        rd = _rescale_decimal(r.data.to(torch.int64), rt.scale if rt.is_decimal else 0, s)
        return ld, rd
    if lt.is_temporal or rt.is_temporal:
        return l.data.to(torch.int64), r.data.to(torch.int64)
    common = torch_dtype(T.common_numeric_type(lt, rt))
    return l.data.to(common), r.data.to(common)


def eval_expr(e: E.Expr, rel: DeviceRelation) -> DeviceColumn:
    """Evaluate an expression over a relation, eagerly on its device."""
    cap = rel.capacity
    schema = rel.schema

    if isinstance(e, E.Column):
        return rel.column(e.flat_name)
    if isinstance(e, E.Literal):
        return _literal_column(e, cap, rel.device)
    if isinstance(e, (E.Alias, E.SortSpec)):
        return eval_expr(e.expr, rel)
    if isinstance(e, E.Cast):
        src = eval_expr(e.expr, rel)
        if e.dtype.is_string and not src.dtype.is_string:
            return string_cast_column(e, src, rel)
        return cast_column(src, e.dtype, cap)
    if isinstance(e, E.Negative):
        c = eval_expr(e.expr, rel)
        return DeviceColumn(-c.data, c.validity, c.dtype)
    if isinstance(e, E.Not):
        c = eval_expr(e.expr, rel)
        return DeviceColumn(~c.data, c.validity, T.BOOL)
    if isinstance(e, E.IsNull):
        c = eval_expr(e.expr, rel)
        data = (torch.zeros(cap, dtype=torch.bool, device=rel.device)
                if c.validity is None else ~c.validity)
        return DeviceColumn(data, None, T.BOOL)
    if isinstance(e, E.BinaryOp):
        if e.op.is_comparison:
            e = _unwrap_cast_comparison(e, rel.schema)
            side = _string_literal_side(e)
            if side is not None:
                c = eval_expr(side[0], rel)
                if _is_text_dict(c):
                    return _compare_with_literal(c, side[1], side[2])
                l = c if side[0] is e.left else eval_expr(e.left, rel)
                r = c if side[0] is e.right else eval_expr(e.right, rel)
                return eval_binary(e, l, r, schema)
        return eval_binary(e, eval_expr(e.left, rel), eval_expr(e.right, rel), schema)
    if isinstance(e, E.Between):
        low = E.BinaryOp(E.Op.GE, e.expr, e.low)
        high = E.BinaryOp(E.Op.LE, e.expr, e.high)
        out = eval_expr(E.BinaryOp(E.Op.AND, low, high), rel)
        if e.negated:
            out = DeviceColumn(~out.data, out.validity, T.BOOL)
        return out
    if isinstance(e, E.ScalarFunction):
        from ..expr.typing import infer
        from ..expr.udf import active_registry
        from . import functions as F

        if any(isinstance(a, E.Lambda) for a in e.args):
            from . import nested

            return nested.eval_lambda_function(e.fname, e.args, rel,
                                               infer(e, schema)[0])
        if e.fname == "to_char" and len(e.args) == 2:
            src = eval_expr(e.args[0], rel)
            if src.dtype.is_string:
                return src
            fmt = e.args[1]
            if not isinstance(fmt, E.Literal):
                raise PlanError("to_char format must be a literal")
            return string_cast_column(e, src, rel, fmt=str(fmt.value))
        args = [eval_expr(a, rel) for a in e.args]
        udf = active_registry().scalar(e.fname)
        if udf is not None:
            from ..expr.udf import eval_scalar_udf

            return eval_scalar_udf(udf, args)
        out_t, _ = infer(e, schema)
        return F.eval_scalar_function(e.fname, args, e.args, out_t, cap, rel.device)
    if isinstance(e, E.InList):
        c = eval_expr(e.expr, rel)
        if _is_text_dict(c) and e.values and all(
                isinstance(v, E.Literal) and v.value is not None
                and v.dtype.is_string and not v.dtype.is_binary
                for v in e.values):
            acc = _in_string_literals(c, [str(v.value) for v in e.values])
            return DeviceColumn(~acc.data if e.negated else acc.data,
                                acc.validity, T.BOOL)
        acc = None
        for v in e.values:
            eq = eval_binary(E.BinaryOp(E.Op.EQ, e.expr, v), c, eval_expr(v, rel), schema)
            acc = eq if acc is None else eval_binary(
                E.BinaryOp(E.Op.OR, e.expr, v), acc, eq, schema)
        if acc is None:
            return DeviceColumn(torch.zeros(cap, dtype=torch.bool, device=rel.device),
                                None, T.BOOL)
        return DeviceColumn(~acc.data if e.negated else acc.data, acc.validity, T.BOOL)
    if isinstance(e, E.Like):
        from . import functions as F

        c = eval_expr(e.expr, rel)
        if not isinstance(e.pattern, E.Literal):
            raise PlanError("LIKE pattern must be a literal")
        data = F.eval_like(c, str(e.pattern.value), e.case_insensitive)
        return DeviceColumn(~data if e.negated else data, c.validity, T.BOOL)
    if isinstance(e, E.Case):
        return _eval_case(e, rel)
    raise PlanError(f"cannot evaluate {type(e).__name__} on device: {e!r}")


def _eval_case(e: E.Case, rel: DeviceRelation) -> DeviceColumn:
    """CASE [operand] WHEN ... THEN ... [ELSE ...] END: the first branch
    whose condition is true (not NULL) wins; no ELSE gives NULL."""
    from ..expr.typing import infer

    cap = rel.capacity
    out_t, _ = infer(e, rel.schema)

    def branch_cond(w: E.Expr) -> DeviceColumn:
        if e.operand is not None:
            return eval_expr(E.BinaryOp(E.Op.EQ, e.operand, w), rel)
        return eval_expr(w, rel)

    then_cols = [cast_column(eval_expr(t, rel), out_t, cap) for _, t in e.branches]
    else_col = (cast_column(eval_expr(e.else_expr, rel), out_t, cap)
                if e.else_expr is not None else None)
    dictionary = None
    if out_t.is_string:
        allc = then_cols + ([else_col] if else_col is not None else [])
        unified = unify_many_string_columns(allc)
        then_cols = unified[: len(then_cols)]
        else_col = unified[len(then_cols)] if else_col is not None else None
        dictionary = then_cols[0].dictionary if then_cols else None

    ones = torch.ones(cap, dtype=torch.bool, device=rel.device)
    if else_col is not None:
        data, valid = else_col.data, else_col.validity
    else:
        data = torch.zeros(cap, dtype=torch_dtype(out_t), device=rel.device)
        valid = torch.zeros(cap, dtype=torch.bool, device=rel.device)
    for (w, _), tcol in zip(reversed(e.branches), reversed(then_cols)):
        cond = branch_cond(w)
        cmask = cond.data if cond.validity is None else (cond.data & cond.validity)
        data = torch.where(cmask, tcol.data, data)
        tvalid = tcol.validity if tcol.validity is not None else ones
        valid = torch.where(cmask, tvalid, valid if valid is not None else ones)
    return DeviceColumn(data, valid, out_t, dictionary)


def eval_predicate(e: E.Expr, rel: DeviceRelation) -> torch.Tensor:
    """Evaluate a boolean predicate to a keep-mask (NULL -> False)."""
    c = eval_expr(e, rel)
    mask = c.data
    if c.validity is not None:
        mask = mask & c.validity
    return mask
