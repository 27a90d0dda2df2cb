"""List, struct and map functions.

Port of datafusion_tpu/physical/nested.py to eager torch ops. A list value
is a padded row of a [capacity, width] tensor with int32 `lengths` and a
bool `elem_valid` slot mask (data/device.py); every function is a whole-row
transform of those tensors:

  make_array          stack the arguments along a new width axis
  array_element       torch.gather along the width axis
  array_slice/reverse shifted-iota gathers
  array_append/...    the width grows by a static amount; the value placed
                      by a mask
  array_distinct/...  a [cap, w, w] equality mask + a stable compaction
  array_union/...     width concatenation + membership masks + compaction
  array_sort          a stable per-row torch.sort
  string_to_array     the dictionary split on the host, one gather by code

Lambda functions (array_transform / array_filter / array_any_match /
array_all_match) evaluate their body over the flattened [capacity * width]
element axis as an ordinary expression, captured outer columns repeated
per element, then reshape back.

Struct and map columns are codes into a sorted dictionary of value tuples;
field access, map lookup, map_keys/map_values/map_extract/map_entries and
map cardinality are host tables over that dictionary gathered by code.

Every host table (dictionary remaps and merges, string splits, struct and
map lookups, literal structs and maps) is made through
expr_compiler.dictionary_work: once per dictionary, kept on the device, so
a captured steady state reads it without a host copy.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..common import types as T
from ..common.errors import PlanError
from ..data.column import Dictionary
from ..data.device import DeviceColumn, torch_dtype
from ..expr import nodes as E
from ..ops import kernels as K

# every name this module evaluates (aliases included)
NESTED_FNS = {
    "make_array", "make_list", "array", "list",
    "array_element", "list_element", "array_extract", "list_extract",
    "array_length", "list_length", "cardinality", "array_dims", "array_ndims",
    "empty", "array_empty", "list_empty",
    "array_has", "array_contains", "list_has", "list_contains",
    "array_has_all", "array_has_any",
    "array_position", "list_position", "array_indexof", "list_indexof",
    "array_positions", "list_positions",
    "array_append", "list_append", "array_push_back",
    "array_prepend", "list_prepend", "array_push_front",
    "array_concat", "array_cat", "list_concat", "list_cat",
    "array_slice", "list_slice",
    "array_reverse", "list_reverse",
    "array_distinct", "list_distinct",
    "array_sort", "list_sort",
    "array_union", "array_intersect", "array_except",
    "array_remove", "list_remove", "array_remove_all", "list_remove_all",
    "array_remove_n", "list_remove_n",
    "array_repeat", "list_repeat",
    "array_resize", "list_resize",
    "array_pop_back", "array_pop_front",
    "array_any_value", "array_max", "array_min", "array_sum", "array_mean",
    "range", "generate_series",
    "string_to_array", "string_to_list", "split_part_list",
    "array_transform", "list_transform", "array_map",
    "array_filter", "list_filter",
    "array_any_match", "any_match", "list_any_match",
    "array_all_match", "all_match", "list_all_match",
    "get_field", "named_struct", "struct", "row",
    "map", "make_map", "map_keys", "map_values", "map_extract",
    "map_contains_key", "element_at", "map_entries",
}

# higher-order functions: argument 1 is a Lambda (eval_lambda_function)
LAMBDA_FNS = {"array_transform", "array_filter",
              "array_any_match", "array_all_match"}

_CANON = {
    "make_list": "make_array", "array": "make_array", "list": "make_array",
    "list_element": "array_element", "array_extract": "array_element",
    "list_extract": "array_element",
    "list_length": "array_length",
    "list_empty": "empty", "array_empty": "empty",
    "array_contains": "array_has", "list_has": "array_has",
    "list_contains": "array_has",
    "list_position": "array_position", "array_indexof": "array_position",
    "list_indexof": "array_position",
    "list_positions": "array_positions",
    "list_append": "array_append", "array_push_back": "array_append",
    "list_prepend": "array_prepend", "array_push_front": "array_prepend",
    "array_cat": "array_concat", "list_concat": "array_concat",
    "list_cat": "array_concat",
    "list_slice": "array_slice",
    "list_transform": "array_transform", "array_map": "array_transform",
    "list_filter": "array_filter",
    "any_match": "array_any_match", "list_any_match": "array_any_match",
    "all_match": "array_all_match", "list_all_match": "array_all_match",
    "list_reverse": "array_reverse",
    "list_distinct": "array_distinct",
    "list_sort": "array_sort",
    "list_remove": "array_remove", "list_remove_all": "array_remove_all",
    "list_remove_n": "array_remove_n",
    "list_repeat": "array_repeat",
    "list_resize": "array_resize",
    "generate_series": "range",
    "string_to_list": "string_to_array",
}

_STRUCT_MAP_FNS = frozenset({
    "get_field", "named_struct", "struct", "row", "map", "make_map",
    "map_keys", "map_values", "map_extract", "map_contains_key",
    "element_at", "map_entries",
})


def canon(fname: str) -> str:
    return _CANON.get(fname, fname)


# ---------------------------------------------------------------------------
# typing (from functions.scalar_function_type)
# ---------------------------------------------------------------------------


def _lambda_body_schema(lam: E.Lambda, elem: T.DataType, schema):
    """The schema a lambda body is typed against: its (value, index)
    parameters, then the outer columns they do not shadow."""
    from ..common.schema import Field, Schema

    fields = [Field(lam.params[0], elem, nullable=True)]
    if len(lam.params) > 1:
        fields.append(Field(lam.params[1], T.INT64, nullable=False))
    return Schema(fields + [fld for fld in schema.fields
                            if fld.name not in lam.params])


def nested_function_type(e: E.ScalarFunction, schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    f = canon(e.fname)
    if f in LAMBDA_FNS:
        lt, ln = infer(e.args[0], schema)
        _need_list(lt, f)
        lam = e.args[1]
        if not isinstance(lam, E.Lambda):
            raise PlanError(f"{e.fname} expects a lambda as 2nd argument")
        if f in ("array_any_match", "array_all_match"):
            return T.BOOL, True
        if f == "array_filter":
            return lt, ln
        body_t, _ = infer(lam.body, _lambda_body_schema(lam, lt.elem, schema))
        return T.list_of(body_t), ln
    argt = [infer(a, schema) for a in e.args]
    nullable = any(n for _, n in argt)
    if f in _STRUCT_MAP_FNS:
        return _struct_map_type(f, e, argt, nullable)
    if f == "make_array":
        elem = T.NULL
        for t, _ in argt:
            elem = t if elem.kind is T.TypeKind.NULL else (
                T.common_numeric_type(elem, t) if elem.is_numeric and t.is_numeric
                else elem)
        if elem.kind is T.TypeKind.NULL:
            elem = T.INT64
        return T.list_of(elem), False
    if f == "array_element":
        lt = argt[0][0]
        _need_list(lt, f)
        return lt.elem, True
    if f in ("array_length", "cardinality", "array_position", "array_ndims"):
        return T.INT64, True
    if f == "array_dims":
        return T.list_of(T.INT64), nullable
    if f in ("empty", "array_has", "array_has_all", "array_has_any"):
        return T.BOOL, nullable
    if f in ("array_append", "array_prepend"):
        li = 0 if f == "array_append" else 1
        lt = argt[li][0]
        _need_list(lt, f)
        return lt, argt[li][1]
    if f in ("array_concat", "array_union", "array_intersect", "array_except"):
        lt = argt[0][0]
        _need_list(lt, f)
        return lt, nullable
    if f in ("array_slice", "array_reverse", "array_distinct", "array_sort",
             "array_remove", "array_remove_all", "array_remove_n",
             "array_resize", "array_pop_back", "array_pop_front"):
        lt = argt[0][0]
        _need_list(lt, f)
        return lt, argt[0][1]
    if f == "array_positions":
        return T.list_of(T.INT64), nullable
    if f == "array_repeat":
        return T.list_of(argt[0][0]), False
    if f in ("array_any_value", "array_max", "array_min"):
        lt = argt[0][0]
        _need_list(lt, f)
        return lt.elem, True
    if f == "array_sum":
        lt = argt[0][0]
        _need_list(lt, f)
        return (lt.elem if lt.elem.is_decimal else
                (T.INT64 if lt.elem.is_integer else T.FLOAT64)), True
    if f == "array_mean":
        return T.FLOAT64, True
    if f == "range":
        return T.list_of(T.INT64), False
    if f == "string_to_array":
        return T.list_of(T.STRING), True
    raise PlanError(f"unknown nested function {e.fname!r}")


def _need_list(t: T.DataType, f: str):
    if not t.is_list:
        raise PlanError(f"{f} expects a list argument, got {t}")


def _need_map(dt, f):
    if not dt.is_map:
        raise PlanError(f"{f} expects a map argument, got {dt!r}")


def _literal_py(e: E.Expr):
    """Python value of a literal expression tree (literals, negatives,
    make_array of literals); None-able. Raises PlanError otherwise."""
    if isinstance(e, E.Alias):
        return _literal_py(e.expr)
    if isinstance(e, E.Literal):
        return e.value
    if isinstance(e, E.Negative):
        return -_literal_py(e.expr)
    if isinstance(e, E.ScalarFunction) and canon(e.fname) == "make_array":
        return [_literal_py(a) for a in e.args]
    raise PlanError(
        "struct/map construction supports literal arguments only; "
        "struct-typed table columns ingest from pydict/arrow data")


def _field_name(e: E.Expr) -> str:
    v = _literal_py(e)
    if not isinstance(v, str):
        raise PlanError("get_field expects a literal field name")
    return v


def _pytype(v) -> T.DataType:
    from ..data.column import _infer_scalar_type

    t = _infer_scalar_type(v)
    return t if t is not None else T.NULL


def _struct_map_type(f: str, e: E.ScalarFunction, argt, nullable):
    if f == "get_field":
        base = argt[0][0]
        if base.is_struct:
            name = _field_name(e.args[1])
            for n, t in base.fields:
                if n == name:
                    return t, True
            raise PlanError(f"struct has no field {name!r}; fields: "
                            f"{[n for n, _ in base.fields]}")
        if base.is_map:
            return base.elem, True
        raise PlanError(f"get_field on non-struct/map type {base!r}")
    if f == "element_at":
        base = argt[0][0]
        if base.is_map or base.is_list:
            return base.elem, True
        raise PlanError(f"element_at on non-map/list type {base!r}")
    if f == "map_keys":
        _need_map(argt[0][0], f)
        return T.list_of(argt[0][0].fields[0][1]), nullable
    if f in ("map_values", "map_extract"):
        _need_map(argt[0][0], f)
        return T.list_of(argt[0][0].elem), nullable
    if f == "map_contains_key":
        _need_map(argt[0][0], f)
        return T.BOOL, nullable
    if f == "map_entries":
        _need_map(argt[0][0], f)
        kt = argt[0][0].fields[0][1]
        return T.list_of(T.struct((("key", kt), ("value", argt[0][0].elem)))), nullable
    if f in ("named_struct", "struct", "row"):
        if f == "named_struct":
            pairs = [(_field_name(e.args[i]), e.args[i + 1])
                     for i in range(0, len(e.args), 2)]
        else:
            pairs = [(a.aname if isinstance(a, E.Alias) else f"c{i}", a)
                     for i, a in enumerate(e.args)]
        return T.struct([(n, _pytype(_literal_py(a))) for n, a in pairs]), False
    # map / make_map
    if f == "map" and len(e.args) == 2:
        ks = _literal_py(e.args[0]) or []
        vs = _literal_py(e.args[1]) or []
        pairs = list(zip(ks, vs))
    else:
        vals = [_literal_py(a) for a in e.args]
        pairs = list(zip(vals[0::2], vals[1::2]))
    kt = vt = T.NULL
    for k, v in pairs:
        kt = _pytype(k) if kt.kind is T.TypeKind.NULL else kt
        vt = _pytype(v) if vt.kind is T.TypeKind.NULL else vt
    return T.map_of(kt if kt.kind is not T.TypeKind.NULL else T.INT64,
                    vt if vt.kind is not T.TypeKind.NULL else T.INT64), False


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _iota(cap: int, w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(cap, w)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x gathered along the width axis at idx ([cap, k], within range)."""
    return torch.gather(x, 1, idx.long())


def _list(data, validity, dtype, dictionary, lengths, ev) -> DeviceColumn:
    return DeviceColumn(data, validity, dtype, dictionary, None, lengths, ev)


def _compact_rows(col: DeviceColumn, keep: torch.Tensor) -> DeviceColumn:
    """Stable per-row compaction: the kept slots move to the front and the
    lengths become the kept counts. keep: [cap, width] over col's slots."""
    keep = keep & col.slot_valid()
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    return _list(torch.gather(col.data, 1, order), col.validity, col.dtype,
                 col.dictionary, keep.sum(1, dtype=torch.int32),
                 torch.gather(keep, 1, order))


def _remap(work, i: int, data: torch.Tensor, miss: int) -> torch.Tensor:
    """data's codes through the translation table work.value[i] (`miss` for
    every code when the table is empty)."""
    if len(work.value[i]) == 0:
        return torch.full_like(data, miss, dtype=torch.int32)
    return work.lookup(i, data).to(torch.int32)


def _elem_eq(col: DeviceColumn, value: DeviceColumn) -> torch.Tensor:
    """[cap, width] mask: slot element == the row's scalar value (NULL never
    equals)."""
    v = value.data
    if col.dictionary is not None and value.dictionary is not None \
            and col.dictionary is not value.dictionary:
        from .expr_compiler import dictionary_work

        src_d, tgt_d = value.dictionary, col.dictionary

        def compute():
            # the probe's codes onto the list's dictionary (exact match or -1)
            src = np.asarray(src_d.values).astype(str)
            tgt = np.asarray(tgt_d.values).astype(str)
            pos = np.searchsorted(tgt, src).clip(0, max(len(tgt) - 1, 0))
            hit = (tgt[pos] == src) if len(tgt) else np.zeros(len(src), bool)
            return (np.where(hit, pos, -1).astype(np.int32),)

        v = _remap(dictionary_work((src_d, tgt_d), "elem_remap", (), compute),
                   0, v, -1)
    return (col.data == v[:, None]) & col.slot_valid() & value.valid()[:, None]


def _pair_widen(a: DeviceColumn, b: DeviceColumn):
    """Two list columns of strings on one dictionary, for slot comparison."""
    if a.dictionary is not None and b.dictionary is not None \
            and a.dictionary is not b.dictionary:
        from .expr_compiler import merge_dictionaries

        work = merge_dictionaries(a.dictionary, b.dictionary)
        d = work.value[0]
        a = _list(_remap(work, 1, a.data, 0), a.validity, a.dtype, d,
                  a.lengths, a.elem_valid)
        b = _list(_remap(work, 2, b.data, 0), b.validity, b.dtype, d,
                  b.lengths, b.elem_valid)
    return a, b


def _sort_key(col: DeviceColumn, descending=False) -> torch.Tensor:
    """Per-slot sort key; padding and NULL slots sort last."""
    x = col.data
    if x.dtype is torch.bool:
        x = x.to(torch.int32)
    if descending:
        x = -x
    big = (float("inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).max)
    return torch.where(col.slot_valid(), x, torch.full_like(x, big))


def _literal_int(e: Optional[E.Expr], what: str) -> int:
    le = e
    while isinstance(le, (E.Alias, E.Cast)):
        le = le.expr
    if not isinstance(le, E.Literal) or le.value is None:
        raise PlanError(f"{what} must be an integer literal (static width)")
    return int(le.value)


def _literal_str(e: E.Expr) -> str:
    le = e
    while isinstance(le, (E.Alias, E.Cast)):
        le = le.expr
    if not isinstance(le, E.Literal):
        raise PlanError("expected a string literal")
    return str(le.value)


def _first_occurrence(a: DeviceColumn) -> torch.Tensor:
    """[cap, w] mask of the FIRST slot of each distinct value in each row."""
    sv = a.slot_valid()
    eqs = (a.data[:, :, None] == a.data[:, None, :]) & sv[:, None, :]
    w = a.width
    earlier = torch.tril(torch.ones((w, w), dtype=torch.bool, device=sv.device),
                         diagonal=-1)[None, :, :]
    return sv & ~(eqs & earlier).any(2)


# ---------------------------------------------------------------------------
# evaluation (from functions.eval_scalar_function)
# ---------------------------------------------------------------------------


def eval_nested_function(fname: str, args: List[DeviceColumn],
                         arg_exprs: Tuple[E.Expr, ...], out_dtype: T.DataType,
                         cap: int, device) -> DeviceColumn:
    f = canon(fname)
    if args:
        device = args[0].data.device

    if f in _STRUCT_MAP_FNS and not (
            f == "element_at" and args and args[0].dtype.is_list):
        return _eval_struct_map(f, args, arg_exprs, out_dtype, cap, device)
    if f == "element_at":
        f = "array_element"
    if f == "cardinality" and args and args[0].dtype.is_map:
        col = args[0]
        d = col.dictionary

        def lens():
            n = [len(t) for t in d.values] if d is not None and d.size else [0]
            return (np.asarray(n, dtype=np.int64),)

        work = _dict_work(d, "map_cardinality", (), lens)
        return DeviceColumn(work.lookup(0, col.data), col.validity, T.INT64)

    if f == "make_array":
        return _make_array(args, out_dtype, cap, device)

    col = args[0]
    if f == "array_prepend":
        col = args[1]
    if not col.dtype.is_list and f not in ("array_repeat", "range",
                                           "string_to_array"):
        raise PlanError(f"{fname} expects a list argument")
    impl = _LIST_IMPLS.get(f)
    if impl is None:
        raise PlanError(f"unhandled nested function {fname!r}")
    return impl(f, col, args, arg_exprs, out_dtype, cap)


def _make_array(args, out_dtype, cap, device):
    if not args:
        # [] / make_array(): the empty list of the inferred element type
        return DeviceColumn(
            torch.zeros((cap, 1), dtype=torch_dtype(out_dtype.elem), device=device),
            None, out_dtype, None, None,
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros((cap, 1), dtype=torch.bool, device=device))
    from .expr_compiler import cast_column, unify_many_string_columns

    elem = out_dtype.elem
    dictionary = None
    if elem.is_string:
        args = unify_many_string_columns(list(args))
        dictionary = args[0].dictionary
    cols = [a if a.dtype == elem else cast_column(a, elem, cap) for a in args]
    return DeviceColumn(torch.stack([c.data for c in cols], 1), None, out_dtype,
                        dictionary, None,
                        torch.full((cap,), len(args), dtype=torch.int32, device=device),
                        torch.stack([c.valid() for c in cols], 1))


def _element(f, col, args, ex, out_dtype, cap):
    idx = args[1].data.to(torch.int32)
    lens = col.list_lengths()
    j = torch.where(idx < 0, lens + idx, idx - 1)  # 1-based; negative: from the end
    ok = (j >= 0) & (j < lens) & col.valid() & args[1].valid()
    jc = torch.clamp(j, 0, col.width - 1)[:, None]
    data = _take(col.data, jc)[:, 0]
    sv = _take(col.slot_valid(), jc)[:, 0]
    return DeviceColumn(data, ok & sv, out_dtype, col.dictionary)


def _length(f, col, args, ex, out_dtype, cap):
    dev = col.data.device
    if f in ("array_length", "cardinality"):
        return DeviceColumn(col.list_lengths().to(torch.int64), col.validity, T.INT64)
    if f == "array_ndims":
        return DeviceColumn(torch.ones(cap, dtype=torch.int64, device=dev),
                            col.validity, T.INT64)
    if f == "array_dims":
        return DeviceColumn(col.list_lengths().to(torch.int64)[:, None], col.validity,
                            out_dtype, None, None,
                            torch.ones(cap, dtype=torch.int32, device=dev), None)
    return DeviceColumn(col.list_lengths() == 0, col.validity, T.BOOL)  # empty


def _has(f, col, args, ex, out_dtype, cap):
    if f == "array_has":
        return DeviceColumn(_elem_eq(col, args[1]).any(1), col.validity, T.BOOL)
    a, b = _pair_widen(col, args[1])
    # membership of each b slot in a: [cap, wb]
    bsv = b.slot_valid()
    hit = ((b.data[:, :, None] == a.data[:, None, :])
           & a.slot_valid()[:, None, :]).any(2) & bsv
    out = hit.any(1) if f == "array_has_any" else (hit | ~bsv).all(1)
    return DeviceColumn(out, col.validity, T.BOOL)


def _position(f, col, args, ex, out_dtype, cap):
    eq = _elem_eq(col, args[1])
    if f == "array_position":
        pos = torch.argmax(eq.to(torch.int8), 1).to(torch.int64) + 1
        return DeviceColumn(pos, eq.any(1) & col.valid(), T.INT64)
    positions = (_iota(cap, col.width, eq.device) + 1).to(torch.int64)
    out = DeviceColumn(positions, col.validity, out_dtype, None, None,
                       torch.full((cap,), col.width, dtype=torch.int32,
                                  device=eq.device), None)
    return _compact_rows(out, eq)


def _append_prepend(f, col, args, ex, out_dtype, cap):
    from .expr_compiler import cast_column, unify_many_string_columns

    lst, val = (args[0], args[1]) if f == "array_append" else (args[1], args[0])
    if lst.dtype.elem.is_string:
        flat = DeviceColumn(lst.data.reshape(-1), None, T.STRING, lst.dictionary)
        flat2, val = unify_many_string_columns([flat, val])
        lst = _list(flat2.data.reshape(lst.data.shape), lst.validity,
                    lst.dtype, flat2.dictionary, lst.lengths, lst.elem_valid)
    elif val.dtype != lst.dtype.elem:
        val = cast_column(val, lst.dtype.elem, cap)
    dev = lst.data.device
    vd = val.data.to(lst.data.dtype)[:, None]
    if f == "array_append":
        data = torch.cat([lst.data, torch.zeros((cap, 1), dtype=lst.data.dtype,
                                                device=dev)], 1)
        ev = torch.cat([lst.slot_valid(),
                        torch.zeros((cap, 1), dtype=torch.bool, device=dev)], 1)
        at = _iota(cap, lst.width + 1, dev) == lst.list_lengths()[:, None]
        data = torch.where(at, vd, data)
        ev = torch.where(at, val.valid()[:, None], ev)
    else:
        data = torch.cat([vd, lst.data], 1)
        ev = torch.cat([val.valid()[:, None], lst.slot_valid()], 1)
    return _list(data, lst.validity, out_dtype, lst.dictionary,
                 lst.list_lengths() + 1, ev)


def _concat(f, col, args, ex, out_dtype, cap):
    a = col
    dev = col.data.device
    for b in args[1:]:
        a, b = _pair_widen(a, b)
        wa, wb = a.width, b.width
        la = a.list_lengths()
        grid = _iota(cap, wa + wb, dev)
        ga = torch.clamp(grid, 0, wa - 1)
        gb = torch.clamp(grid - la[:, None], 0, wb - 1)  # index into b
        use_a = grid < la[:, None]
        data = torch.where(use_a, _take(a.data, ga), _take(b.data, gb))
        ev = torch.where(use_a, _take(a.slot_valid(), ga), _take(b.slot_valid(), gb))
        a = _list(data, None, out_dtype, a.dictionary, la + b.list_lengths(), ev)
    validity = None
    if any(c.validity is not None for c in args):
        validity = args[0].valid()
        for c in args[1:]:
            validity = validity & c.valid()
    return _list(a.data, validity, out_dtype, a.dictionary, a.lengths,
                 a.elem_valid)


def _slice(f, col, args, ex, out_dtype, cap):
    start = args[1].data.to(torch.int32)
    stop = args[2].data.to(torch.int32)
    lens = col.list_lengths()
    start = torch.where(start < 0, lens + start + 1, start)
    stop = torch.where(stop < 0, lens + stop + 1, stop)
    start = torch.clamp(start, min=1)
    stop = torch.minimum(stop, lens)
    w = col.width
    grid = _iota(cap, w, lens.device)
    src = torch.clamp(grid + start[:, None] - 1, 0, w - 1)
    newlen = torch.clamp(stop - start + 1, min=0)
    ev = _take(col.slot_valid(), src) & (grid < newlen[:, None])
    return _list(_take(col.data, src), col.validity, out_dtype,
                 col.dictionary, newlen, ev)


def _reverse(f, col, args, ex, out_dtype, cap):
    w = col.width
    lens = col.list_lengths()
    src = lens[:, None] - 1 - _iota(cap, w, lens.device)
    srcc = torch.clamp(src, 0, w - 1)
    ev = _take(col.slot_valid(), srcc) & (src >= 0)
    return _list(_take(col.data, srcc), col.validity, out_dtype,
                 col.dictionary, lens, ev)


def _pop(f, col, args, ex, out_dtype, cap):
    lens = col.list_lengths()
    grid = _iota(cap, col.width, lens.device)
    if f == "array_pop_back":
        return _compact_rows(col, grid < (lens - 1)[:, None])
    return _compact_rows(col, (grid >= 1) & (grid < lens[:, None]))


def _sort(f, col, args, ex, out_dtype, cap):
    desc = False
    if len(args) > 1:
        desc = _literal_str(ex[1]).lower().startswith("desc")
    order = torch.sort(_sort_key(col, descending=desc), dim=1, stable=True).indices
    return _list(torch.gather(col.data, 1, order), col.validity, out_dtype,
                 col.dictionary, col.list_lengths(),
                 torch.gather(col.slot_valid(), 1, order))


def _distinct(f, col, args, ex, out_dtype, cap):
    # first-occurrence order, like the reference's array_distinct
    out = _list(col.data, col.validity, out_dtype, col.dictionary,
                col.lengths, col.elem_valid)
    return _compact_rows(out, _first_occurrence(col))


def _set_op(f, col, args, ex, out_dtype, cap):
    a, b = _pair_widen(col, args[1])
    if f == "array_union":  # a's firsts ++ b's firsts not in a
        cat = _concat("array_concat", a, [a, b], ex, out_dtype, cap)
        return _distinct("array_distinct", cat, [cat], ex, out_dtype, cap)
    in_b = ((a.data[:, :, None] == b.data[:, None, :])
            & b.slot_valid()[:, None, :]).any(2)
    keep = in_b if f == "array_intersect" else ~in_b
    out = _list(a.data, a.validity, out_dtype, a.dictionary, a.lengths,
                a.elem_valid)
    return _compact_rows(out, keep & _first_occurrence(a))


def _remove(f, col, args, ex, out_dtype, cap):
    eq = _elem_eq(col, args[1])
    if f == "array_remove_all":
        return _compact_rows(col, ~eq)
    if f == "array_remove_n":
        n = args[2].data.to(torch.int32)
    else:
        n = torch.ones(cap, dtype=torch.int32, device=eq.device)
    nth = torch.cumsum(eq, 1, dtype=torch.int32)
    return _compact_rows(col, ~(eq & (nth <= n[:, None])))


def _repeat(f, col, args, ex, out_dtype, cap):
    w = max(_literal_int(ex[1], "array_repeat count"), 1)
    n = args[1].data.to(torch.int32)
    v = args[0]
    ev = v.valid()[:, None].expand(cap, w) & (_iota(cap, w, n.device) < n[:, None])
    return DeviceColumn(v.data[:, None].expand(cap, w).contiguous(), None, out_dtype,
                        v.dictionary, None, torch.clamp(n, 0, w), ev)


def _resize(f, col, args, ex, out_dtype, cap):
    size = max(_literal_int(ex[1], "array_resize size"), 1)
    if size * max(cap, 1) > (1 << 28):
        # a [capacity, size] buffer this large is refused, as the
        # reference refuses its i64::MAX / 3e9-element sizes
        raise PlanError(
            f"array_resize: new size {size} too large for capacity {cap}")
    n = torch.clamp(args[1].data.to(torch.int32), 0, size)
    w = col.width
    lens = col.list_lengths()
    grid = _iota(cap, size, n.device)
    src = torch.clamp(grid, 0, w - 1)
    data = _take(col.data, src) if size != w else col.data
    ev = _take(col.slot_valid(), src) & (grid < lens[:, None])
    if len(args) > 2:
        fill = args[2]
        beyond = (grid >= lens[:, None]) & (grid < n[:, None])
        data = torch.where(beyond, fill.data.to(data.dtype)[:, None], data)
        ev = ev | (beyond & fill.valid()[:, None])
    return _list(data, col.validity, out_dtype, col.dictionary, n, ev)


def _reduce(f, col, args, ex, out_dtype, cap):
    sv = col.slot_valid()
    any_valid = sv.any(1) & col.valid()
    if f == "array_any_value":
        first = torch.argmax(sv.to(torch.int8), 1)[:, None]
        return DeviceColumn(_take(col.data, first)[:, 0], any_valid, out_dtype,
                            col.dictionary)
    x = col.data
    if f in ("array_max", "array_min"):
        if x.dtype is torch.bool:
            x = x.to(torch.int32)
        if x.dtype.is_floating_point:
            neutral = float("-inf") if f == "array_max" else float("inf")
        else:
            info = torch.iinfo(x.dtype)
            neutral = info.min if f == "array_max" else info.max
        masked = torch.where(sv, x, torch.full_like(x, neutral))
        out = masked.amax(1) if f == "array_max" else masked.amin(1)
        if col.dtype.elem.kind is T.TypeKind.BOOL:
            out = out.to(torch.bool)
        return DeviceColumn(out, any_valid, out_dtype, col.dictionary)
    acc_t = torch.float64 if out_dtype.is_float else torch.int64
    acc = torch.where(sv, x, torch.zeros_like(x)).to(acc_t).sum(1)
    if f == "array_mean":
        cnt = sv.sum(1)
        return DeviceColumn(acc.to(torch.float64) / torch.clamp(cnt, min=1),
                            any_valid & (cnt > 0), T.FLOAT64)
    if out_dtype.is_decimal or not out_dtype.is_float:
        return DeviceColumn(acc.to(torch.int64), any_valid, out_dtype)
    return DeviceColumn(acc.to(torch.float64), any_valid, out_dtype)


def _range(f, col, args, ex, out_dtype, cap):
    # range(stop) / range(start, stop[, step]); literal bounds set the width
    if len(ex) == 1:
        lo, hi, st = 0, _literal_int(ex[0], "range stop"), 1
    else:
        lo = _literal_int(ex[0], "range start")
        hi = _literal_int(ex[1], "range stop")
        st = _literal_int(ex[2], "range step") if len(ex) > 2 else 1
    if st == 0:
        raise PlanError("range step must be nonzero")
    count = max((hi - lo + st - (1 if st > 0 else -1)) // st, 0)
    dev = col.data.device
    grid = _iota(cap, max(count, 1), dev).to(torch.int64)
    return DeviceColumn(lo + grid * st, None, out_dtype, None, None,
                        torch.full((cap,), count, dtype=torch.int32, device=dev),
                        grid < count)


def _string_to_array(f, col, args, ex, out_dtype, cap):
    """Split a string column on a literal delimiter: the distinct values are
    split on the host (once per dictionary), the rows gather their split by
    code."""
    if col.dictionary is None:
        raise PlanError("string_to_array needs a dictionary-encoded column")
    delim = _literal_str(ex[1])
    d = col.dictionary

    def compute():
        vals = [str(v) for v in d.values]
        splits = [v.split(delim) if delim else list(v) for v in vals]
        w = max([len(s) for s in splits] or [1]) or 1
        pieces = sorted({p for s in splits for p in s})
        table = np.zeros((max(len(vals), 1), w), dtype=np.int32)
        lens = np.zeros(max(len(vals), 1), dtype=np.int32)
        lut = {p: i for i, p in enumerate(pieces)}
        for i, s in enumerate(splits):
            lens[i] = len(s)
            table[i, :len(s)] = [lut[p] for p in s]
        return Dictionary(np.array(pieces, dtype=object)), table, lens

    work = _dict_work(d, "string_to_array", (delim,), compute)
    lengths = work.lookup(2, col.data)
    data = work.lookup(1, col.data)
    ev = _iota(cap, data.shape[1], data.device) < lengths[:, None]
    return DeviceColumn(data, col.validity, out_dtype, work.value[0], None,
                        lengths, ev)


_LIST_IMPLS = {}
for _names, _fn in (
        (("array_element",), _element),
        (("array_length", "cardinality", "array_ndims", "array_dims", "empty"), _length),
        (("array_has", "array_has_all", "array_has_any"), _has),
        (("array_position", "array_positions"), _position),
        (("array_append", "array_prepend"), _append_prepend),
        (("array_concat",), _concat),
        (("array_slice",), _slice),
        (("array_reverse",), _reverse),
        (("array_pop_back", "array_pop_front"), _pop),
        (("array_sort",), _sort),
        (("array_distinct",), _distinct),
        (("array_union", "array_intersect", "array_except"), _set_op),
        (("array_remove", "array_remove_all", "array_remove_n"), _remove),
        (("array_repeat",), _repeat),
        (("array_resize",), _resize),
        (("array_any_value", "array_max", "array_min", "array_sum", "array_mean"),
         _reduce),
        (("range",), _range),
        (("string_to_array",), _string_to_array)):
    for _n in _names:
        _LIST_IMPLS[_n] = _fn


def _dict_work(d: Optional[Dictionary], op: str, args: tuple, compute):
    """dictionary_work over one (possibly missing) dictionary."""
    from .expr_compiler import EMPTY_DICTIONARY, dictionary_work

    return dictionary_work((d if d is not None else EMPTY_DICTIONARY,), op, args,
                           compute)


# ---------------------------------------------------------------------------
# lambda higher-order functions
# ---------------------------------------------------------------------------


def eval_lambda_function(fname: str, arg_exprs, rel, out_dtype: T.DataType
                         ) -> DeviceColumn:
    """array_transform / array_filter / array_any_match / array_all_match.
    The body runs as an ordinary expression over the flattened
    [capacity * width] element axis; the outer columns it reads are
    repeated per element (a column it does not read is left out)."""
    from ..common.schema import Field, Schema
    from ..data.device import DeviceRelation
    from .expr_compiler import cast_column, eval_expr

    f = canon(fname)
    lam = arg_exprs[1]
    if not isinstance(lam, E.Lambda):
        raise PlanError(f"{fname} expects a lambda as 2nd argument")
    col = eval_expr(arg_exprs[0], rel)
    _need_list(col.dtype, f)
    cap, w = col.capacity, col.width
    n = cap * w
    elem = col.dtype.elem
    dev = col.data.device
    lengths = col.list_lengths()

    # `present`: the slot is within the list; `value_ok`: present and not
    # NULL. A present NULL element reaches the body as NULL, for 3VL any/all
    present2 = _iota(cap, w, dev) < lengths[:, None]
    present = present2.reshape(n)
    fields = [Field(lam.params[0], elem, nullable=True)]
    cols = [DeviceColumn(col.data.reshape(n), col.slot_valid().reshape(n) & present,
                         elem, col.dictionary)]
    if len(lam.params) > 1:  # (value, index): the 1-based element index
        fields.append(Field(lam.params[1], T.INT64, nullable=False))
        cols.append(DeviceColumn(
            torch.arange(1, w + 1, dtype=torch.int64, device=dev).repeat(cap),
            None, T.INT64))
    outer = [(fld, c) for fld, c in zip(rel.schema.fields, rel.columns)
             if fld.name not in lam.params]
    outer_schema = Schema([fld for fld, _ in outer])
    read = set()
    for ref in E.collect_columns(lam.body):
        i = outer_schema.find(ref.flat_name)
        if i is not None:
            read.add(i)

    def rep(t):
        return K.repeat_rows(t, w)

    for i, (fld, c) in enumerate(outer):
        if i in read:
            fields.append(fld)
            cols.append(DeviceColumn(rep(c.data), rep(c.validity), c.dtype,
                                     c.dictionary, c.bounds, rep(c.lengths),
                                     rep(c.elem_valid), c.meta))
    synth = DeviceRelation(Schema(fields), cols, rep(rel.sel) & present)
    body = eval_expr(lam.body, synth)

    if f == "array_transform":
        out_elem = out_dtype.elem
        b = body if body.dtype == out_elem else cast_column(body, out_elem, n)
        ev = (b.valid() & present).reshape(cap, w)
        return DeviceColumn(b.data.reshape((cap, w) + tuple(b.data.shape[1:])),
                            col.validity, out_dtype, b.dictionary, None, lengths, ev)
    bv = body.valid()
    mask2 = (body.data & bv & present).reshape(cap, w)
    if f == "array_filter":
        order = torch.sort((~mask2).to(torch.uint8), dim=1, stable=True).indices
        new_len = mask2.sum(1, dtype=torch.int32)
        ev = _iota(cap, w, dev) < new_len[:, None]
        return DeviceColumn(torch.gather(col.data, 1, order), col.validity,
                            out_dtype, col.dictionary, None, new_len, ev)
    # any/all with SQL 3VL: a NULL body over a present slot makes the
    # reduction NULL unless a TRUE (any) / FALSE (all) decides it
    any_null = (~bv & present).reshape(cap, w).any(1)
    if f == "array_any_match":
        any_true = mask2.any(1)
        return DeviceColumn(any_true, col.valid() & (any_true | ~any_null), T.BOOL)
    any_false = ((~body.data) & bv & present).reshape(cap, w).any(1)
    return DeviceColumn(~any_false & ~any_null, col.valid() & (any_false | ~any_null),
                        T.BOOL)


# ---------------------------------------------------------------------------
# structs and maps: sorted-dictionary codes, host tables gathered by code
# ---------------------------------------------------------------------------


def _lut_column(col: DeviceColumn, op: str, key, values_of, ft: T.DataType
                ) -> DeviceColumn:
    """The column of values_of(dictionary)[code] for a struct/map column:
    one Python value per dictionary entry (None = NULL), encoded once per
    dictionary (a struct field re-encoded as its own dictionary)."""
    if ft.is_list:
        raise PlanError("nested list fields inside struct are not "
                        "supported (depth-1 lists only)")
    d = col.dictionary

    def compute():
        from ..data.column import column_from_values

        hc = column_from_values(list(values_of(d)), ft)
        lut = np.asarray(hc.data, dtype=ft.np_dtype())
        lut_valid = hc.valid_mask()
        if lut.size == 0:
            lut = np.zeros(1, dtype=ft.np_dtype())
            lut_valid = np.zeros(1, dtype=bool)
        return lut, lut_valid, hc.dictionary

    work = _dict_work(d, op, key, compute)
    return DeviceColumn(work.lookup(0, col.data),
                        col.valid() & work.lookup(1, col.data), ft, work.value[2])


def _entry_list_arrays(entries, elem: T.DataType):
    """Per-dictionary-entry Python lists -> (data2d, lengths, elem_valid,
    dictionary) host arrays, a list column's lookup table."""
    D = max(len(entries), 1)
    W = max([len(x) for x in entries] + [1])
    dictionary = None
    if elem.is_string:
        flat = sorted({str(v) for row in entries for v in row if v is not None})
        dictionary = Dictionary(np.array(flat, dtype=object))
        lut = {v: i for i, v in enumerate(flat)}
        entries = [[None if v is None else lut[str(v)] for v in row]
                   for row in entries]
    data = np.zeros((D, W), dtype=elem.np_dtype())
    ev = np.zeros((D, W), dtype=bool)
    lengths = np.zeros(D, dtype=np.int32)
    from ..data.column import _coerce_elem

    for i, row in enumerate(entries):
        lengths[i] = len(row)
        for j, v in enumerate(row):
            if v is None:
                continue
            ev[i, j] = True
            data[i, j] = v if elem.is_string else _coerce_elem(v, elem)
    return data, lengths, ev, dictionary


def _map_pairs(d: Optional[Dictionary]):
    return [list(t) for t in d.values] if d is not None and d.size else [[]]


def _list_lut(col: DeviceColumn, op: str, key, rows_of, elem: T.DataType,
              dtype: T.DataType, dictionary_of=None) -> DeviceColumn:
    """A list column gathered by code from per-entry Python lists."""
    d = col.dictionary

    def compute():
        data, lengths, ev, dd = _entry_list_arrays(rows_of(d), elem)
        return data, lengths, ev, dd if dictionary_of is None else dictionary_of(d)

    work = _dict_work(d, op, key, compute)
    return DeviceColumn(work.lookup(0, col.data), col.validity, dtype,
                        work.value[3], None, work.lookup(1, col.data),
                        work.lookup(2, col.data))


def _pair_dictionary(d):
    """The sorted distinct (key, value) pairs of a map dictionary, and each
    entry's pairs as codes into them (map_entries)."""
    flat_rows = [[tuple(kv) for kv in t] for t in _map_pairs(d)]
    distinct = sorted({p for row in flat_rows for p in row}, key=lambda x: (str(x),))
    lutp = {p: i for i, p in enumerate(distinct)}
    dvals = np.empty(max(len(distinct), 1), dtype=object)
    for i, p in enumerate(distinct):
        dvals[i] = p
    return [[lutp[p] for p in row] for row in flat_rows], Dictionary(dvals)


def _literal_struct_map(f: str, arg_exprs, out_dtype: T.DataType):
    """The one value of a literal struct or map constructor, canonical."""
    from ..data.column import _canon_struct

    if f == "named_struct":
        vals = [_literal_py(a) for a in arg_exprs]
        value = {str(vals[i]): vals[i + 1] for i in range(0, len(vals), 2)}
    elif f in ("struct", "row"):
        value = {(a.aname if isinstance(a, E.Alias) else f"c{i}"):
                 _literal_py(a) for i, a in enumerate(arg_exprs)}
    elif f == "map" and len(arg_exprs) == 2:
        ks = _literal_py(arg_exprs[0]) or []
        vs = _literal_py(arg_exprs[1]) or []
        if len(set(ks)) != len(ks):
            # the reference's default map_key_dedup_policy is Exception
            raise PlanError("map keys must be unique")
        value = dict(zip(ks, vs))
    else:
        vals = [_literal_py(a) for a in arg_exprs]
        if len(set(vals[0::2])) != len(vals[0::2]):
            raise PlanError("map keys must be unique")
        value = dict(zip(vals[0::2], vals[1::2]))
    return _canon_struct(value, out_dtype)


def _eval_struct_map(f: str, args: List[DeviceColumn], arg_exprs: Tuple[E.Expr, ...],
                     out_dtype: T.DataType, cap: int, device) -> DeviceColumn:
    if f in ("named_struct", "struct", "row", "map", "make_map"):
        # a literal: one dictionary entry (made once per value), constant codes
        tup = _literal_struct_map(f, arg_exprs, out_dtype)

        def one():
            dvals = np.empty(1, dtype=object)
            dvals[0] = tup
            return (Dictionary(dvals),)

        from .expr_compiler import dictionary_work

        d = dictionary_work((), "literal_struct", (repr(out_dtype), repr(tup)),
                            one).value[0]
        return DeviceColumn(torch.zeros(cap, dtype=torch.int32, device=device), None,
                            out_dtype, d)

    col = args[0]
    dt = col.dtype
    if f == "get_field" and dt.is_struct:
        name = _field_name(arg_exprs[1])
        idx = [n for n, _t in dt.fields].index(name)
        return _lut_column(col, "struct_field", (name,),
                           lambda d: [t[idx] for t in (d.values if d is not None else [])],
                           dict(dt.fields)[name])

    _need_map(dt, f)
    kt, vt = dt.fields[0][1], dt.elem
    if f in ("get_field", "element_at", "map_contains_key"):
        key = _literal_py(arg_exprs[1])
        if f == "map_contains_key":
            def has():
                return (np.asarray([key in dict(t) for t in _map_pairs(col.dictionary)],
                                   dtype=bool),)

            work = _dict_work(col.dictionary, "map_has", (repr(key),), has)
            return DeviceColumn(work.lookup(0, col.data), col.validity, T.BOOL)
        return _lut_column(col, "map_get", (repr(key),),
                           lambda d: [dict(t).get(key) for t in _map_pairs(d)], vt)
    if f == "map_extract":
        # a 0/1-element LIST of the value, as the reference
        key = _literal_py(arg_exprs[1])
        return _list_lut(col, "map_extract", (repr(key),),
                         lambda d: [([dict(t)[key]] if key in dict(t) else [])
                                    for t in _map_pairs(d)],
                         vt, T.list_of(vt))
    if f in ("map_keys", "map_values"):
        j = 0 if f == "map_keys" else 1
        elem = kt if f == "map_keys" else vt
        return _list_lut(col, f, (), lambda d: [[kv[j] for kv in t] for t in _map_pairs(d)],
                         elem, T.list_of(elem))
    if f == "map_entries":
        # a list of {key, value} structs: each distinct pair one code
        return _list_lut(col, f, (), lambda d: _pair_dictionary(d)[0], T.INT32,
                         T.list_of(out_dtype.elem),
                         dictionary_of=lambda d: _pair_dictionary(d)[1])
    raise PlanError(f"struct/map function {f!r} not implemented")
