"""Vectorized expression evaluation over device relations.

Port of datafusion_tpu/physical/expr_compiler.py to eager torch ops. Each
logical Expr evaluates to a DeviceColumn with Arrow-style null semantics
(three-valued AND/OR, null-propagating arithmetic and comparison); dictionary
work (string literals, dictionary merges) runs on the host and becomes small
index tensors on the relation's device.

Ported: columns, literals, aliases, sort keys, numeric/decimal/temporal
casts, negation, NOT, IS NULL, binary operators (logic, comparison,
arithmetic, decimal and date arithmetic), BETWEEN, interval bounds
propagation and predicates, and the scalar functions physical/functions.py
has. LIKE, CASE, IN lists, the other scalar functions and casts to or from
strings are not ported yet and raise NotImplementedError.
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

_FUNCTIONS_ITEM = "ROADMAP queue 1, item 9 'Function and nested-type breadth'"

# dictionary-merge memo keyed by identity of the two dictionaries; bounded
# LRU so long-lived sessions over many files cannot pin dictionaries forever
_MERGE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_MERGE_CACHE_LIMIT = 256


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to datafusion_tpu_torch yet ({_FUNCTIONS_ITEM})")


def merge_dictionaries(a: Dictionary, b: Dictionary):
    """Merged sorted dictionary + code translation arrays for both inputs.
    A live cache entry pins its input dictionaries (the key is id()-based)."""
    key = (id(a), id(b))
    hit = _MERGE_CACHE.get(key)
    if hit is not None:
        _MERGE_CACHE.move_to_end(key)
        return hit[2:]
    from ..data.column import as_text_array, is_bytes_values

    if is_bytes_values(a.values) or is_bytes_values(b.values):
        # bytes dictionaries merge in Python (numpy "S" drops trailing NULs)
        mlist = sorted({bytes(v) for v in a.values}
                       | {bytes(v) for v in b.values})
        lut = {v: i for i, v in enumerate(mlist)}
        amap = np.array([lut[bytes(v)] for v in a.values], dtype=np.int32)
        bmap = np.array([lut[bytes(v)] for v in b.values], dtype=np.int32)
        merged = Dictionary(np.array(mlist, dtype=object))
    else:
        av = as_text_array(a.values) if len(a.values) else np.array([], "U1")
        bv = as_text_array(b.values) if len(b.values) else np.array([], "U1")
        m = np.union1d(av, bv)
        amap = np.searchsorted(m, av).astype(np.int32)
        bmap = np.searchsorted(m, bv).astype(np.int32)
        merged = Dictionary(m.astype(object))
    _MERGE_CACHE[key] = (a, b, merged, amap, bmap)
    while len(_MERGE_CACHE) > _MERGE_CACHE_LIMIT:
        _MERGE_CACHE.popitem(last=False)
    return merged, amap, bmap


def _translate_codes(col: DeviceColumn, mapping: np.ndarray,
                     merged: Dictionary) -> DeviceColumn:
    t = col.dtype if col.dtype is not None and col.dtype.is_string else T.STRING
    if len(mapping) == 0:
        return DeviceColumn(torch.zeros_like(col.data), col.validity, t, merged)
    lut = torch.from_numpy(mapping).to(col.data.device)
    codes = lut[col.data.clamp(0, len(mapping) - 1).long()]
    return DeviceColumn(codes, col.validity, t, merged)


def unify_string_columns(l: DeviceColumn, r: DeviceColumn
                         ) -> Tuple[DeviceColumn, DeviceColumn]:
    if l.dictionary is r.dictionary and l.dictionary is not None:
        return l, r
    dl = l.dictionary or Dictionary(np.array([], dtype=object))
    dr = r.dictionary or Dictionary(np.array([], dtype=object))
    merged, ml, mr = merge_dictionaries(dl, dr)
    return _translate_codes(l, ml, merged), _translate_codes(r, mr, merged)


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


def cast_column(col: DeviceColumn, dtype: T.DataType, capacity: int) -> DeviceColumn:
    if col.dtype == dtype:
        return col
    v = col.validity
    if dtype.is_string and col.dtype.is_string and col.dtype.kind == dtype.kind:
        return col
    if dtype.is_string or col.dtype.is_string:
        raise _not_ported(f"cast {col.dtype} -> {dtype}")
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


def _literal_column(e: E.Literal, capacity: int, device) -> DeviceColumn:
    t = e.dtype

    def full(value, dt):
        return torch.full((capacity,), value, dtype=dt, device=device)

    if e.value is None:
        dt = t if t.kind is not T.TypeKind.NULL else T.INT64
        return DeviceColumn(full(0, torch_dtype(dt)), full(False, torch.bool), dt)
    if t.is_binary:
        d = Dictionary(np.array([bytes(e.value)], dtype=object))
        return DeviceColumn(full(0, torch.int32), None, T.BINARY, d)
    if t.is_string:
        d = Dictionary(np.array([str(e.value)], dtype=object))
        return DeviceColumn(full(0, torch.int32), None, T.STRING, d)
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
    return DeviceColumn(full(e.value, torch_dtype(t)), None, t, bounds=b)


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
        # string vs temporal (the string parsed as a date) and binary vs utf8
        # need a string cast
        if l.dtype.is_string != r.dtype.is_string and (
                l.dtype.is_temporal or r.dtype.is_temporal):
            raise _not_ported(f"comparison of {l.dtype} with {r.dtype}")
        if l.dtype.is_string or r.dtype.is_string:
            if l.dtype.is_binary != r.dtype.is_binary \
                    and l.dtype.is_string and r.dtype.is_string:
                raise _not_ported(f"comparison of {l.dtype} with {r.dtype}")
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
        return cast_column(eval_expr(e.expr, rel), e.dtype, cap)
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
        return eval_binary(e, eval_expr(e.left, rel), eval_expr(e.right, rel), schema)
    if isinstance(e, E.Between):
        low = E.BinaryOp(E.Op.GE, e.expr, e.low)
        high = E.BinaryOp(E.Op.LE, e.expr, e.high)
        out = eval_expr(E.BinaryOp(E.Op.AND, low, high), rel)
        if e.negated:
            out = DeviceColumn(~out.data, out.validity, T.BOOL)
        return out
    if isinstance(e, E.ScalarFunction):
        from ..expr.udf import active_registry
        from . import functions as F

        if active_registry().scalar(e.fname) is not None:
            raise _not_ported(f"scalar UDF {e.fname!r}")
        return F.eval_scalar_function(e.fname, [eval_expr(a, rel) for a in e.args])
    if isinstance(e, (E.InList, E.Like, E.Case)):
        raise _not_ported(f"{type(e).__name__} ({e.name()})")
    raise PlanError(f"cannot evaluate {type(e).__name__} on device: {e!r}")


def eval_predicate(e: E.Expr, rel: DeviceRelation) -> torch.Tensor:
    """Evaluate a boolean predicate to a keep-mask (NULL -> False)."""
    c = eval_expr(e, rel)
    mask = c.data
    if c.validity is not None:
        mask = mask & c.validity
    return mask
