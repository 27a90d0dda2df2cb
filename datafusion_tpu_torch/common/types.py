# Verbatim copy of datafusion_tpu/common/types.py; host-only, kept in step with the original.
"""Logical type system for the TPU-native query engine.

Mirrors the *capability* of Arrow's DataType as used by the reference engine
(datafusion/common/src/scalar/mod.rs, dfschema.rs) but designed for TPU
execution: every logical type maps onto a fixed-width device representation.

Device mapping:
  BOOL          -> bool_
  INT8/16/32/64 -> int32 / int64  (narrow ints widened to int32 on device)
  FLOAT32/64    -> float32 / float64
  DECIMAL(p,s)  -> int64 of scaled integer units (exact arithmetic; the
                   reference uses i128 decimals -- we track scale in the type
                   and keep sums in int64, see ops/aggregate.py)
  DATE32        -> int32 days since epoch
  TIMESTAMP_US  -> int64 microseconds since epoch
  STRING        -> int32 dictionary codes; the (order-preserving, sorted)
                   dictionary lives host-side (data/column.py)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class TypeKind(enum.Enum):
    NULL = "null"
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DECIMAL = "decimal"
    DATE32 = "date32"
    TIMESTAMP = "timestamp"  # microseconds
    TIME = "time"  # microseconds since midnight (reference: Time64)
    STRING = "string"
    BINARY = "binary"  # bytes; dictionary-encoded like STRING
    INTERVAL_DAYS = "interval_days"  # internal: calendar interval in days
    INTERVAL_US = "interval_us"  # internal: sub-day interval in microseconds
    INTERVAL_MONTHS = "interval_months"
    LIST = "list"
    STRUCT = "struct"
    MAP = "map"


@dataclasses.dataclass(frozen=True)
class DataType:
    kind: TypeKind
    precision: Optional[int] = None  # DECIMAL only
    scale: Optional[int] = None  # DECIMAL only
    elem: Optional["DataType"] = None  # LIST: element; MAP: value type
    # STRUCT: ordered (name, type) field tuple; MAP: (("key", kt),)
    fields: Optional[tuple] = None

    def __repr__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"Decimal({self.precision},{self.scale})"
        if self.kind is TypeKind.LIST:
            return f"List({self.elem!r})"
        if self.kind is TypeKind.STRUCT:
            inner = ", ".join(f"{n}: {t!r}" for n, t in (self.fields or ()))
            return f"Struct({inner})"
        if self.kind is TypeKind.MAP:
            return f"Map({self.fields[0][1]!r}, {self.elem!r})"
        return self.kind.value

    # ---- classification -------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self.kind in _NUMERIC_KINDS

    @property
    def is_integer(self) -> bool:
        return self.kind in (
            TypeKind.INT8,
            TypeKind.INT16,
            TypeKind.INT32,
            TypeKind.INT64,
        )

    @property
    def is_float(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_decimal(self) -> bool:
        return self.kind is TypeKind.DECIMAL

    @property
    def is_temporal(self) -> bool:
        return self.kind in (TypeKind.DATE32, TypeKind.TIMESTAMP)

    @property
    def is_string(self) -> bool:
        # BINARY shares the string device representation end-to-end
        # (sorted dictionary + order-preserving int32 codes); sites that
        # need genuine text (string functions, casts, display) check
        # is_binary to branch
        return self.kind in (TypeKind.STRING, TypeKind.BINARY)

    @property
    def is_binary(self) -> bool:
        return self.kind is TypeKind.BINARY

    @property
    def is_struct(self) -> bool:
        return self.kind is TypeKind.STRUCT

    @property
    def is_map(self) -> bool:
        return self.kind is TypeKind.MAP

    @property
    def is_list(self) -> bool:
        return self.kind is TypeKind.LIST

    # ---- device representation -----------------------------------------
    def np_dtype(self) -> np.dtype:
        """The numpy/JAX dtype of this logical type's device representation."""
        k = self.kind
        if k is TypeKind.BOOL:
            return np.dtype(np.bool_)
        if k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32):
            return np.dtype(np.int32)
        if k is TypeKind.INT64:
            return np.dtype(np.int64)
        if k is TypeKind.FLOAT32:
            return np.dtype(np.float32)
        if k is TypeKind.FLOAT64:
            return np.dtype(np.float64)
        if k is TypeKind.DECIMAL:
            return np.dtype(np.int64)
        if k is TypeKind.DATE32:
            return np.dtype(np.int32)
        if k is TypeKind.TIMESTAMP:
            return np.dtype(np.int64)
        if k is TypeKind.TIME:
            return np.dtype(np.int64)
        if k in (TypeKind.STRING, TypeKind.BINARY):
            return np.dtype(np.int32)  # dictionary codes
        if k is TypeKind.INTERVAL_DAYS:
            return np.dtype(np.int32)
        if k is TypeKind.INTERVAL_US:
            return np.dtype(np.int64)
        if k is TypeKind.INTERVAL_MONTHS:
            return np.dtype(np.int32)
        if k is TypeKind.NULL:
            return np.dtype(np.int32)
        if k is TypeKind.LIST:
            # device representation: [capacity, width] of the element's
            # device dtype, plus per-row lengths (data/device.py)
            return self.elem.np_dtype()
        if k in (TypeKind.STRUCT, TypeKind.MAP):
            return np.dtype(np.int32)  # opaque sorted-dictionary codes
        raise NotImplementedError(k)


# Singletons / constructors
NULL = DataType(TypeKind.NULL)
BOOL = DataType(TypeKind.BOOL)
INT8 = DataType(TypeKind.INT8)
INT16 = DataType(TypeKind.INT16)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
DATE32 = DataType(TypeKind.DATE32)
TIMESTAMP = DataType(TypeKind.TIMESTAMP)
TIME = DataType(TypeKind.TIME)
STRING = DataType(TypeKind.STRING)
BINARY = DataType(TypeKind.BINARY)
INTERVAL_DAYS = DataType(TypeKind.INTERVAL_DAYS)
INTERVAL_MONTHS = DataType(TypeKind.INTERVAL_MONTHS)
INTERVAL_US = DataType(TypeKind.INTERVAL_US)


def decimal(precision: int, scale: int) -> DataType:
    return DataType(TypeKind.DECIMAL, precision=precision, scale=scale)


def list_of(elem: DataType) -> DataType:
    return DataType(TypeKind.LIST, elem=elem)


def struct(fields) -> DataType:
    """Struct type: ordered (name, DataType) pairs. Device representation
    is an int32 code into a SORTED dictionary of value tuples -- the same
    order-preserving opaque encoding strings use (SURVEY.md §7 'variable
    length data normalized to dictionary codes'), so group/sort/distinct
    ride the ordinary code paths."""
    return DataType(TypeKind.STRUCT, fields=tuple((str(n), t) for n, t in fields))


def map_of(key: DataType, value: DataType) -> DataType:
    """Map type: per-row sorted (key, value) pair tuples behind the same
    opaque dictionary-code representation as struct."""
    return DataType(TypeKind.MAP, elem=value, fields=(("key", key),))


_NUMERIC_KINDS = frozenset(
    {
        TypeKind.INT8,
        TypeKind.INT16,
        TypeKind.INT32,
        TypeKind.INT64,
        TypeKind.FLOAT32,
        TypeKind.FLOAT64,
        TypeKind.DECIMAL,
    }
)

_INT_ORDER = [TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64]


def common_numeric_type(a: DataType, b: DataType) -> DataType:
    """Binary-op coercion, modeled on the reference's type_coercion rules
    (datafusion/expr-common/src/type_coercion/binary.rs behavior):
    float beats decimal beats int; decimals unify scale to max."""
    if a == b:
        return a
    if a.is_float or b.is_float:
        if TypeKind.FLOAT64 in (a.kind, b.kind) or a.is_decimal or b.is_decimal \
                or TypeKind.INT64 in (a.kind, b.kind):
            return FLOAT64
        return FLOAT32 if (a.is_float and b.is_float) else FLOAT64
    if a.is_decimal or b.is_decimal:
        sa = a.scale if a.is_decimal else 0
        sb = b.scale if b.is_decimal else 0
        pa = a.precision if a.is_decimal else 20
        pb = b.precision if b.is_decimal else 20
        s = max(sa, sb)
        p = min(38, max(pa - sa, pb - sb) + s)
        return decimal(p, s)
    if a.is_integer and b.is_integer:
        return DataType(_INT_ORDER[max(_INT_ORDER.index(a.kind), _INT_ORDER.index(b.kind))])
    if a.is_temporal and b.is_temporal:
        return a if a.kind is TypeKind.TIMESTAMP else b
    if a.kind is TypeKind.NULL:
        return b
    if b.kind is TypeKind.NULL:
        return a
    raise TypeError(f"no common type for {a} and {b}")
