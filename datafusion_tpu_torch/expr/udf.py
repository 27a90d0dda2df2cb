# Port of datafusion_tpu/expr/udf.py: lines 1-160 (the registries) verbatim; UDF evaluation is not ported yet.
"""User-defined functions: scalar, aggregate, and window registration.

TPU-native redesign of the reference's UDF traits (datafusion/expr/src/
udf.rs:537 ScalarUDF, udaf.rs:1 AggregateUDF + expr-common/src/
accumulator.rs:51 Accumulator): instead of a row-at-a-time accumulator
contract, a scalar UDF is a jax-traceable array function (vectorized over the
whole capacity-padded column), and an aggregate UDF is a *commutative monoid*
spec — `state` (elementwise map), `combine` (associative merge), `identity`,
`finalize`.  The monoid shape is what the hardware wants: one segmented
associative scan evaluates any UDAF on-chip, and the same combine doubles as
the Partial/Final merge for distributed execution (no separate
`merge_batch` contract needed).

Registries are per-SessionContext, threaded to the typing/eval layers via a
context variable that the session's plan/execute entry points activate
(the reference's FunctionRegistry lookup, expr/src/registry.rs:30).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..common import types as T
from ..common.errors import PlanError


@dataclasses.dataclass(frozen=True)
class ScalarUDF:
    """Vectorized scalar function.

    fn receives one jax array per argument (decimal columns are descaled to
    float64; date32 passed as int32 days; bool as bool) and returns either a
    single array or an (array, validity) pair. When only an array is
    returned, NULLs propagate: output validity = AND of input validities."""

    name: str
    fn: Callable[..., Any]
    return_type: T.DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class AggregateUDF:
    """Aggregate function as a commutative monoid.

    state(x, ...)  -> pytree of per-row arrays (the mapped contribution)
    combine(a, b)  -> pytree (associative, commutative merge of two states)
    identity       -> pytree of scalars (the monoid identity, used for
                      masked/padded rows)
    finalize(s)    -> array (per-group state pytree -> result values)

    NULL argument rows are skipped (replaced by identity); a group with no
    valid rows yields NULL."""

    name: str
    state: Callable[..., Any]
    combine: Callable[[Any, Any], Any]
    identity: Any
    finalize: Callable[[Any], Any]
    return_type: T.DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class WindowUDF:
    """Window function over the default frame, built from the same monoid
    spec evaluated as a running segmented scan (reference: udwf.rs)."""

    name: str
    state: Callable[..., Any]
    combine: Callable[[Any, Any], Any]
    identity: Any
    finalize: Callable[[Any], Any]
    return_type: T.DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class TableUDF:
    """Table function: host callable over literal arguments returning rows
    (a dict of columns or a Table), used in FROM position (reference:
    TableFunctionImpl, catalog/src/table.rs + functions-table/src/
    generate_series.rs)."""

    name: str
    fn: Callable[..., Any]


class FunctionRegistry:
    """Per-session function registry (reference: expr/src/registry.rs:30)."""

    def __init__(self) -> None:
        self.scalars: Dict[str, ScalarUDF] = {}
        self.aggregates: Dict[str, AggregateUDF] = {}
        self.windows: Dict[str, WindowUDF] = {}
        self.tables: Dict[str, TableUDF] = {}
        self.spark = False  # Spark-semantics function set enabled

    def register_scalar(self, udf: ScalarUDF) -> None:
        self.scalars[udf.name.lower()] = udf

    def register_aggregate(self, udaf: AggregateUDF) -> None:
        self.aggregates[udaf.name.lower()] = udaf

    def register_window(self, udwf: WindowUDF) -> None:
        self.windows[udwf.name.lower()] = udwf

    def scalar(self, name: str) -> Optional[ScalarUDF]:
        return self.scalars.get(name.lower())

    def aggregate(self, name: str) -> Optional[AggregateUDF]:
        return self.aggregates.get(name.lower())

    def window(self, name: str) -> Optional[WindowUDF]:
        return self.windows.get(name.lower())

    def register_table_function(self, udtf: TableUDF) -> None:
        self.tables[udtf.name.lower()] = udtf

    def table(self, name: str) -> Optional[TableUDF]:
        return self.tables.get(name.lower())


_EMPTY = FunctionRegistry()
_ACTIVE: contextvars.ContextVar[FunctionRegistry] = contextvars.ContextVar(
    "datafusion_tpu_function_registry", default=_EMPTY)


def active_registry() -> FunctionRegistry:
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(registry: FunctionRegistry):
    token = _ACTIVE.set(registry)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def with_registry(method):
    """Decorator for SessionContext/DataFrame entry points: activates the
    session's registry for the duration of planning/execution so typing and
    kernel dispatch can resolve UDF names."""
    import functools

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        reg = getattr(self, "functions", None) or getattr(
            getattr(self, "_ctx", None), "functions", None)
        if reg is None:
            return method(self, *args, **kwargs)
        with activate(reg):
            return method(self, *args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# evaluation (not ported yet: UDFs would receive torch tensors)
# ---------------------------------------------------------------------------

_NOT_PORTED = ("user-defined function evaluation is not ported to "
               "datafusion_tpu_torch yet (ROADMAP queue 1, item 9c 'Spark "
               "functions, UDFs, HyperLogLog')")


def udf_input_array(col):
    raise NotImplementedError(_NOT_PORTED)


def udf_output_column(out, validity, return_type: T.DataType):
    raise NotImplementedError(_NOT_PORTED)


def make_async_scalar(name: str, fn, return_type: T.DataType,
                      nullable: bool = True) -> ScalarUDF:
    raise NotImplementedError(_NOT_PORTED)


def eval_scalar_udf(udf: ScalarUDF, args) -> Any:
    raise NotImplementedError(_NOT_PORTED)


def segmented_monoid_reduce(spec, x, mask, is_start, ends):
    raise NotImplementedError(_NOT_PORTED)


def running_monoid_scan(spec, x, mask, seg_start, peer_end):
    raise NotImplementedError(_NOT_PORTED)
