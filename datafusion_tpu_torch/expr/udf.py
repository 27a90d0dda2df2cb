# Port of datafusion_tpu/expr/udf.py: the registries as there; a UDF receives and returns torch tensors.
"""User-defined functions: scalar, aggregate, and window registration.

TPU-native redesign of the reference's UDF traits (datafusion/expr/src/
udf.rs:537 ScalarUDF, udaf.rs:1 AggregateUDF + expr-common/src/
accumulator.rs:51 Accumulator): instead of a row-at-a-time accumulator
contract, a scalar UDF is a function of torch tensors (vectorized over the
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

    fn receives one torch tensor per argument (decimal columns are descaled to
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
# evaluation helpers (called from physical layers under an active registry)
# ---------------------------------------------------------------------------


def udf_input_array(col):
    """The tensor handed to a UDF for a DeviceColumn: decimals are descaled
    to float64 so user code sees values, not fixed-point words; date32
    arrives as int32 days."""
    import torch

    if col.dtype.is_string:
        raise PlanError(
            "string arguments to UDFs are not supported (dictionary-encoded); "
            "operate on numeric/date/bool columns")
    if col.dtype.is_decimal:
        return col.data.to(torch.float64) / (10.0 ** col.dtype.scale)
    return col.data


def udf_output_column(out, validity, return_type: T.DataType):
    """Coerce a UDF's raw output tensor to a DeviceColumn of return_type
    (decimals re-scaled to the fixed-point representation)."""
    import torch

    from ..data.device import DeviceColumn, torch_dtype

    if isinstance(out, tuple) and len(out) == 2:
        out, validity = out[0], out[1]
    if return_type.is_decimal:
        data = torch.round(out * (10.0 ** return_type.scale)).to(torch.int64)
    else:
        data = out.to(torch_dtype(return_type))
    return DeviceColumn(data, validity, return_type)


class HostCall:
    """The body of a scalar UDF that runs on the host: each call copies its
    arguments to numpy, runs `fn` (a coroutine function to completion with
    asyncio.run) and uploads the result to the arguments' device. A plan
    holding one runs eagerly, never inside a captured CUDA graph
    (physical/fused.py)."""

    def __init__(self, fn, np_dtype):
        import inspect

        self.fn = fn
        self.np_dtype = np_dtype
        self.is_coro = inspect.iscoroutinefunction(fn)

    def __call__(self, *args):
        import numpy as np
        import torch

        arrays = [a.cpu().numpy() for a in args]
        if self.is_coro:
            import asyncio

            out = asyncio.run(self.fn(*arrays))
        else:
            out = self.fn(*arrays)
        out = np.array(out, dtype=self.np_dtype)  # a writable copy
        return torch.from_numpy(out).to(args[0].device)


def make_async_scalar(name: str, fn, return_type: T.DataType,
                      nullable: bool = True) -> ScalarUDF:
    """Wrap a host (optionally async) batch function as a scalar UDF
    (reference capability: AsyncFuncExec, physical-plan/src/async_func.rs +
    async ScalarUDFImpl). The function receives one numpy array per argument
    for the WHOLE batch and returns an array; coroutine functions are run to
    completion per batch (fan out per-row work inside with asyncio.gather).
    The result is uploaded to the session's device.

    Note: batches are CAPACITY-padded — the function also sees dead-row
    padding values (their results are discarded by the selection mask);
    dedupe or cap remote fan-out inside the function if that matters."""
    return ScalarUDF(name, HostCall(fn, return_type.np_dtype()), return_type,
                     nullable)


def is_host_call(udf: ScalarUDF) -> bool:
    return isinstance(udf.fn, HostCall)


def eval_scalar_udf(udf: ScalarUDF, args) -> Any:
    """Evaluate a scalar UDF over DeviceColumns -> DeviceColumn."""
    arrays = [udf_input_array(c) for c in args]
    validity = None
    for c in args:
        if c.validity is not None:
            validity = c.validity if validity is None else (validity & c.validity)
    out = udf.fn(*arrays)
    return udf_output_column(out, validity, udf.return_type)


# ---- pytrees of tensors: a tensor or scalar, or a tuple, list or dict of
# pytrees (dict keys in sorted order, None an empty subtree) ---------------

def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves, structure) of a pytree. Module-level recursion: a recursive
    closure would be a reference cycle holding the leaves (device tensors)
    until the garbage collector happens to run."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def _flatten_into(t, leaves: list):
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return (type(t), tuple(_flatten_into(x, leaves) for x in t))
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, tuple(keys), tuple(_flatten_into(t[k], leaves) for k in keys))
    leaves.append(t)
    return "*"


def tree_unflatten(structure, leaves: Sequence) -> Any:
    """The pytree of `structure` holding `leaves` in order."""
    return _build(structure, iter(leaves))


def _build(s, it):
    if s is None:
        return None
    if s == "*":
        return next(it)
    if s[0] is dict:
        return {k: _build(c, it) for k, c in zip(s[1], s[2])}
    return s[0](_build(c, it) for c in s[1])


def _identity_rows(spec, x, mask) -> Tuple[list, Any]:
    """The state leaves of spec over x, masked rows holding the identity
    (a Python scalar of the leaf's kind, so no host tensor is copied to the
    device)."""
    import torch

    leaves, structure = tree_flatten(spec.state(x))
    id_leaves, _ = tree_flatten(spec.identity)
    if len(id_leaves) != len(leaves):
        raise PlanError(
            f"UDAF {spec.name!r}: identity structure does not match state")
    out = []
    for leaf, ident in zip(leaves, id_leaves):
        kind = bool if leaf.dtype is torch.bool else \
            float if leaf.dtype.is_floating_point else int
        out.append(torch.where(mask, leaf, kind(ident)))
    return out, structure


def _monoid_scan(spec, flags, leaves: list, structure) -> list:
    """The segment-resetting inclusive scan of spec.combine over the state
    leaves (ops/kernels.segmented_scan)."""
    from ..ops.kernels import segmented_scan

    def combine(a, b):
        merged = spec.combine(tree_unflatten(structure, a), tree_unflatten(structure, b))
        return tree_flatten(merged)[0]

    return segmented_scan(combine, flags, leaves)


def _scan_at(spec, x, mask, flags, idx):
    """spec's states of x (the identity on masked rows), scanned with
    restarts at `flags`, read at `idx` and finalized."""
    leaves, structure = _identity_rows(spec, x, mask)
    res = _monoid_scan(spec, flags, leaves, structure)
    idx = idx.long()
    return spec.finalize(tree_unflatten(structure, [r[idx] for r in res]))


def segmented_monoid_reduce(spec, x, mask, is_start, ends):
    """Evaluate a monoid UDAF over sorted segments: map rows to states,
    substitute identity on masked rows, run ONE segment-resetting associative
    scan, read at group end positions, finalize. O(n log n) scan work."""
    return _scan_at(spec, x, mask, is_start, ends)


def running_monoid_scan(spec, x, mask, seg_start, peer_end):
    """Window form: running segmented scan (partition-resetting), read at the
    current row's peer-run end (default RANGE UNBOUNDED..CURRENT ROW)."""
    return _scan_at(spec, x, mask, seg_start, peer_end)
