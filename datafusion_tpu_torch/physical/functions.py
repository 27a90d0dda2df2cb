"""Scalar functions: typing and device evaluation.

Port of the h2o.ai groupby subset of datafusion_tpu/physical/functions.py:
`power` / `pow` (h2o q9's `power(corr(v1, v2), 2)`). Every other scalar
function raises NotImplementedError naming its ROADMAP item, at typing
(planning) time.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..common import types as T
from ..common.schema import Schema
from ..data.device import DeviceColumn
from ..expr import nodes as E
from .expr_compiler import _combine_validity, _not_ported, _to_float

_PORTED = frozenset({"power", "pow"})


def builtin_function_names() -> set:
    """Every scalar-function name the port evaluates."""
    return set(_PORTED)


def scalar_function_type(e: E.ScalarFunction, schema: Schema) -> Tuple[T.DataType, bool]:
    from ..expr.typing import infer

    if e.fname not in _PORTED:
        raise _not_ported(f"scalar function {e.fname!r}")
    argt = [infer(a, schema) for a in e.args]
    return T.FLOAT64, any(n for _, n in argt)


def eval_scalar_function(fname: str, args: List[DeviceColumn]) -> DeviceColumn:
    if fname in ("power", "pow"):
        return DeviceColumn(torch.pow(_to_float(args[0]), _to_float(args[1])),
                            _combine_validity(*(a.validity for a in args)),
                            T.FLOAT64)
    raise _not_ported(f"scalar function {fname!r}")
