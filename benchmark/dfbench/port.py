"""The one module of the benchmark that reaches the program under test,
datafusion_tpu_torch, and only through what a user of it calls: a
SessionContext, register_table of in-memory tables, sql(), a DataFrame's
physical_plan() and collect(), and the build of the hand-written kernels.
Besides, the traced run wraps two functions from outside to see where the
host is: the copy of a result to the host (`data.device.to_host`, as
DataFrame.collect calls it) and the dense kernel's entry
(`ops.dense_agg.dense_groupby_sums`), whose arguments give the launch's
shapes."""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import numpy as np

from dfbench.columns import Col


def session(device=None):
    """A new session; device None is the CUDA card (raises without one)."""
    from datafusion_tpu_torch import SessionContext

    return SessionContext(device=device)


def build_kernels() -> None:
    """Compile the program's CUDA sources (nothing where they are built)."""
    from datafusion_tpu_torch.ops import cuda_build

    cuda_build.build_all(sorted(p.name for p in cuda_build.CSRC.glob("*.cu")))


def port_table(cols: Dict[str, Col]):
    """The program's host Table of plain columns."""
    from datafusion_tpu_torch import Field, Schema, Table
    from datafusion_tpu_torch import types as T
    from datafusion_tpu_torch.data.column import Dictionary, HostColumn

    fields, columns = [], []
    for name, c in cols.items():
        if c.kind == "string":
            dtype = T.STRING
            col = HostColumn(dtype, np.ascontiguousarray(c.data, dtype=np.int32), None,
                             Dictionary(c.dictionary))
        else:
            dtype = {"int32": T.INT32, "int64": T.INT64, "float64": T.FLOAT64,
                     "date32": T.DATE32}.get(c.kind) or T.decimal(c.precision, c.scale)
            col = HostColumn(dtype, np.ascontiguousarray(c.data, dtype=dtype.np_dtype()))
        fields.append(Field(name, dtype, nullable=False))
        columns.append(col)
    return Table(Schema(fields), columns)


def register(ctx, tables: Dict[str, Dict[str, Col]]) -> None:
    for name, cols in tables.items():
        ctx.register_table(name, port_table(cols))


@contextlib.contextmanager
def host_copy_spans(enter: Callable[[], None], leave: Callable[[], None]):
    """Calls enter() and leave() around every copy of a result to the host."""
    from datafusion_tpu_torch import context as C

    orig = C.to_host

    def wrapped(*args, **kwargs):
        enter()
        try:
            return orig(*args, **kwargs)
        finally:
            leave()

    C.to_host = wrapped
    try:
        yield
    finally:
        C.to_host = orig


@contextlib.contextmanager
def kernel_launches(calls: List[dict]):
    """Appends {n_extent, n_true, row_bytes, out_bytes} to `calls` for every
    call of the dense kernel's entry while active: the shapes the launch's
    least bytes are computed from (metrics/dense_groupby_sums_roofline.py).
    Reads the mask, so it synchronises: used in set-up only."""
    from datafusion_tpu_torch.ops import dense_agg as DA

    orig = DA.dense_groupby_sums

    def recording(seg, mask, pairs, G):
        live = mask & (seg >= 0) & (seg < int(G))
        idx = live.nonzero()
        n_true = int(idx.shape[0])
        n_extent = int(idx[-1, 0]) + 1 if n_true else 0
        factors, seen = 0, set()
        for a, b in pairs:
            for t in (a, b):
                if t is not None and t.data_ptr() not in seen:
                    seen.add(t.data_ptr())
                    factors += t.element_size()
        calls.append({"n_extent": n_extent, "n_true": n_true,
                      "mask_bytes": mask.element_size(),
                      "row_bytes": seg.element_size() + factors,
                      "out_bytes": int(G) * (len(pairs) + 1) * 8})
        return orig(seg, mask, pairs, G)

    DA.dense_groupby_sums = recording
    try:
        yield
    finally:
        DA.dense_groupby_sums = orig
