"""Partial/Final aggregation split: per-group state columns.

Port of the time-axis half of datafusion_tpu/parallel/aggsplit.py (the
reference's AggregateMode::{Partial,Final}, physical-plan/src/aggregates/
mod.rs:282-357, and the GroupsAccumulator state contract, update_batch /
state / merge_batch / evaluate, expr-common/src/groups_accumulator.rs:
126-245). Each decomposable aggregate is rewritten into per-group STATE
columns computed on each part of the input (Partial), merged across parts
(Final), then finalized into the output column. The chunked executor
(physical/chunked.py) merges them across scan chunks.

The cross-device merges (`dense_partial_final`, `sorted_partial_final`)
need a mesh and wait for the distributed engine: ROADMAP queue 1, item 11.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..common import types as T
from ..data.device import DeviceColumn
from ..ops import groupby as G

_DECOMPOSABLE = frozenset({
    "count", "count_star", "sum", "avg", "min", "max",
    "var", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop",
    "bool_and", "bool_or", "corr", "covar", "covar_pop", "covar_samp",
    "bit_and", "bit_or", "bit_xor",
    "regr_slope", "regr_intercept", "regr_count", "regr_r2", "regr_avgx",
    "regr_avgy", "regr_sxx", "regr_syy", "regr_sxy",
})


def decomposable(specs: Sequence[G.AggSpec]) -> bool:
    return all((not s.distinct) and s.order_arg is None
               and s.fname in _DECOMPOSABLE for s in specs)


@dataclasses.dataclass
class _Final:
    kind: str            # count/sum/avg/minmax/var/corr/regr/bool
    slots: List[int]     # indices into the merged state column list
    spec: G.AggSpec
    scale: float = 1.0   # decimal scale divisor for avg
    bool_out: bool = False


@dataclasses.dataclass
class StatePlan:
    state_args: List[DeviceColumn]   # partial-phase aggregate arguments
    state_specs: List[G.AggSpec]     # partial-phase aggregates (one per state)
    merge_specs: List[G.AggSpec]     # final-phase merge over the state cols
    merge_kinds: List[str]           # 'sum' | 'min' | 'max' | 'bitop'
    finals: List[_Final]


def _f64_scaled(col: DeviceColumn, validity=None) -> DeviceColumn:
    x = col.data.to(torch.float64)
    if col.dtype.is_decimal:
        x = x / (10.0 ** col.dtype.scale)
    return DeviceColumn(x, validity if validity is not None else col.validity,
                        T.FLOAT64)


def _both_valid(x: DeviceColumn, y: DeviceColumn):
    if x.validity is None and y.validity is None:
        return None
    return x.valid() & y.valid()


def _moment_states(add_state, x_col, y_col, filt) -> List[int]:
    """The (x, y, xy, xx, yy, count) sums of a two-argument statistic over
    the pairs where both arguments are non-NULL."""
    both = _both_valid(x_col, y_col)
    xf = _f64_scaled(x_col, both)
    yf = _f64_scaled(y_col, both)
    prods = [xf, yf,
             DeviceColumn(xf.data * yf.data, both, T.FLOAT64),
             DeviceColumn(xf.data * xf.data, both, T.FLOAT64),
             DeviceColumn(yf.data * yf.data, both, T.FLOAT64)]
    slots = [add_state("sum", pc, T.FLOAT64, filt, "sum") for pc in prods]
    slots.append(add_state("count", xf, T.INT64, filt, "sum"))
    return slots


def build_state_plan(specs: Sequence[G.AggSpec],
                     arg_cols: Sequence[DeviceColumn]) -> StatePlan:
    sp = StatePlan([], [], [], [], [])

    def add_state(fname: str, col: Optional[DeviceColumn], out_dtype, filt,
                  merge: str, arg_dtype=None) -> int:
        arg_i = None
        if col is not None:
            arg_i = len(sp.state_args)
            sp.state_args.append(col)
            arg_dtype = arg_dtype or col.dtype
        sp.state_specs.append(G.AggSpec(fname, arg_i, False, out_dtype,
                                        arg_dtype, filt))
        state_i = len(sp.merge_specs)
        sp.merge_specs.append(G.AggSpec(merge, state_i, False, out_dtype,
                                        out_dtype, None))
        sp.merge_kinds.append("min" if merge in ("min", "bool_and")
                              else "max" if merge in ("max", "bool_or")
                              else "bitop" if merge.startswith("bit_")
                              else "sum")
        return state_i

    for s in specs:
        f = s.fname
        arg = arg_cols[s.arg] if s.arg is not None else None
        if f == "count_star":
            i = add_state("count_star", None, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("count", [i], s))
        elif f == "count":
            i = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("count", [i], s))
        elif f == "sum":
            if s.out_dtype.is_decimal or (arg.dtype.is_integer
                                          and not s.out_dtype.is_float):
                sdt = s.out_dtype if s.out_dtype.is_decimal else T.INT64
            else:
                sdt = T.FLOAT64
            i = add_state("sum", arg, sdt, s.filter, "sum")
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("sum", [i, c], s))
        elif f == "avg":
            if arg.dtype.is_decimal:
                # exact int64 scaled partial sums; divide once at the end
                i = add_state("sum", arg, arg.dtype, s.filter, "sum")
                scale = 10.0 ** arg.dtype.scale
            else:
                i = add_state("sum", _f64_scaled(arg), T.FLOAT64, s.filter, "sum")
                scale = 1.0
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("avg", [i, c], s, scale=scale))
        elif f in ("min", "max"):
            i = add_state(f, arg, s.out_dtype, s.filter, f)
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("minmax", [i, c], s))
        elif f in ("bool_and", "bool_or"):
            i = add_state(f, arg, T.BOOL, s.filter, f)
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("bool", [i, c], s, bool_out=True))
        elif f in ("var", "var_samp", "var_pop", "stddev", "stddev_samp",
                   "stddev_pop"):
            x = _f64_scaled(arg)
            x2 = DeviceColumn(x.data * x.data, x.validity, T.FLOAT64)
            i1 = add_state("sum", x, T.FLOAT64, s.filter, "sum")
            i2 = add_state("sum", x2, T.FLOAT64, s.filter, "sum")
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("var", [i1, i2, c], s))
        elif f in ("bit_and", "bit_or", "bit_xor"):
            i = add_state(f, arg, s.out_dtype, s.filter, f)
            c = add_state("count", arg, T.INT64, s.filter, "sum")
            sp.finals.append(_Final("minmax", [i, c], s))
        elif f.startswith("regr_"):
            # (y, x) with y the first argument; same slot layout as corr
            slots = _moment_states(add_state, arg_cols[s.arg + 1], arg,
                                   s.filter)
            sp.finals.append(_Final("regr", slots, s))
        elif f in ("corr", "covar", "covar_pop", "covar_samp"):
            slots = _moment_states(add_state, arg, arg_cols[s.arg + 1],
                                   s.filter)
            sp.finals.append(_Final("corr", slots, s))
        else:
            raise ValueError(f"not decomposable: {f}")
    return sp


def finalize(sp: StatePlan, merged: Sequence[DeviceColumn],
             out_sel: torch.Tensor) -> List[DeviceColumn]:
    out = []
    for fin in sp.finals:
        s = fin.spec
        if fin.kind == "count":
            out.append(DeviceColumn(merged[fin.slots[0]].data.to(torch.int64),
                                    None, T.INT64))
            continue
        cnt = merged[fin.slots[-1]].data
        nonempty = (cnt > 0) & out_sel
        if fin.kind in ("sum", "minmax", "bool"):
            v = merged[fin.slots[0]]
            data = v.data.to(torch.bool) if fin.bool_out else v.data
            out.append(DeviceColumn(data, nonempty, s.out_dtype, v.dictionary))
        elif fin.kind == "avg":
            ssum = merged[fin.slots[0]].data.to(torch.float64)
            cntf = torch.clamp(cnt, min=1).to(torch.float64)
            if s.out_dtype.is_decimal:
                # exact scaled-int partial sums -> one rounded division to
                # the output scale (as the single-device decimal avg)
                num = ssum * (10.0 ** s.out_dtype.scale) / fin.scale
                out.append(DeviceColumn(torch.trunc(num / cntf).to(torch.int64),
                                        nonempty, s.out_dtype))
            else:
                out.append(DeviceColumn((ssum / fin.scale) / cntf, nonempty,
                                        T.FLOAT64))
        elif fin.kind == "var":
            ssum = merged[fin.slots[0]].data
            s2 = merged[fin.slots[1]].data
            cn = cnt.to(torch.float64)
            pop = s.fname.endswith("_pop")
            denom = torch.clamp(cn if pop else cn - 1.0, min=1.0)
            var = torch.clamp((s2 - ssum * ssum / torch.clamp(cn, min=1.0)) / denom,
                              min=0.0)
            val = torch.sqrt(var) if s.fname.startswith("stddev") else var
            min_n = 1.0 if pop else 2.0
            out.append(DeviceColumn(val, (cn >= min_n) & out_sel, T.FLOAT64))
        elif fin.kind == "regr":
            out.append(_finalize_regr(s, fin, merged, cnt, nonempty))
        elif fin.kind == "corr":
            sx, sy, sxy, sxx, syy = (merged[i].data for i in fin.slots[:5])
            cn = torch.clamp(cnt.to(torch.float64), min=1.0)
            cov = sxy - sx * sy / cn
            if s.fname == "corr":
                vx = sxx - sx * sx / cn
                vy = syy - sy * sy / cn
                denom = torch.sqrt(torch.clamp(vx * vy, min=0.0))
                val = torch.where(denom > 0, cov / denom,
                                  torch.full_like(cov, float("nan")))
                out.append(DeviceColumn(val, (cnt >= 2) & out_sel, T.FLOAT64))
            else:
                pop = s.fname == "covar_pop"
                denom = cn if pop else torch.clamp(cnt.to(torch.float64) - 1.0,
                                                   min=1.0)
                min_n = 1 if pop else 2
                out.append(DeviceColumn(cov / denom, (cnt >= min_n) & out_sel,
                                        T.FLOAT64))
        else:
            raise ValueError(fin.kind)
    return out


def _finalize_regr(s, fin, merged, cnt, nonempty) -> DeviceColumn:
    sx, sy, sxy, sxx, syy = (merged[i].data for i in fin.slots[:5])
    if s.fname == "regr_count":
        return DeviceColumn(cnt.to(torch.int64), None, T.INT64)
    cn = torch.clamp(cnt.to(torch.float64), min=1.0)
    Sxx = sxx - sx * sx / cn
    Syy = syy - sy * sy / cn
    Sxy = sxy - sx * sy / cn
    simple = {"regr_avgx": sx / cn, "regr_avgy": sy / cn, "regr_sxx": Sxx,
              "regr_syy": Syy, "regr_sxy": Sxy}
    if s.fname in simple:
        return DeviceColumn(simple[s.fname], nonempty, T.FLOAT64)
    ok = nonempty & (Sxx > 0)
    slope = Sxy / torch.where(Sxx > 0, Sxx, torch.ones_like(Sxx))
    if s.fname == "regr_slope":
        return DeviceColumn(slope, ok, T.FLOAT64)
    if s.fname == "regr_intercept":
        return DeviceColumn(sy / cn - slope * sx / cn, ok, T.FLOAT64)
    # regr_r2
    both = (Sxx > 0) & (Syy > 0)
    r2 = torch.where(Syy > 0,
                     (Sxy * Sxy) / torch.where(both, Sxx * Syy, torch.ones_like(Sxx)),
                     torch.ones_like(Sxx))
    return DeviceColumn(r2, ok, T.FLOAT64)
