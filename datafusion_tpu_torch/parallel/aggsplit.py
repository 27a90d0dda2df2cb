"""Partial/Final aggregation split: per-group state columns.

Port of datafusion_tpu/parallel/aggsplit.py (the reference's
AggregateMode::{Partial,Final,FinalPartitioned,PartialReduce},
physical-plan/src/aggregates/mod.rs:282-357, and the GroupsAccumulator state
contract, update_batch / state / merge_batch / evaluate, expr-common/src/
groups_accumulator.rs:126-245). Each decomposable aggregate is rewritten into
per-group STATE columns computed on each part of the input (Partial), merged
across parts (Final), then finalized into the output column.

Two kinds of parts:
  * scan chunks (the time axis): physical/chunked.py merges the states of
    one chunk after another;
  * the shards of a mesh (parallel/engine.py), by the group keys' shape:
    dense small-domain keys keep their states at fixed group positions on
    every shard, merged by psum / pmin / pmax (`dense_partial_final`, the
    PartialReduce tree reduction, no exchange); arbitrary keys exchange the
    per-shard sorted states by group-key hash and reduce them again
    (`sorted_partial_final`: Partial -> RepartitionExec::Hash -> Final).

A part's dense states take the dense aggregation kernel
(ops/dense_agg.dense_groupby_sums) for every exact integer sum and count the
resident dense aggregate would give it (`dense_states`), so a distributed
dense aggregate launches it once per shard. The reference's distributed
dense partial uses segment sums; both are exact.

Non-decomposable aggregates (DISTINCT, order statistics) fall back to a row
exchange and a single-phase local aggregation in parallel/engine.py.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..common import types as T
from ..data.device import DeviceColumn, DeviceRelation
from ..ops import dense_agg as DA
from ..ops import groupby as G
from ..ops import kernels as K
from . import distributed as D

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


# ---------------------------------------------------------------------------
# dense states of one part through the kernel
# ---------------------------------------------------------------------------

def kernel_slots(p, rel, specs, afns, arg_cols, sp: StatePlan):
    """(state index -> ("count", None) | ("sum", pair index), factor pairs):
    the states the dense aggregation kernel computes, chosen as the resident
    dense aggregate chooses its kernel aggregates (AggregateExec.
    _dense_transform): unfiltered, non-DISTINCT counts over non-NULL
    arguments, and sums and averages whose argument factors into
    int32-bounded columns. A sum's or average's count state is the group
    count then (its argument has no NULLs). `afns` are the aggregate
    functions of `specs`, in order."""
    slots, pairs = {}, []
    for spec, afn, fin in zip(specs, afns, sp.finals):
        if spec.filter is not None or spec.distinct:
            continue
        if spec.fname in ("count", "count_star"):
            if spec.arg is None or arg_cols[spec.arg].validity is None:
                slots[fin.slots[0]] = ("count", None)
            continue
        if spec.fname in ("sum", "avg") and afn.args:
            fac = p._i32_factors(afn.args[0], rel)
            if fac is not None:
                slots[fin.slots[0]] = ("sum", len(pairs))
                slots[fin.slots[1]] = ("count", None)
                pairs.append((p._kernel_factor(fac[0]),
                              None if fac[1] is None
                              else p._kernel_factor(fac[1])))
    return slots, pairs


def dense_states(p, rel, specs, afns, arg_cols, filter_cols, sp: StatePlan,
                 seg, ngroups: int, kernel: bool = True):
    """(the partial state columns of `sp` at the dense group ids `seg`, the
    live-row count per group). With `kernel`, the states kernel_slots
    chooses come from dense_groupby_sums (at most MAX_PAIRS pairs a launch,
    as in the resident path), the rest from ops/groupby._reduce_one."""
    slots, pairs = (kernel_slots(p, rel, specs, afns, arg_cols, sp) if kernel
                    else ({}, []))
    if slots:
        groups = [pairs[i:i + DA.MAX_PAIRS]
                  for i in range(0, len(pairs), DA.MAX_PAIRS)] or [[]]
        parts = [DA.dense_groupby_sums(seg, rel.sel, g, ngroups) for g in groups]
        group_count = parts[0][1]
        sums = parts[0][0] if len(parts) == 1 else torch.cat([q[0] for q in parts], 1)
    else:
        group_count = K.segment_count(seg, rel.sel, ngroups)
    is_start = torch.zeros(rel.capacity, dtype=torch.bool, device=rel.device)
    ones = torch.ones(ngroups, dtype=torch.bool, device=rel.device)
    states = []
    for si, sspec in enumerate(sp.state_specs):
        hit = slots.get(si)
        if hit is None:
            states.append(G._reduce_one(
                sspec, sp.state_args, filter_cols, rel.sel, seg, is_start,
                None, ngroups, group_count, ones))
        elif hit[0] == "count":
            states.append(DeviceColumn(group_count, None, T.INT64))
        else:
            # the exact int64 sum; a float state (an integer average) stays
            # exact too until finalize divides it
            states.append(DeviceColumn(sums[:, hit[1]], None, sspec.out_dtype))
    return states, group_count


# ---------------------------------------------------------------------------
# the two cross-device merges (parallel/engine.py), over per-shard lists
# ---------------------------------------------------------------------------

def _hll_split(specs, options):
    """(positions of the HLL approx_distinct specs, the other specs) when
    the split applies, else None: the sketch needs the option, and every
    other aggregate must be decomposable."""
    hll_pos = [i for i, s in enumerate(specs)
               if s.fname == "approx_distinct" and not s.distinct
               and s.arg is not None]
    rest = [s for i, s in enumerate(specs) if i not in hll_pos]
    if hll_pos and not bool((options or {}).get("execution.approx_distinct_hll",
                                                 False)):
        return None
    if not decomposable(rest):
        return None
    return hll_pos, rest


def _with_estimates(out_aggs, hll_pos, ests, nspecs):
    """The finalized aggregates with the HLL estimates at their positions."""
    if not hll_pos:
        return list(out_aggs)
    full, it = [], iter(out_aggs)
    for i in range(nspecs):
        full.append(ests[i] if i in ests else next(it))
    return full


def _hll_mask(rel_sel, spec, col, filter_cols):
    mask = rel_sel & col.valid()
    if spec.filter is not None:
        mask = mask & filter_cols[spec.filter]
    return mask


def dense_partial_final(p, rels: Sequence[DeviceRelation], mesh: "D.Mesh", sizes,
                        ngroups: int, options=None) -> Optional[List[DeviceRelation]]:
    """Small-domain keys: each shard's dense partial states, merged over the
    mesh by psum / pmin / pmax (PartialReduce); approx_distinct joins as a
    HyperLogLog register plane merged by pmax when
    execution.approx_distinct_hll is on (reference: approx_distinct.rs
    merge_batch). The merged groups are the same on every shard, so shard i
    owns the groups with id % n == i (each group appears once in the
    shard-major result). Returns the per-shard relations, or None when an
    aggregate does not decompose."""
    from ..ops import hll

    n = mesh.n
    afns = p._agg_fns()
    per_shard = []
    for rel in rels:
        group_cols, arg_cols, filter_cols, specs = p._prepare(rel)
        split = _hll_split(specs, options)
        if split is None:
            return None
        hll_pos, rest = split
        if hll_pos and ngroups * hll.M * 4 > (1 << 28):  # register-plane budget
            return None
        # spec.arg indexes into the whole arg_cols list: pass it unfiltered
        sp = build_state_plan(rest, arg_cols)
        if "bitop" in sp.merge_kinds:
            return None  # no bitwise mesh reduction: the row exchange takes it
        seg, strides = p.dense_seg(group_cols, rel.sel, sizes, ngroups)
        states, count = dense_states(
            p, rel, rest, [a for i, a in enumerate(afns) if i not in hll_pos],
            arg_cols, filter_cols, sp, seg, ngroups)
        planes = [hll.build_registers(hll.hashes_for_column(arg_cols[specs[i].arg])[0],
                                      seg, _hll_mask(rel.sel, specs[i],
                                                     arg_cols[specs[i].arg],
                                                     filter_cols), ngroups)
                  for i in hll_pos]
        per_shard.append((group_cols, strides, sp, states, count, planes, specs,
                          hll_pos))
    reduce = {"sum": D.psum, "min": D.pmin, "max": D.pmax}
    merged = []
    for k, kind in enumerate(per_shard[0][2].merge_kinds):
        datas = [ps[3][k].data for ps in per_shard]
        as_bool = datas[0].dtype is torch.bool
        if as_bool:
            datas = [d.to(torch.int32) for d in datas]
        merged.append(reduce[kind](datas, mesh))
    total = D.psum([ps[4] for ps in per_shard], mesh)
    regs = [D.pmax([ps[5][j] for ps in per_shard], mesh)
            for j in range(len(per_shard[0][7]))]

    def finish(i):
        group_cols, strides, sp, states, _, _, specs, hll_pos = per_shard[i]
        cols = []
        for k, st in enumerate(states):
            data = merged[k][i]
            if st.data.dtype is torch.bool:
                data = data.to(torch.bool)
            cols.append(DeviceColumn(data, None, st.dtype, st.dictionary))
        out_sel = total[i] > 0
        out_keys = p.dense_keys(group_cols, sizes, strides, ngroups)
        ests = {pos: DeviceColumn(hll.estimate(r[i]), None, T.INT64)
                for pos, r in zip(hll_pos, regs)}
        out_aggs = _with_estimates(finalize(sp, cols, out_sel), hll_pos, ests,
                                   len(specs))
        cols = [p._coerce_out(c, f)
                for c, f in zip(out_keys + out_aggs, p.schema.fields)]
        return cols, out_sel

    # once per device: the merged groups are replicated values
    done = D.per_device(mesh, finish, list(range(n)))
    out = []
    for i, (cols, out_sel) in enumerate(done):
        gid = torch.arange(ngroups, dtype=torch.int64, device=out_sel.device)
        out.append(DeviceRelation(p.schema, tuple(cols), out_sel & (gid % n == i)))
    return out


def sorted_partial_final(p, rels: Sequence[DeviceRelation], mesh: "D.Mesh",
                         options=None) -> Optional[List[DeviceRelation]]:
    """Arbitrary keys: each shard's sorted partial states, exchanged by
    group-key hash (slot_cap = the discovered group capacity: a shard holds
    at most that many partial groups, so nothing overflows), then merged per
    group and finalized. HLL register planes ride the exchange and the final
    sort as 2-D payload rows and union by a per-group scatter-max. Returns
    the per-shard relations (each group on one shard), or None when an
    aggregate does not decompose or the capacity was not discovered."""
    from ..ops import hll

    cap = getattr(p, "_last_cap", None)
    if cap is None:
        return None
    partial = []
    for rel in rels:
        group_cols, arg_cols, filter_cols, specs = p._prepare(rel)
        split = _hll_split(specs, options)
        if split is None:
            return None
        hll_pos, rest = split
        if hll_pos and cap * hll.M * 4 > (1 << 28):  # register-plane budget
            return None
        sp = build_state_plan(rest, arg_cols)
        # Partial: the HLL arguments ride the same sort, so that the
        # register planes reuse this phase's segments
        extra = [arg_cols[specs[i].arg] for i in hll_pos]
        sg, sa, sf, ssel, seg, is_start, _, _ = G.phase_sort(
            group_cols, list(sp.state_args) + extra, filter_cols, rel.sel, None)
        sorted_extra = sa[len(sp.state_args):]
        sa = sa[:len(sp.state_args)]
        out_keys, out_states, out_sel = G.phase_reduce(
            sg, sa, sf, ssel, seg, is_start, None, sp.state_specs, cap)
        planes = [hll.build_registers(hll.hashes_for_column(col)[0], seg,
                                      _hll_mask(ssel, specs[i], col, sf), cap)
                  for i, col in zip(hll_pos, sorted_extra)]
        hs = []
        for k in out_keys:
            hs.append(k.data)
            if k.validity is not None:
                hs.append(k.validity)
        partial.append((list(out_keys), list(out_states), out_sel,
                        K.hash64(hs), planes, sp, specs, hll_pos))
    n_leaves = len(D.column_tensors(partial[0][0] + partial[0][1]))
    leaves = [D.column_tensors(ps[0] + ps[1]) + ps[4] for ps in partial]
    outs, new_sel, _ = D.exchange_by_key(
        [[lv[j] for lv in leaves] for j in range(len(leaves[0]))],
        [ps[3] for ps in partial], [ps[2] for ps in partial], mesh, slot_cap=cap)

    result = []
    for i, (keys, states, _, _, _, sp, specs, hll_pos) in enumerate(partial):
        got = [col[i] for col in outs]
        received = D.columns_like(keys + states, got[:n_leaves], cover_zero=True)
        rkeys, rstates = received[:len(keys)], received[len(keys):]
        plane_cols = [DeviceColumn(pl, None, T.list_of(T.INT32))
                      for pl in got[n_leaves:]]
        # Final: merge the received states per group
        sg2, sa2, sf2, ssel2, seg2, is_start2, _, _ = G.phase_sort(
            rkeys, rstates + plane_cols, [], new_sel[i], None)
        sorted_planes = sa2[len(rstates):]
        sa2 = sa2[:len(rstates)]
        mkeys, mstates, msel = G.phase_reduce(
            sg2, sa2, sf2, ssel2, seg2, is_start2, None, sp.merge_specs, cap)
        ests = {}
        if hll_pos:
            g = torch.where(ssel2 & (seg2 < cap), seg2.to(torch.int64), cap)
            for pos, pc in zip(hll_pos, sorted_planes):
                regs = torch.zeros((cap + 1, hll.M), dtype=torch.int32,
                                   device=pc.data.device)
                regs.scatter_reduce_(0, g[:, None].expand(-1, hll.M), pc.data, "amax")
                ests[pos] = DeviceColumn(hll.estimate(regs[:cap]), None, T.INT64)
        out_aggs = _with_estimates(finalize(sp, mstates, msel), hll_pos, ests,
                                   len(specs))
        cols = [p._coerce_out(c, f)
                for c, f in zip(list(mkeys) + out_aggs, p.schema.fields)]
        result.append(DeviceRelation(p.schema, tuple(cols), msel))
    return result
