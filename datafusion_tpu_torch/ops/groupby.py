"""Sort-based grouped aggregation.

Port of datafusion_tpu/ops/groupby.py to eager torch ops. Rows are sorted by
the group keys; dense segment ids then drive flat per-group state vectors
(the GroupsAccumulator contract) through masked segment reductions.

Two phases with one host read between them, so the output capacity is a
power-of-two bucket of the group count:
  phase_sort   : sort rows by keys, compute segment ids + group count
  phase_reduce : segment reductions into a bucket_capacity(num_groups) output

Where the reference differs from this port, and why:
* group starts come from one scatter of the start rows' indices at their
  segment ids, not from a stable sort of ~is_start (same starts, no sort);
* segment min/max are `scatter_reduce_` over the segment ids, not a
  segmented associative scan (torch has none); bitwise aggregates keep the
  scan, as a log-step (Hillis-Steele) segmented scan;
* floating-point sums on the sorted path are per-segment reductions, not
  differences of one running prefix sum: a difference of prefix sums loses
  half an ulp of the running total per group (about 3e-8 at h2o's 1e7-row
  scale, far outside 1e-9 for one-row groups). Integer sums and counts keep
  the prefix differences, which are exact.
* array_agg, string_agg, approx_distinct and aggregate UDFs are not ported
  yet: ROADMAP queue 1, item 9.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..common import types as T
from ..common.errors import PlanError
from ..data.device import DeviceColumn, is_integer, torch_dtype
from . import kernels as K

_BREADTH_ITEM = "ROADMAP queue 1, item 9 'Function and nested-type breadth'"
# aggregates whose accumulators the port does not have yet
NOT_PORTED = frozenset({"array_agg", "string_agg", "approx_distinct"})


@dataclasses.dataclass
class AggSpec:
    fname: str  # count, count_star, sum, avg, min, max, var.., stddev.., first, last
    arg: Optional[int]  # index into agg arg column list (None for count(*))
    distinct: bool
    out_dtype: T.DataType
    arg_dtype: Optional[T.DataType] = None
    filter: Optional[int] = None  # index into filter mask list
    extra: Optional[float] = None  # percentile q etc.
    # agg(x ORDER BY y): index of the order expression in the arg column
    # list + direction (reference: params.order_by; single-key subset)
    order_arg: Optional[int] = None
    order_desc: bool = False
    # first_value(x IGNORE NULLS): skip null argument rows
    ignore_nulls: bool = False


_ORDER_SENSITIVE = frozenset({"median", "approx_median", "percentile_cont",
                              "approx_percentile_cont", "approx_distinct",
                              "array_agg", "string_agg"})

# aggregates the arithmetic dense-key path cannot evaluate (they need the
# sorted path's is_start/run structure)
DENSE_UNSUPPORTED = frozenset({"bit_and", "bit_or", "bit_xor", "nth_value"})


# aggregates whose result depends on the INPUT row order within each group:
# they must reduce over the keys-only (stable) sort, never a value-sorted
# bucket (reference: first/last/nth accumulators honor insertion order)
_INPUT_ORDER = frozenset({"first_value", "last_value", "any_value",
                          "nth_value"})


def not_ported_error(fname: str) -> NotImplementedError:
    what = ("aggregate UDF" if fname not in NOT_PORTED else "aggregate")
    return NotImplementedError(
        f"{what} {fname!r} is not ported to datafusion_tpu_torch yet "
        f"({_BREADTH_ITEM})")


def order_arg_of(spec: "AggSpec"):
    """The argument this spec needs rows value-sorted by (DISTINCT aggs and
    order-statistic aggs share the mechanism), or None. An explicit
    agg(x ORDER BY y) returns a (arg_index, descending) tuple so ASC and
    DESC buckets stay distinct."""
    if spec.order_arg is not None:
        return (spec.order_arg, spec.order_desc)
    if spec.fname in _INPUT_ORDER:
        return None
    if (spec.distinct or spec.fname in _ORDER_SENSITIVE) and spec.arg is not None:
        return spec.arg
    return None


def order_arg_buckets(specs: Sequence["AggSpec"]) -> List[Optional[int]]:
    """Ordered unique order-arg requirements across specs. Each DISTINCT or
    order-statistic argument gets its own sort pass; the group segmentation
    is identical across passes (determined by the group keys alone), so
    per-bucket reductions align index for index.

    When any spec needs INPUT order (first/last/nth_value) alongside value-
    sorted buckets, a keys-only None bucket leads so those specs never see a
    value-sorted row order."""
    buckets: List[Optional[int]] = []
    need_input_order = any(s.fname in _INPUT_ORDER and s.order_arg is None
                           for s in specs)
    for s in specs:
        b = order_arg_of(s)
        if b is not None and b not in buckets:
            buckets.append(b)
    if buckets and need_input_order:
        return [None] + buckets
    return buckets or [None]


def bucket_assignment(specs: Sequence["AggSpec"]) -> List[int]:
    """Per-spec index into order_arg_buckets(specs); order-insensitive
    aggregates ride bucket 0."""
    buckets = order_arg_buckets(specs)
    out = []
    for s in specs:
        b = order_arg_of(s)
        if b is not None:
            out.append(buckets.index(b))
        elif s.fname in _INPUT_ORDER and buckets[0] is not None:
            out.append(buckets.index(None))
        else:
            out.append(0)
    return out


def phase_sort(
    group_cols: Sequence[DeviceColumn],
    agg_args: Sequence[DeviceColumn],
    filters: Sequence[torch.Tensor],
    sel: torch.Tensor,
    distinct_arg,
):
    """Sort by group keys (plus the distinct / order argument, if any);
    return sorted state + segment structure + num_groups (a 0-d tensor, not
    read on the host here)."""
    keys = [(c.data, c.validity, False, False, c.sort_bounds())
            for c in group_cols]
    order_desc = False
    if isinstance(distinct_arg, tuple):  # explicit agg(... ORDER BY y [DESC])
        distinct_arg, order_desc = distinct_arg
    if distinct_arg is not None:
        da = agg_args[distinct_arg]
        keys.append((da.data, da.validity, order_desc, order_desc,
                     da.sort_bounds()))

    payload: List[torch.Tensor] = []
    layout = []  # (kind, idx, has_validity, narrowed)

    def _add(kind, i, c):
        # int64 columns whose bounds prove an int32 range ride the
        # permutation gather as one int32 lane, widened back after the sort
        narrow = (c.data.ndim == 1 and c.data.dtype is torch.int64
                  and c.fits_i32())
        payload.append(c.data.to(torch.int32) if narrow else c.data)
        if c.validity is not None:
            payload.append(c.validity)
        layout.append((kind, i, c.validity is not None, narrow))

    for i, c in enumerate(group_cols):
        _add("g", i, c)
    for i, c in enumerate(agg_args):
        _add("a", i, c)
    for i, f in enumerate(filters):
        payload.append(f)
        layout.append(("f", i, False, False))

    sorted_payload, ssel = K.sort_rows(keys, payload, sel)

    sg: List[DeviceColumn] = []
    sa: List[DeviceColumn] = []
    sf: List[torch.Tensor] = []
    it = iter(sorted_payload)
    for kind, i, hasv, narrow in layout:
        data = next(it)
        if narrow:
            data = data.to(torch.int64)
        validity = next(it) if hasv else None
        if kind == "g":
            c = group_cols[i]
            # permutation gathers keep the value multiset: bounds carry over
            sg.append(DeviceColumn(data, validity, c.dtype, c.dictionary,
                                   bounds=c.bounds))
        elif kind == "a":
            c = agg_args[i]
            sa.append(DeviceColumn(data, validity, c.dtype, c.dictionary,
                                   bounds=c.bounds))
        else:
            sf.append(data)

    seg, is_start, num_groups = K.segments_from_sorted_keys(
        [c.data for c in sg], [c.validity for c in sg], ssel)

    # distinct-run starts: first row of each (group, distinct-value) run
    distinct_start = None
    if distinct_arg is not None:
        da = sa[distinct_arg]
        _, distinct_start, _ = K.segments_from_sorted_keys(
            [c.data for c in sg] + [da.data],
            [c.validity for c in sg] + [da.validity], ssel)

    return sg, sa, sf, ssel, seg, is_start, distinct_start, num_groups


def phase_sort_multi(group_cols, agg_args, filters, sel, specs):
    """One phase_sort per order-arg bucket (see order_arg_buckets)."""
    return tuple(phase_sort(group_cols, agg_args, filters, sel, b)
                 for b in order_arg_buckets(specs))


def phase_reduce_multi(states, specs, num_segments):
    """Reduce each spec against its bucket's sorted state; group key columns
    and out_sel come from bucket 0 (group order is identical across buckets
    since it is determined by the group keys alone)."""
    assign = bucket_assignment(specs)
    out_aggs: List[Optional[DeviceColumn]] = [None] * len(specs)
    out_keys = out_sel = None
    for bi in range(len(states)):
        idxs = [i for i, a in enumerate(assign) if a == bi]
        if not idxs and bi > 0:
            continue
        sg, sa, sf, ssel, seg, is_start, distinct_start, _ = states[bi]
        k, a, osel = phase_reduce(sg, sa, sf, ssel, seg, is_start,
                                  distinct_start, [specs[i] for i in idxs],
                                  num_segments)
        if bi == 0:
            out_keys, out_sel = k, osel
        for j, i in enumerate(idxs):
            out_aggs[i] = a[j]
    return out_keys, out_aggs, out_sel


class SortedSegments:
    """Reduction machinery for rows sorted by group key: starts[g] / ends[g]
    are the first/last row of group g, and sums are read off prefix sums at
    those rows."""

    def __init__(self, seg: torch.Tensor, ssel: torch.Tensor,
                 is_start: torch.Tensor, G: int):
        n = seg.shape[0]
        dev = seg.device
        self.G = G
        self.seg = seg
        self.ssel = ssel
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        # the start rows' indices land at their segment ids (distinct, so the
        # scatter is deterministic); slot G takes every other row and is cut
        slot = torch.where(is_start, seg.to(torch.int64), G)
        starts = torch.zeros(G + 1, dtype=torch.int32, device=dev)
        starts.scatter_(0, slot, iota)
        self.starts = starts[:G]
        # Live rows are a contiguous prefix (sort_rows sinks dead rows), so
        # group g ends where group g+1 starts.
        ng = is_start.sum(dtype=torch.int32)
        live_rows = ssel.sum(dtype=torch.int32)
        gi = torch.arange(G, dtype=torch.int32, device=dev)
        self.gi = gi
        self.ng = ng
        self.live = gi < ng
        nxt_start = torch.cat([self.starts[1:],
                               torch.full((1,), n, dtype=torch.int32, device=dev)])
        ends = torch.where(gi == ng - 1, live_rows - 1, nxt_start - 1)
        self.ends = torch.clamp(torch.where(self.live, ends, 0), 0, n - 1)
        self.count_all = torch.where(
            self.live, (self.ends - self.starts + 1).to(torch.int64), 0)

    def _prefix_sum(self, values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # the exclusive prefix at each group start, S; group g's sum is
        # S[g+1] - S[g] (S[ng] = grand total, valid because mask is within
        # ssel and dead rows contribute zero). Exact for integers (wrapping).
        z = torch.where(mask, values, torch.zeros_like(values))
        cs = torch.cumsum(z, 0, dtype=z.dtype)
        S = (cs - z)[self.starts.long()]
        nxt = torch.cat([S[1:], torch.zeros(1, dtype=S.dtype, device=S.device)])
        hi = torch.where(self.gi == self.ng - 1, cs[-1], nxt)
        return torch.where(self.live, hi - S, torch.zeros_like(S))

    def sum(self, values, mask):
        if values.dtype.is_floating_point:
            return K.segment_sum(values, self.seg, mask, self.G)
        return self._prefix_sum(values, mask)

    def count(self, mask):
        if mask is self.ssel:
            return self.count_all
        # counts fit int32 (capacity < 2^31)
        return self._prefix_sum(mask.to(torch.int32), mask).to(torch.int64)

    def min(self, values, mask):
        return K.segment_min(values, self.seg, mask, self.G)

    def max(self, values, mask):
        return K.segment_max(values, self.seg, mask, self.G)


def _segmented_scan(op, is_start: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of an associative `op` that restarts at every
    is_start row: the reference's associative_scan over
    (flag, value) -> (af | bf, where(bf, bv, op(av, bv))), as log2(n)
    doubling steps."""
    f, v = is_start, values
    n = v.shape[0]
    s = 1
    while s < n:
        bf, bv = f[s:], v[s:]
        v = torch.cat([v[:s], torch.where(bf, bv, op(v[:-s], bv))])
        f = torch.cat([f[:s], f[:-s] | bf])
        s *= 2
    return v


def phase_reduce(
    sg: Sequence[DeviceColumn],
    sa: Sequence[DeviceColumn],
    sf: Sequence[torch.Tensor],
    ssel: torch.Tensor,
    seg: torch.Tensor,
    is_start: torch.Tensor,
    distinct_start: Optional[torch.Tensor],
    specs: Sequence[AggSpec],
    num_segments: int,
) -> Tuple[List[DeviceColumn], List[DeviceColumn], torch.Tensor]:
    """Segment reductions. Returns (group key columns, agg result columns,
    out_sel) with capacity == num_segments."""
    G = num_segments
    ss = SortedSegments(seg, ssel, is_start, G)
    first_idx = ss.starts.long()
    group_count = ss.count_all
    out_sel = group_count > 0

    out_keys = []
    for c in sg:
        validity = None if c.validity is None else (c.validity[first_idx] & out_sel)
        # group keys are input values: input bounds stay valid
        out_keys.append(DeviceColumn(c.data[first_idx], validity, c.dtype,
                                     c.dictionary, bounds=c.bounds))

    out_aggs = [_reduce_one(spec, sa, sf, ssel, seg, is_start, distinct_start,
                            G, group_count, out_sel, ss)
                for spec in specs]
    return out_keys, out_aggs, out_sel


def _distinct_marker(mask: torch.Tensor, distinct_start: torch.Tensor) -> torch.Tensor:
    """First FILTER-passing row of each (group, value) run.

    distinct_start marks the first row of each run irrespective of any FILTER
    clause; when a filter is present the run's first row may fail it while a
    later row of the same value passes. A row is the marker iff it passes and
    the inclusive within-run passing count is exactly 1."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    cs = torch.cumsum(m, 0, dtype=torch.int32)
    excl = cs - m
    iota = torch.arange(n, device=mask.device)
    last_start = torch.cummax(torch.where(distinct_start, iota, 0), 0).values
    within = cs - excl[torch.clamp(last_start, 0, n - 1)]
    return mask & (within == 1)


def _float(c: DeviceColumn) -> torch.Tensor:
    """float64 values, decimals descaled."""
    x = c.data.to(torch.float64)
    if c.dtype.is_decimal:
        x = x / (10.0 ** c.dtype.scale)
    return x


def _reduce_one(spec, sa, sf, ssel, seg, is_start, distinct_start, G,
                group_count, out_sel, ss=None):
    f = spec.fname
    dev = ssel.device
    if f in NOT_PORTED:
        raise not_ported_error(f)
    mask = ssel
    filtered = spec.filter is not None
    if filtered:
        mask = mask & sf[spec.filter]
        if f in ("median", "approx_median", "percentile_cont",
                 "approx_percentile_cont"):
            # position-based indexing from the group start assumes passing
            # rows are contiguous, which a FILTER breaks
            raise PlanError(f"{f} with FILTER is not supported")

    def dmark():
        if distinct_start is None:
            return mask
        return _distinct_marker(mask, distinct_start) if filtered \
            else (mask & distinct_start)

    def SSUM(x, m):
        return ss.sum(x, m) if ss is not None else K.segment_sum(x, seg, m, G)

    def SCNT(m):
        return ss.count(m) if ss is not None else K.segment_count(seg, m, G)

    def SMIN(x, m):
        return ss.min(x, m) if ss is not None else K.segment_min(x, seg, m, G)

    def SMAX(x, m):
        return ss.max(x, m) if ss is not None else K.segment_max(x, seg, m, G)

    if f == "count_star":
        return DeviceColumn(SCNT(mask).to(torch.int64), None, T.INT64)

    arg = sa[spec.arg] if spec.arg is not None else None
    if arg is not None and arg.validity is not None:
        mask = mask & arg.validity

    if f == "count":
        cnt = SCNT(dmark()) if spec.distinct else SCNT(mask)
        return DeviceColumn(cnt.to(torch.int64), None, T.INT64)

    if arg is None:
        raise PlanError(f"aggregate {f} requires an argument")
    data = arg.data
    if spec.distinct and f in ("sum", "avg"):
        mask = dmark()

    if f == "sum":
        acc = data
        if spec.out_dtype.is_float:
            acc = data.to(torch.float64)
        elif arg.dtype.is_decimal:
            acc = data  # int64 scaled
        elif is_integer(data) or data.dtype is torch.bool:
            acc = data.to(torch.int64)  # widen before accumulation
        s = SSUM(acc, mask)
        cnt = SCNT(mask)
        if spec.out_dtype.is_decimal or spec.out_dtype.kind is T.TypeKind.INT64:
            s = s.to(torch.int64)
        else:
            s = s.to(torch_dtype(spec.out_dtype))
        return DeviceColumn(s, (cnt > 0) & out_sel, spec.out_dtype)

    if f in ("avg", "mean"):
        if arg.dtype.is_decimal and spec.out_dtype.is_decimal:
            # exact int64 scaled sum; one rounded division to the output
            # scale s+4 (reference: avg.rs decimal path)
            s = SSUM(data, mask).to(torch.float64)
            cnt = SCNT(mask)
            num = s * (10.0 ** (spec.out_dtype.scale - arg.dtype.scale))
            a = torch.trunc(num / torch.clamp(cnt, min=1).to(torch.float64))
            return DeviceColumn(a.to(torch.int64), (cnt > 0) & out_sel,
                                spec.out_dtype)
        s = SSUM(_float(arg), mask)
        cnt = SCNT(mask)
        avg = s / torch.clamp(cnt, min=1).to(torch.float64)
        return DeviceColumn(avg, (cnt > 0) & out_sel, T.FLOAT64)

    if f in ("min", "max"):
        r = SMIN(data, mask) if f == "min" else SMAX(data, mask)
        cnt = SCNT(mask)
        r = torch.clamp(r, min=0) if arg.dictionary is not None else r
        return DeviceColumn(r, (cnt > 0) & out_sel, spec.out_dtype, arg.dictionary)

    if f in ("var", "var_samp", "var_pop", "stddev", "stddev_samp", "stddev_pop"):
        x = _float(arg)
        s = SSUM(x, mask)
        s2 = SSUM(x * x, mask)
        cnt = SCNT(mask).to(torch.float64)
        pop = f.endswith("_pop")
        denom = torch.clamp(cnt if pop else cnt - 1.0, min=1.0)
        var = (s2 - s * s / torch.clamp(cnt, min=1.0)) / denom
        var = torch.clamp(var, min=0.0)
        out = torch.sqrt(var) if f.startswith("stddev") else var
        min_n = 1.0 if pop else 2.0
        return DeviceColumn(out, (cnt >= min_n) & out_sel, T.FLOAT64)

    if f in ("first_value", "last_value", "any_value"):
        n = ssel.shape[0]
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        if f == "last_value":
            idx = K.segment_max(iota, seg, mask, G)
        else:
            idx = K.segment_min(iota, seg, mask, G)
        cnt = K.segment_count(seg, mask, G)
        idx = torch.clamp(idx, 0, n - 1).long()
        validity = (cnt > 0) & out_sel
        if arg.validity is not None:
            validity = validity & arg.validity[idx]
        return DeviceColumn(data[idx], validity, spec.out_dtype, arg.dictionary)

    if f in ("bool_and", "bool_or"):
        red = K.segment_min if f == "bool_and" else K.segment_max
        r = red(data, seg, mask, G)
        cnt = K.segment_count(seg, mask, G)
        return DeviceColumn(r.to(torch.bool), (cnt > 0) & out_sel, T.BOOL)

    if f in ("bit_and", "bit_or", "bit_xor"):
        # segmented scan with identity-masked rows (reference:
        # functions-aggregate/src/bit_and_or_xor.rs); DISTINCT is a no-op
        # for the idempotent and/or
        if spec.distinct and f == "bit_xor":
            mask = dmark()
        x = data.to(torch.int64)
        ident, op = {"bit_and": (-1, torch.bitwise_and),
                     "bit_or": (0, torch.bitwise_or),
                     "bit_xor": (0, torch.bitwise_xor)}[f]
        z = torch.where(mask, x, torch.full_like(x, ident))
        scanned = _segmented_scan(op, is_start, z)
        if ss is not None:
            ends = ss.ends
        elif G == 1:
            ends = torch.full((1,), x.shape[0] - 1, dtype=torch.int32, device=dev)
        else:
            raise PlanError(f"{f} requires the sorted aggregation path")
        cnt = SCNT(mask)
        r = scanned[ends.long()].to(torch_dtype(spec.out_dtype))
        return DeviceColumn(r, (cnt > 0) & out_sel, spec.out_dtype)

    if f == "nth_value":
        # n-th FILTER/validity-passing row of the group in input order
        # (reference: functions-aggregate/src/nth_value.rs); n is 1-based,
        # negative n counts from the end
        n_ = int(spec.extra) if spec.extra is not None else 1
        nrows = ssel.shape[0]
        m = mask.to(torch.int64)
        cs = torch.cumsum(m, 0)
        iota32 = torch.arange(nrows, dtype=torch.int32, device=dev)
        start_of = torch.cummax(torch.where(is_start, iota32, 0), 0).values
        within = cs - (cs - m)[torch.clamp(start_of, 0, nrows - 1).long()]
        cnt = SCNT(mask)
        if n_ >= 0:
            want = torch.tensor(n_, dtype=torch.int64, device=dev)
        else:
            want = torch.clamp(cnt + n_ + 1, min=0)[
                torch.clamp(seg, 0, G - 1).long()]
        marker = mask & (within == want)
        idx = K.segment_max(torch.where(marker, iota32, -1), seg, marker, G)
        have = (cnt >= abs(n_)) & out_sel
        if n_ == 0:
            have = torch.zeros_like(have)
        idx = torch.clamp(idx, 0, nrows - 1).long()
        validity = have
        if arg.validity is not None:
            validity = validity & arg.validity[idx]
        return DeviceColumn(data[idx], validity, spec.out_dtype, arg.dictionary)

    if f in ("median", "approx_median", "percentile_cont", "approx_percentile_cont"):
        # rows are sorted by (group keys, value) -- see order_arg_of/phase_sort
        n = ssel.shape[0]
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        first = ss.starts if ss is not None else K.segment_min(iota, seg, mask, G)
        cnt = SCNT(mask)
        q = 0.5 if spec.extra is None else float(spec.extra)
        pos = q * torch.clamp(cnt - 1, min=0).to(torch.float64)
        lo_i = torch.clamp(first + torch.floor(pos).to(torch.int64).to(torch.int32),
                           0, n - 1).long()
        hi_i = torch.clamp(first + torch.ceil(pos).to(torch.int64).to(torch.int32),
                           0, n - 1).long()
        frac = pos - torch.floor(pos)
        x = data.to(torch.float64)
        if arg.dtype.is_decimal and spec.out_dtype.is_decimal:
            # median of decimals keeps the input type (reference: median.rs):
            # interpolate on raw scaled ints, truncate
            v = x[lo_i] * (1.0 - frac) + x[hi_i] * frac
            return DeviceColumn(torch.trunc(v).to(torch.int64),
                                (cnt > 0) & out_sel, spec.out_dtype)
        if arg.dtype.is_decimal:
            x = x / (10.0 ** arg.dtype.scale)
        v = x[lo_i] * (1.0 - frac) + x[hi_i] * frac
        return DeviceColumn(v, (cnt > 0) & out_sel, T.FLOAT64)

    if f.startswith("regr_") or f in ("corr", "covar", "covar_pop", "covar_samp"):
        return _two_arg(spec, sa, mask, seg, G, out_sel)

    from ..expr.udf import active_registry

    if active_registry().aggregate(f) is not None:
        raise not_ported_error(f)
    raise PlanError(f"aggregate function {f!r} not implemented")


def _two_arg(spec, sa, mask, seg, G, out_sel) -> DeviceColumn:
    """corr / covar* / regr_* over (first, second) argument pairs with both
    non-null; the second argument is the arg column right after the first
    (AggregateExec._prepare appends it there)."""
    f = spec.fname
    a, b = sa[spec.arg], sa[spec.arg + 1]
    m = mask if b.validity is None else (mask & b.validity)
    if f.startswith("regr_"):
        # regression: the first argument is the dependent variable y
        # (reference: functions-aggregate/src/regr.rs)
        yv, xv = _float(a), _float(b)
    else:
        xv, yv = _float(a), _float(b)
    sx = K.segment_sum(xv, seg, m, G)
    sy = K.segment_sum(yv, seg, m, G)
    sxy = K.segment_sum(xv * yv, seg, m, G)
    sxx = K.segment_sum(xv * xv, seg, m, G)
    syy = K.segment_sum(yv * yv, seg, m, G)
    cnt = K.segment_count(seg, m, G).to(torch.float64)
    cn = torch.clamp(cnt, min=1.0)
    if f == "regr_count":
        return DeviceColumn(cnt.to(torch.int64), None, T.INT64)
    if f in ("corr", "covar", "covar_pop", "covar_samp"):
        cov = sxy - sx * sy / cn
        if f == "corr":
            vx = sxx - sx * sx / cn
            vy = syy - sy * sy / cn
            denom = torch.sqrt(torch.clamp(vx * vy, min=0.0))
            out = torch.where(denom > 0, cov / denom,
                              torch.full_like(cov, float("nan")))
            return DeviceColumn(out, (cnt >= 2) & out_sel, T.FLOAT64)
        denom = cn if f == "covar_pop" else torch.clamp(cnt - 1.0, min=1.0)
        min_n = 1.0 if f == "covar_pop" else 2.0
        return DeviceColumn(cov / denom, (cnt >= min_n) & out_sel, T.FLOAT64)
    Sxx = sxx - sx * sx / cn
    Syy = syy - sy * sy / cn
    Sxy = sxy - sx * sy / cn
    nonempty = (cnt >= 1) & out_sel
    simple = {"regr_avgx": sx / cn, "regr_avgy": sy / cn, "regr_sxx": Sxx,
              "regr_syy": Syy, "regr_sxy": Sxy}
    if f in simple:
        return DeviceColumn(simple[f], nonempty, T.FLOAT64)
    ok = nonempty & (Sxx > 0)
    slope = Sxy / torch.where(Sxx > 0, Sxx, torch.ones_like(Sxx))
    if f == "regr_slope":
        return DeviceColumn(slope, ok, T.FLOAT64)
    if f == "regr_intercept":
        return DeviceColumn(sy / cn - slope * sx / cn, ok, T.FLOAT64)
    if f == "regr_r2":
        both = (Sxx > 0) & (Syy > 0)
        r2 = torch.where(Syy > 0,
                         (Sxy * Sxy) / torch.where(both, Sxx * Syy,
                                                   torch.ones_like(Sxx)),
                         torch.ones_like(Sxx))
        return DeviceColumn(r2, ok, T.FLOAT64)
    raise PlanError(f"unknown regression aggregate {f!r}")


def global_aggregate(
    agg_args: Sequence[DeviceColumn],
    filters: Sequence[torch.Tensor],
    sel: torch.Tensor,
    specs: Sequence[AggSpec],
    out_capacity: int,
) -> Tuple[List[DeviceColumn], torch.Tensor]:
    """No GROUP BY: reduce the whole relation to one row (padded to
    out_capacity) as a single-segment reduction through _reduce_one; each
    order-arg bucket (DISTINCT / order-statistic argument) gets its own
    value sort, like the grouped multi-bucket path."""
    n = sel.shape[0]
    dev = sel.device
    one = torch.ones(1, dtype=torch.bool, device=dev)
    assign = bucket_assignment(specs)
    outs: List[Optional[DeviceColumn]] = [None] * len(specs)
    for bi, b in enumerate(order_arg_buckets(specs)):
        idxs = [i for i, a in enumerate(assign) if a == bi]
        if not idxs:
            continue
        if b is not None:
            _, sa, sf, ssel, seg, is_start, distinct_start, _ = phase_sort(
                [], agg_args, filters, sel, b)
        else:
            sa, sf, ssel = agg_args, filters, sel
            seg = torch.zeros(n, dtype=torch.int32, device=dev)
            is_start = torch.zeros(n, dtype=torch.bool, device=dev)
            is_start[:1] = True
            distinct_start = None
        group_count = K.segment_count(seg, ssel, 1)
        for i in idxs:
            c = _reduce_one(specs[i], sa, sf, ssel, seg, is_start,
                            distinct_start, 1, group_count, one)
            data = torch.zeros(out_capacity, dtype=c.data.dtype, device=dev)
            data[:1] = c.data[:1]
            validity = None
            if c.validity is not None:
                validity = torch.zeros(out_capacity, dtype=torch.bool, device=dev)
                validity[:1] = c.validity[:1]
            outs[i] = DeviceColumn(data, validity, c.dtype, c.dictionary,
                                   None, None, None, c.meta)
    out_sel = torch.zeros(out_capacity, dtype=torch.bool, device=dev)
    out_sel[:1] = True
    return outs, out_sel
