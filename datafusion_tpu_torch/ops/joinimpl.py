"""Equi-join over device relations (all join types + residual filters).

Port of datafusion_tpu/ops/joinimpl.py to torch ops. Keys from both sides
become exact ids (raw integers, a mixed-radix pack of bounds-proven keys,
or dense ids from ops/kernels.canonical_ids_two_sided), the build side is
sorted by id and each probe row finds its match run with torch.searchsorted;
expansion to (probe, build) output pairs is a gather computed from the
prefix sum of match counts (ops/kernels.join_match_counts / join_expand).

When the keys' bounds prove a small dense domain, a direct-address table
replaces the sorts: one scatter builds table[key] -> build row, one gather
probes it (join_direct_lookup); semi/anti joins need only an existence
bitmap (join_direct_exists) or, with one comparison as residual, a per-key
min/max (join_exists_minmax). A single inequality between the sides sorts
the build side by that value and matches a prefix or suffix of it
(range_join_phase1).

Every direct-address table has one slot past its domain: dead and NULL-keyed
build rows are scattered there and the slot is never read, where the
reference drops them with `mode="drop"` (torch's scatters raise on, or write
past, an out-of-range index). A table built by scatter-set is trusted only
when no two live build rows share a slot: with duplicates the winner of a
CUDA scatter is unspecified, so join_direct_lookup reports `dup` and the
caller takes the sort-merge path.

Not ported (TPU layout workarounds): the int32 lane packing of payload
columns and their 2-lane tables, the int32 narrowing of the min/max
scatters, and the bucketed direct path for composite keys whose full domain
is too large (ROADMAP queue 1, item 6 deferrals); such joins take the
sort-merge path, which gives the same rows.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..data.device import DeviceColumn, is_integer
from . import kernels as K


def join_phase1(
    left_keys: Sequence[DeviceColumn],
    right_keys: Sequence[DeviceColumn],
    left_sel: torch.Tensor,
    right_sel: torch.Tensor,
):
    """probe = left, build = right. Returns (perm, lo, cnt, total).

    Bounds-proven keys pack into one dense int64 domain; other integer keys
    (one, or two 32-bit ones) join on their raw values; anything else goes
    through exact dense-id canonicalization."""
    bounded = _bounded_ids(left_keys, right_keys, left_sel, right_sel)
    if bounded is not None:
        lids, l_live, rids, r_live, domain = bounded
        return K.join_match_counts_small(rids, r_live, lids, l_live, domain)
    lpairs = [(c.data, c.validity) for c in left_keys]
    rpairs = [(c.data, c.validity) for c in right_keys]
    lpacked = K.pack_join_keys(lpairs, left_sel)
    rpacked = K.pack_join_keys(rpairs, right_sel)
    if lpacked is not None and rpacked is not None:
        lids, l_live = lpacked
        rids, r_live = rpacked
    else:
        lids, rids = K.canonical_ids_two_sided(lpairs, rpairs, left_sel, right_sel)
        l_live = left_sel & (lids >= 0)
        r_live = right_sel & (rids >= 0)
    return K.join_match_counts(rids, r_live, lids, l_live)


def direct_domain(left_keys, right_keys, limit: int) -> Optional[Tuple]:
    """(spans, domain) for the direct-address table when the composite key
    domain is proven dense (bounds / dictionary sizes) and at most `limit`
    slots; None otherwise."""
    spans = []
    domain = 1
    for lc, rc in zip(left_keys, right_keys):
        lb, rb = _key_bounds(lc), _key_bounds(rc)
        if lb is None or rb is None:
            return None
        lo = min(lb[0], rb[0])
        hi = max(lb[1], rb[1])
        span = hi - lo + 1
        if span <= 0:
            return None
        spans.append((lo, span))
        domain *= span
        if domain > limit:
            return None
    return tuple(spans), domain


def _make_ids(keys, sel, spans):
    """Mixed-radix ids of the keys over `spans`, and the rows that can match
    (live, no NULL key)."""
    ids = None
    live = sel
    for c, (lo, span) in zip(keys, spans):
        if c.validity is not None:
            live = live & c.validity
        v = c.data.to(torch.int64) - lo
        ids = v if ids is None else ids * span + v
    return ids, live


def _slots(keys, sel, spans, domain: int):
    """(table slot of each row, live): dead and NULL-keyed rows go to the
    extra slot `domain`."""
    ids, live = _make_ids(keys, sel, spans)
    return torch.where(live, torch.clamp(ids, 0, domain - 1), domain), live


def _probe_slots(keys, sel, spans, domain: int):
    ids, live = _make_ids(keys, sel, spans)
    return torch.clamp(ids, 0, domain - 1), live


def join_direct_lookup(probe_keys, build_keys, probe_sel, build_sel,
                       spans, domain: int):
    """Direct-address join over a proven-dense key domain: one scatter builds
    table[key] -> build row, one gather probes it; no sorts, no expansion.
    Returns (build_row, matched, dup): dup (a 0-d bool tensor) flags a
    build side where two live rows share a key. The row mapping is then not
    the full match set, and the caller must take the expanding path.

    Duplicates are found without counting: after the scatter every live
    build row reads its slot back, and a row that does not find itself lost
    its slot to another live row with the same key."""
    bslot, b_live = _slots(build_keys, build_sel, spans, domain)
    iota = torch.arange(bslot.shape[0], dtype=torch.int64, device=bslot.device)
    table = torch.full((domain + 1,), -1, dtype=torch.int64, device=bslot.device)
    table[bslot] = iota
    dup = (b_live & (table[bslot] != iota)).any()
    pslot, p_live = _probe_slots(probe_keys, probe_sel, spans, domain)
    brow = table[pslot]
    matched = p_live & (brow >= 0)
    return torch.clamp(brow, min=0), matched, dup


def join_direct_gather(probe_keys, build_keys, probe_sel, build_sel,
                       spans, domain: int, build_cols,
                       null_unmatched: bool = True):
    """join_direct_lookup followed by one gather of every build column.
    Returns (cols, matched, dup); unmatched rows are NULL when
    null_unmatched (inner joins mask them through sel instead)."""
    brow, matched, dup = join_direct_lookup(probe_keys, build_keys, probe_sel,
                                            build_sel, spans, domain)
    cols = gather_columns(build_cols, brow, matched,
                          null_extend=~matched if null_unmatched else None)
    return cols, matched, dup


def join_exists_minmax(probe_keys, build_keys, probe_sel, build_sel,
                       spans, domain: int,
                       probe_col: DeviceColumn, build_col: DeviceColumn,
                       op: str) -> torch.Tensor:
    """Existence bitmap for a semi/anti join whose residual is ONE
    comparison `probe_col OP build_col` (op in lt/le/gt/ge/neq), over a
    proven-dense key domain: a per-key min/max of the build column replaces
    the expansion --
      exists b: key(b)=key(p) and p  < b.col  <=>  p.col <  max[key]
      exists b: key(b)=key(p) and p <> b.col  <=>  cnt>=1 and
                                                  (min[key] != p.col or
                                                   max[key] != p.col)
    (TPC-H Q21's `l2.l_suppkey <> l1.l_suppkey`). NULL build values never
    satisfy a comparison (excluded from min/max); NULL probe values match
    nothing."""
    pdata, bdata, pc, bc = _range_compare_domain(probe_col, build_col)
    bslot, _ = _slots(build_keys, build_sel if bc.validity is None
                      else build_sel & bc.validity, spans, domain)
    pslot, p_live = _probe_slots(probe_keys, probe_sel, spans, domain)
    if pc.validity is not None:
        p_live = p_live & pc.validity
    b_live = bslot < domain
    dev = bdata.device
    if bdata.dtype.is_floating_point:
        lo, hi = torch.finfo(bdata.dtype).min, torch.finfo(bdata.dtype).max
    else:
        lo, hi = torch.iinfo(bdata.dtype).min, torch.iinfo(bdata.dtype).max
    # with integer bounds strictly inside the dtype's range, a min/max still
    # at its start value proves "no build row" and the count is not needed
    sent_ok = False
    if is_integer(bdata) and pc.bounds is not None and bc.bounds is not None:
        lo_b = min(int(pc.bounds[0]), int(bc.bounds[0]))
        hi_b = max(int(pc.bounds[1]), int(bc.bounds[1]))
        sent_ok = lo < lo_b and hi_b < hi
    mn = mx = None
    if op in ("gt", "ge", "neq"):
        mn = torch.full((domain + 1,), hi, dtype=bdata.dtype, device=dev)
        mn = mn.scatter_reduce_(0, bslot, torch.where(b_live, bdata, hi), "amin")
        mn = mn[pslot]
    if op in ("lt", "le", "neq"):
        mx = torch.full((domain + 1,), lo, dtype=bdata.dtype, device=dev)
        mx = mx.scatter_reduce_(0, bslot, torch.where(b_live, bdata, lo), "amax")
        mx = mx[pslot]
    if sent_ok:
        has = (mn != hi) if mn is not None else (mx != lo)
    else:
        cnt = torch.zeros(domain + 1, dtype=torch.int32, device=dev)
        cnt = cnt.index_add_(0, bslot, torch.ones_like(bslot, dtype=torch.int32))
        has = cnt[pslot] > 0
    if op == "lt":
        ok = pdata < mx
    elif op == "le":
        ok = pdata <= mx
    elif op == "gt":
        ok = pdata > mn
    elif op == "ge":
        ok = pdata >= mn
    else:  # neq
        ok = (mn != pdata) | (mx != pdata)
    return p_live & has & ok


def join_direct_exists(probe_keys, build_keys, probe_sel, build_sel,
                       spans, domain: int) -> torch.Tensor:
    """Existence bitmap for semi/anti joins over a dense key domain: correct
    for any build-side multiplicity (every write stores True)."""
    bslot, _ = _slots(build_keys, build_sel, spans, domain)
    exists = torch.zeros(domain + 1, dtype=torch.bool, device=bslot.device)
    # index_fill_ takes the value as a scalar; `exists[bslot] = True` would
    # copy a host tensor to the card, a host sync
    exists.index_fill_(0, bslot, True)
    pslot, p_live = _probe_slots(probe_keys, probe_sel, spans, domain)
    return p_live & exists[pslot]


def _key_bounds(c: DeviceColumn) -> Optional[Tuple[int, int]]:
    """Integer-comparable bounds of one join-key column: value bounds from
    interval metadata, or [0, size) for dictionary codes (both sides of a
    string join share one unified sorted dictionary)."""
    if c.dtype.is_string:
        if c.dictionary is None:
            return None
        return (0, max(len(c.dictionary.values) - 1, 0))
    if not is_integer(c.data) or c.bounds is None:
        return None
    return (int(c.bounds[0]), int(c.bounds[1]))


def _bounded_ids(left_keys, right_keys, left_sel, right_sel):
    """Mixed-radix-pack composite keys into one proven-dense int64 domain
    when bounds metadata allows. Returns (lids, l_live, rids, r_live,
    domain) or None."""
    spans = []
    domain = 1
    for lc, rc in zip(left_keys, right_keys):
        lb, rb = _key_bounds(lc), _key_bounds(rc)
        if lb is None or rb is None:
            return None
        lo = min(lb[0], rb[0])
        hi = max(lb[1], rb[1])
        span = hi - lo + 1
        if span <= 0:
            return None
        spans.append((lo, span))
        domain *= span
        if 4 * domain >= (1 << 62):
            return None
    lids, l_live = _make_ids(left_keys, left_sel, spans)
    rids, r_live = _make_ids(right_keys, right_sel, spans)
    return lids, l_live, rids, r_live, domain


def _range_compare_domain(l: DeviceColumn, r: DeviceColumn):
    """Cast both key columns into one order-preserving comparable domain."""
    if l.dtype.is_string or r.dtype.is_string:
        from ..physical.expr_compiler import unify_string_columns

        l, r = unify_string_columns(l, r)  # shared sorted dict: codes compare
        return l.data.to(torch.int64), r.data.to(torch.int64), l, r
    if l.dtype.is_decimal or r.dtype.is_decimal:
        ls = l.dtype.scale if l.dtype.is_decimal else 0
        rs = r.dtype.scale if r.dtype.is_decimal else 0
        s = max(ls, rs)
        ld = l.data.to(torch.int64) * (10 ** (s - ls))
        rd = r.data.to(torch.int64) * (10 ** (s - rs))
        return ld, rd, l, r
    if l.dtype.is_float or r.dtype.is_float:
        return l.data.to(torch.float64), r.data.to(torch.float64), l, r
    return l.data.to(torch.int64), r.data.to(torch.int64), l, r


def range_join_phase1(
    probe_key: DeviceColumn,
    build_key: DeviceColumn,
    op: str,  # probe-side comparison: lt | le | gt | ge
    probe_sel: torch.Tensor,
    build_sel: torch.Tensor,
):
    """Phase 1 of the single-range-predicate join (reference:
    PiecewiseMergeJoinExec): sort the build side by the range key; each
    probe row's match set is a prefix (probe > / >= build) or a suffix
    (probe < / <= build) of the sorted live build rows, described by the
    same (perm, lo, cnt, total) the equi-join expansion consumes."""
    pdata, bdata, pk, bk = _range_compare_domain(probe_key, build_key)
    p_live = probe_sel if pk.validity is None else (probe_sel & pk.validity)
    b_live = build_sel if bk.validity is None else (build_sel & bk.validity)
    perm, skeys, live_before = K.sorted_live_ranks(bdata, b_live)
    nlive = live_before[-1]
    right = op in ("lt", "ge")  # rank counts build keys <= probe
    rank = live_before[torch.searchsorted(skeys, pdata, right=right)]
    if op in ("lt", "le"):
        lo = rank
        cnt = nlive - rank
    else:
        lo = torch.zeros_like(rank)
        cnt = rank
    cnt = torch.where(p_live, cnt, 0).to(torch.int32)
    return perm, lo, cnt, cnt.sum(dtype=torch.int64)


def _gathered_bounds(c: DeviceColumn, null_extend) -> Optional[Tuple[int, int]]:
    """Bounds survive a gather: outputs are a subset of the source's physical
    array (whose dead slots the bounds already cover), plus fresh zeros where
    rows are null-extended, so widen to include 0 in that case."""
    if c.bounds is None:
        return None
    lo, hi = int(c.bounds[0]), int(c.bounds[1])
    if null_extend is not None:
        lo, hi = min(lo, 0), max(hi, 0)
    return (lo, hi)


def gather_columns(
    cols: Sequence[DeviceColumn],
    idx: torch.Tensor,
    row_valid: torch.Tensor,
    null_extend: Optional[torch.Tensor] = None,
) -> List[DeviceColumn]:
    """Gather columns at idx (clamped into range); rows where null_extend is
    True become NULL with zeroed data. One gather per tensor: the
    reference's int32 lane packing exists for the TPU's per-row gather cost
    and is not ported."""
    if not cols:
        return []
    safe = torch.clamp(idx.to(torch.int64), 0, max(cols[0].capacity - 1, 0))
    out = []
    for c in cols:
        data = c.data[safe]
        validity = c.validity[safe] if c.validity is not None else None
        lengths = c.lengths[safe] if c.lengths is not None else None
        ev = c.elem_valid[safe] if c.elem_valid is not None else None
        if null_extend is not None:
            v = validity if validity is not None else torch.ones_like(null_extend)
            validity = v & ~null_extend
            ne = null_extend.view((-1,) + (1,) * (data.ndim - 1))
            data = torch.where(ne, torch.zeros_like(data), data)
        out.append(DeviceColumn(data, validity, c.dtype, c.dictionary,
                                _gathered_bounds(c, null_extend), lengths, ev,
                                c.meta))
    return out
