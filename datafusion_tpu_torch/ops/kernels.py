"""Core vectorized building blocks shared by the physical operators.

Port of the single-device subset of datafusion_tpu/ops/kernels.py to torch
ops:

* `sort_rows` / `sort_permutation` -- multi-key stable sort with ASC/DESC,
  NULLS FIRST/LAST and dead-row (sel=False) sinking;
* `compaction_indices` -- the first `cap` live row indices, ascending;
* `segments_from_sorted_keys` -- group boundaries and dense segment ids of
  rows sorted by their group keys;
* masked segment reductions (sum, count, min, max) over dense group ids;
* the equi-join core: `canonical_ids_two_sided` (exact dense ids for
  composite keys across both sides), `pack_join_keys`, `join_match_counts`
  (build side sorted by id, probes located with `torch.searchsorted`) and
  `join_expand` (output slot -> (probe row, build row));
* `hash64` -- a 64-bit hash per row over several columns (the grace join's
  partitioning, physical/chunked.py), and `hash_mod`, the unsigned
  remainder that routes a row to a shard (parallel/);
* `segmented_scan` -- an inclusive scan of any associative combine that
  restarts at flagged rows (torch has no associative_scan): bitwise
  aggregates, window min/max, aggregate and window UDFs.

Every sort is stable (`torch.sort(..., stable=True)`), as every reference
sort is. Segment ids at or beyond the segment count are dropped, as
`jax.ops.segment_sum` drops them: torch's `index_add_` would raise on them
(CPU) or write out of bounds (CUDA), so they are routed to one extra bucket
that is sliced off. Segment min/max start from the reduction's identity
and scatter with `include_self=False`: torch's `scatter_reduce_` would
otherwise fold the starting value into every segment.

Dead and NULL-keyed join rows never match, and no key value is reserved to
mark them: the build side's liveness is counted beside its sorted keys, so a
live key equal to INT64_MIN or INT64_MAX joins like any other.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..data.device import is_integer

# splitmix64 multipliers as int64 bit patterns (0xFF51AFD7ED558CCD,
# 0xC4CEB9FE1A85EC53)
_M1 = 0xFF51AFD7ED558CCD - (1 << 64)
_M2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_LOW31 = (1 << 31) - 1


def _shr33(x: torch.Tensor) -> torch.Tensor:
    """The logical right shift by 33 of int64 bit patterns (uint64 `>>`
    raises on the CPU; the arithmetic shift's sign bits are masked off)."""
    return (x >> 33) & _LOW31


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64-style finalizer over uint64 bit patterns held in int64
    (multiplication and xor wrap the same in both)."""
    x = x ^ _shr33(x)
    x = x * _M1
    x = x ^ _shr33(x)
    x = x * _M2
    x = x ^ _shr33(x)
    return x


def hash64(columns: Sequence[torch.Tensor], seed: int = 0) -> torch.Tensor:
    """A 64-bit hash per row of several columns, as int64 bit patterns
    equal to the reference's uint64 ones. Integer and bool columns hash
    their values widened to 64 bits (negative values sign-extended), float64
    columns their bits, float32 columns their 32 bits zero-extended."""
    assert columns, "hash64 needs at least one column"
    n = columns[0].shape[0]
    dev = columns[0].device
    seed64 = (int(seed) ^ (_M1 + (1 << 64))) & ((1 << 64) - 1)
    acc = torch.full((n,), seed64 - (1 << 64) if seed64 >= 1 << 63 else seed64,
                     dtype=torch.int64, device=dev)
    for c in columns:
        if c.dtype is torch.float64:
            bits = c.view(torch.int64)
        elif c.dtype is torch.float32:
            bits = c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        else:
            bits = c.to(torch.int64)
        acc = _mix64(acc ^ _mix64(bits))
    return acc


def hash_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's `uint64 hash % n` of hash64's int64 bit patterns: the
    unsigned remainder (a negative pattern stands for itself plus 2**64)."""
    r = torch.remainder(h, n)
    return torch.where(h < 0, torch.remainder(r + (2 ** 64) % n, n), r)


def _sortable(x: torch.Tensor) -> torch.Tensor:
    """bool keys sort as uint8 (False first)."""
    return x.to(torch.uint8) if x.dtype is torch.bool else x


def _order_key(data: torch.Tensor, descending: bool) -> torch.Tensor:
    """Transform a column so ascending sort yields the requested order.
    Integer DESC uses bitwise-not (order-reversing, overflow-free); float DESC
    negates; bool DESC inverts."""
    if not descending:
        return data
    if data.dtype is torch.bool or is_integer(data):
        return ~data
    return -data


def _packed_sort_key(keys, sel) -> Optional[torch.Tensor]:
    """Pack all sort keys (plus the liveness bit) into ONE int64 sort key
    when every key carries bounds metadata proving its bit-width, and the
    total fits 63 bits. keys: (data, validity, desc, nulls_first, bounds)
    where bounds cover the column's whole physical array (dead slots
    included)."""
    total = 1  # liveness bit
    fields = []
    for item in keys:
        if len(item) != 5 or item[4] is None:
            return None
        data, validity, desc, nulls_first, bounds = item
        if data.dtype is not torch.bool and (not is_integer(data) or data.ndim != 1):
            return None
        lo, hi = int(bounds[0]), int(bounds[1])
        if hi < lo:
            return None
        w = max(1, int(hi - lo).bit_length()) + (1 if validity is not None else 0)
        total += w
        fields.append((lo, hi, w))
    if total > 63:
        return None
    acc = (~sel).to(torch.int64)  # MSB field: live rows first
    for item, (lo, hi, w) in zip(keys, fields):
        data, validity, desc, nulls_first, _ = item
        v = data.to(torch.int64) - lo
        if desc:
            v = (hi - lo) - v
        if validity is not None:
            nb = (validity if nulls_first else ~validity).to(torch.int64)
            v = torch.where(validity, v, 0) | (nb << (w - 1))
        acc = (acc << w) | v
    return acc


def sort_permutation(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]],
    sel: torch.Tensor,
) -> torch.Tensor:
    """Stable multi-key sort permutation (int64 indices). Dead rows sink to
    the end. Keys may carry a 5th element (bounds) enabling the single
    packed-int64 key; otherwise successive stable sorts run from the least
    significant key operand to the most significant (the liveness flag)."""
    packed = _packed_sort_key(keys, sel)
    if packed is not None:
        return torch.sort(packed, stable=True).indices
    operands: List[torch.Tensor] = [~sel]  # live rows (False) first
    for data, validity, desc, nulls_first, *_ in keys:
        if validity is not None:
            # ascending bool sort puts False first: nulls_first wants null->False
            operands.append(validity if nulls_first else ~validity)
            # neutralize null payloads so they tie deterministically
            data = torch.where(validity, data, torch.zeros_like(data))
        operands.append(_order_key(data, desc))
    perm = torch.arange(sel.shape[0], dtype=torch.int64, device=sel.device)
    for op in reversed(operands):
        order = torch.sort(_sortable(op)[perm], stable=True).indices
        perm = perm[order]
    return perm


def gather_rows(arrays: Sequence[torch.Tensor], idx: torch.Tensor) -> List[torch.Tensor]:
    """Gather many same-length arrays at one index vector."""
    return [a[idx] for a in arrays]


def sort_rows(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor], bool, bool]],
    payload: Sequence[torch.Tensor],
    sel: torch.Tensor,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable multi-key sort of payloads.

    keys: list of (data, validity_or_None, descending, nulls_first[, bounds]).
    Returns (sorted payload arrays, sorted sel). Dead rows sink to the end.
    """
    perm = sort_permutation(keys, sel)
    gathered = gather_rows(list(payload) + [sel], perm)
    return gathered[:-1], gathered[-1]


def repeat_rows(t: Optional[torch.Tensor], w: int) -> Optional[torch.Tensor]:
    """Each row of t repeated w times in place (repeat_interleave along
    dim 0 by a Python int, as a broadcast and one copy: no host sync)."""
    if t is None:
        return None
    return t.unsqueeze(1).expand((t.shape[0], w) + tuple(t.shape[1:])) \
        .reshape((t.shape[0] * w,) + tuple(t.shape[1:]))


def compaction_order(sel: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving selected rows to the front."""
    return torch.sort(_sortable(~sel), stable=True).indices


def compaction_indices(sel: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices of the first `cap` selected rows ascending, live count as a
    0-d int32 tensor). Entries past the live count point at unselected
    rows -- callers mask with `arange(cap) < total`."""
    perm = compaction_order(sel)
    return perm[:cap], sel.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def segments_from_sorted_keys(
    sorted_keys: Sequence[torch.Tensor],
    sorted_validity: Sequence[Optional[torch.Tensor]],
    sorted_sel: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Given key columns already sorted (live rows first), return
    (segment_ids[int32], is_group_start[bool], num_groups[0-d int32]).
    Dead rows are parked on segment id n-1; callers mask them out via
    sorted_sel."""
    n = sorted_sel.shape[0]
    differs = torch.zeros(n, dtype=torch.bool, device=sorted_sel.device)
    for k, v in zip(sorted_keys, sorted_validity):
        prev = torch.cat([k[:1], k[:-1]])
        d = k != prev
        if v is not None:
            pv = torch.cat([v[:1], v[:-1]])
            d = (d & v & pv) | (v != pv)
        differs = differs | d
    first = torch.zeros(n, dtype=torch.bool, device=sorted_sel.device)
    first[:1] = True
    is_start = sorted_sel & (first | differs)
    seg = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    seg = torch.where(sorted_sel, seg, n - 1)  # park dead rows on last slot
    num_groups = is_start.sum(dtype=torch.int32)
    return seg.to(torch.int32), is_start, num_groups


def segmented_scan(combine, flags: torch.Tensor, leaves: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Inclusive scan of an associative `combine` (two lists of state
    leaves, earlier rows first, to one list) that restarts at every flagged
    row: the reference's associative_scan over (flag, state) with the
    operator (af | bf, where(bf, b, combine(a, b))), as ceil(log2 n)
    Hillis-Steele passes; each pass's temporaries are freed before the
    next."""
    n = flags.shape[0]
    f = flags
    s = 1
    while s < n:
        b = [l[s:] for l in leaves]
        merged = combine([l[:-s] for l in leaves], b)
        bf = f[s:]
        leaves = [torch.cat([l[:s], torch.where(bf, bl, m)])
                  for l, bl, m in zip(leaves, b, merged)]
        f = torch.cat([f[:s], f[:-s] | bf])
        del b, merged, bf
        s *= 2
    return leaves


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Result dtype of a full reduction, as jnp.sum gives it under x64:
    bools and integers narrower than 64 bits widen to int64."""
    if dtype is torch.bool or (not dtype.is_floating_point
                               and dtype not in (torch.int64, torch.uint64)):
        return torch.int64
    return dtype


def _bucketed(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 segment ids with out-of-range ids parked on `num_segments`."""
    seg = seg.to(torch.int64)
    ok = (seg >= 0) & (seg < num_segments)
    return torch.where(ok, seg, num_segments)


def segment_sum(values: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    z = torch.where(mask, values, torch.zeros_like(values))
    if num_segments == 1:
        # global aggregate: a plain reduction, over every row
        return z.sum(dtype=_sum_dtype(z.dtype)).reshape(1)
    out = torch.zeros((num_segments + 1,) + tuple(z.shape[1:]), dtype=z.dtype,
                      device=z.device)
    return out.index_add_(0, _bucketed(seg, num_segments), z)[:num_segments]


def segment_count(seg: torch.Tensor, mask: torch.Tensor, num_segments: int) -> torch.Tensor:
    return segment_sum(mask.to(torch.int64), seg, mask, num_segments)


def _max_ident(dtype: torch.dtype):
    """Identity of min: the dtype's largest value."""
    if dtype is torch.bool:
        return True
    if not dtype.is_floating_point:
        return torch.iinfo(dtype).max
    return float("inf")


def _min_ident(dtype: torch.dtype):
    """Identity of max: the dtype's smallest value."""
    if dtype is torch.bool:
        return False
    if not dtype.is_floating_point:
        return torch.iinfo(dtype).min
    return float("-inf")


def _segment_extreme(values: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                     num_segments: int, is_max: bool) -> torch.Tensor:
    """Masked segment min/max; empty segments hold the identity, NaN
    propagates (as jax.ops.segment_min/max and jnp.min/max). bools reduce as
    uint8."""
    ident = _min_ident(values.dtype) if is_max else _max_ident(values.dtype)
    z = torch.where(mask, values, torch.full_like(values, ident))
    work = z.to(torch.uint8) if z.dtype is torch.bool else z
    if num_segments == 1:
        # global aggregate: a plain reduction, over every row
        out = (work.amax() if is_max else work.amin()).reshape(1)
    else:
        out = torch.full((num_segments + 1,), ident, dtype=work.dtype,
                         device=z.device)
        out = out.scatter_reduce_(0, _bucketed(seg, num_segments), work,
                                  "amax" if is_max else "amin",
                                  include_self=False)[:num_segments]
    return out.to(torch.bool) if z.dtype is torch.bool else out


def segment_min(values: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(values, seg, mask, num_segments, False)


def segment_max(values: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(values, seg, mask, num_segments, True)


# ---------------------------------------------------------------------------
# key canonicalization (exact dense ids for composite / string keys)
# ---------------------------------------------------------------------------


def canonical_ids_two_sided(
    left_keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    right_keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    left_sel: torch.Tensor,
    right_sel: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Identical dense int32 ids for identical composite keys across two
    relations (exact, no hash collisions). SQL join semantics: rows with any
    NULL key, and dead rows, never match; they get id -1.

    Returns (left_ids, right_ids)."""
    nl = left_sel.shape[0]
    datas = []
    joinable = torch.cat([left_sel, right_sel])
    for (lk, lv), (rk, rv) in zip(left_keys, right_keys):
        rk = rk.to(lk.dtype) if rk.dtype != lk.dtype else rk
        datas.append(torch.cat([lk, rk]))
        if lv is not None or rv is not None:
            lvv = lv if lv is not None else torch.ones_like(left_sel)
            rvv = rv if rv is not None else torch.ones_like(right_sel)
            joinable = joinable & torch.cat([lvv, rvv])
    # stable sort by (not joinable, keys...): unjoinable rows sink
    perm = sort_permutation([(d, None, False, False) for d in datas], joinable)
    sorted_joinable = joinable[perm]
    seg, _, _ = segments_from_sorted_keys([d[perm] for d in datas],
                                          [None] * len(datas), sorted_joinable)
    seg = torch.where(sorted_joinable, seg, -1)
    ids = torch.empty_like(seg)
    ids[perm] = seg  # perm is a permutation: every slot written once
    return ids[:nl], ids[nl:]


# ---------------------------------------------------------------------------
# searchsorted-based equi-join core
# ---------------------------------------------------------------------------


def pack_join_keys(
    keys: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    sel: torch.Tensor,
) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Composite integer keys as one int64 id without sorting: one integer
    key of any width, or two 32-bit-safe integer keys packed as
    (a + 2^31) * 2^32 + (b + 2^31). Returns (ids, live) or None."""
    live = sel
    for data, validity in keys:
        if not is_integer(data):
            return None
        if validity is not None:
            live = live & validity
    if len(keys) == 1:
        return keys[0][0].to(torch.int64), live
    if len(keys) == 2 and all(k[0].element_size() <= 4 for k in keys):
        a = keys[0][0].to(torch.int64) + (1 << 31)
        b = keys[1][0].to(torch.int64) + (1 << 31)
        return a * (1 << 32) + b, live
    return None


def sorted_live_ranks(keys: torch.Tensor, live: torch.Tensor):
    """Sort `keys` with dead rows after every live one, and count liveness
    beside the key order. Returns (perm, sorted_keys, live_before):
      perm         -- row indices, live rows first, each part stably by key
                      (the reference's stable sort by (dead, key));
      sorted_keys  -- every row's key, ascending (live and dead mixed);
      live_before  -- int64 [n + 1]: live rows among the first i of
                      sorted_keys.
    The live rows with key < q are then live_before[searchsorted(
    sorted_keys, q)], and they are perm[:that] among the live prefix: no key
    value stands for "dead", so the whole int64 domain stays usable."""
    order = torch.sort(keys, stable=True).indices
    live_s = live[order].to(torch.int64)
    cum = torch.cumsum(live_s, 0)
    live_before = torch.cat([cum.new_zeros(1), cum])
    n_live = live_before[-1]
    before = cum - live_s
    dead_before = torch.arange(keys.shape[0], device=keys.device) - before
    dest = torch.where(live_s > 0, before, n_live + dead_before)
    perm = torch.empty_like(order)
    perm[dest] = order  # dest is a permutation: every slot written once
    return perm, keys[order], live_before


def join_match_counts(
    build_ids: torch.Tensor,
    build_live: torch.Tensor,
    probe_ids: torch.Tensor,
    probe_live: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 1 of the equi-join: sort the build side by id, locate each
    probe's match run with torch.searchsorted.

    ids are int64 over the full domain; dead/NULL rows are excluded by the
    live masks, never by a sentinel id. Returns (perm, lo, cnt, total):
      perm:   build row indices sorted by id, live rows first;
      lo[i]:  first position in perm matching probe row i;
      cnt[i]: number of matches of probe row i (0 for dead/NULL probes);
      total:  sum(cnt), a 0-d int64 tensor (on the device)."""
    perm, skeys, live_before = sorted_live_ranks(build_ids.to(torch.int64),
                                                 build_live)
    q = probe_ids.to(torch.int64).contiguous()
    lo = live_before[torch.searchsorted(skeys, q, right=False)]
    hi = live_before[torch.searchsorted(skeys, q, right=True)]
    cnt = torch.where(probe_live, hi - lo, 0).to(torch.int32)
    return perm, lo, cnt, cnt.sum(dtype=torch.int64)


def join_match_counts_small(
    build_ids: torch.Tensor,
    build_live: torch.Tensor,
    probe_ids: torch.Tensor,
    probe_live: torch.Tensor,
    domain: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """join_match_counts for ids in a proven dense domain [0, domain). The
    reference packs liveness into the key there to get single-key TPU
    sorts; with searchsorted the general path already sorts one key, so
    this only clamps the ids of dead rows (padding garbage) into the
    domain. Same contract."""
    bid = torch.clamp(build_ids.to(torch.int64), 0, domain - 1)
    pid = torch.clamp(probe_ids.to(torch.int64), 0, domain - 1)
    return join_match_counts(bid, build_live, pid, probe_live)


def join_expand(
    perm: torch.Tensor,
    lo: torch.Tensor,
    cnt: torch.Tensor,
    out_capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase 2: (probe_row, build_row, out_valid) for each output slot.
    Slot j belongs to probe row p where offsets[p] <= j < offsets[p] +
    cnt[p] (offsets: exclusive prefix sum of cnt), found by searchsorted;
    slots are ordered by probe row, then by the build rows' order in perm."""
    j = torch.arange(out_capacity, dtype=torch.int64, device=cnt.device)
    n, nb = cnt.shape[0], perm.shape[0]
    c64 = cnt.to(torch.int64)
    ends = torch.cumsum(c64, 0)
    offsets = ends - c64
    probe_row = torch.clamp(torch.searchsorted(offsets, j, right=True) - 1, 0, n - 1)
    match_idx = j - offsets[probe_row]
    out_valid = j < ends[-1]
    pos = torch.clamp(lo[probe_row].to(torch.int64) + match_idx, 0, nb - 1)
    return probe_row, perm[pos], out_valid
