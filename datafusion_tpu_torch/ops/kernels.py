"""Core vectorized building blocks shared by the physical operators.

Port of the single-device subset of datafusion_tpu/ops/kernels.py to torch
ops:

* `sort_rows` / `sort_permutation` -- multi-key stable sort with ASC/DESC,
  NULLS FIRST/LAST and dead-row (sel=False) sinking;
* `compaction_indices` -- the first `cap` live row indices, ascending;
* masked segment reductions over dense group ids.

Every sort is stable (`torch.sort(..., stable=True)`), as every reference
sort is. Segment ids at or beyond the segment count are dropped, as
`jax.ops.segment_sum` drops them: torch's `index_add_` would raise on them
(CPU) or write out of bounds (CUDA), so they are routed to one extra bucket
that is sliced off.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..data.device import is_integer


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
