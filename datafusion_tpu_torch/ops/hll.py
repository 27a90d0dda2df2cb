"""HyperLogLog sketch for approx_distinct.

Port of datafusion_tpu/ops/hll.py (reference: functions-aggregate/src/
approx_distinct.rs + hyperloglog.rs). One aggregation over G groups keeps a
dense [G, M] int32 register plane: updating it is one scatter-max, merging
sketches across shards is an elementwise max (parallel/distributed.pmax),
and estimating is a harmonic mean per row.

The sketch is opt-in (`execution.approx_distinct_hll`) and is used only by
the distributed engine's Partial/Final split (parallel/aggsplit.py); the
default approx_distinct stays the exact sorted-run count. The estimate
depends only on the set of values, so meshes of any size agree bit for bit.
Hashes are ops/kernels.hash64's uint64 bit patterns held in int64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

P_BITS = 12           # 2^12 = 4096 registers: ~1.6% standard error
M = 1 << P_BITS
_ALPHA = 0.7213 / (1.0 + 1.079 / M)  # bias constant for m >= 128
_WINDOW = (1 << (64 - P_BITS)) - 1   # the hash bits above the bucket


def build_registers(hashes: torch.Tensor, seg: torch.Tensor, mask: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """[num_groups, M] int32 register plane from 64-bit value hashes.

    bucket = the low P_BITS of the hash; rho = the leading-zero count of the
    remaining 64 - P_BITS bits, plus one, from an exact float64 log2 (the
    window is below 2^52, so its conversion is exact). The window is the
    logical shift `h >> P_BITS`: the arithmetic shift's sign bits are masked
    off."""
    bucket = (hashes & (M - 1)).to(torch.int64)
    w = ((hashes >> P_BITS) & _WINDOW).to(torch.float64)
    nbits = 64 - P_BITS
    bitlen = torch.where(w > 0, torch.floor(torch.log2(torch.clamp(w, min=1.0))) + 1.0,
                         torch.zeros_like(w))
    rho = (nbits - bitlen + 1.0).to(torch.int32)
    rho = torch.where(mask, rho, 0)
    # dead rows (and ids past the plane) go to row num_groups, cut off below
    g = torch.where(mask & (seg >= 0) & (seg < num_groups), seg.to(torch.int64),
                    num_groups)
    regs = torch.zeros((num_groups + 1) * M, dtype=torch.int32, device=hashes.device)
    regs.scatter_reduce_(0, g * M + bucket, rho, "amax")
    return regs.reshape(num_groups + 1, M)[:num_groups]


def merge_registers(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def estimate(regs: torch.Tensor) -> torch.Tensor:
    """Per-group cardinality estimate (int64) with the small-range
    linear-counting correction (reference: hyperloglog.rs count())."""
    regs_f = regs.to(torch.float64)
    inv_sum = torch.exp2(-regs_f).sum(1)
    raw = _ALPHA * M * M / inv_sum
    zeros = (regs == 0).to(torch.float64).sum(1)
    linear = M * torch.log(M / torch.clamp(zeros, min=1.0))
    use_linear = (raw <= 2.5 * M) & (zeros > 0)
    est = torch.where(use_linear, linear, raw)
    return torch.round(est).to(torch.int64)


def hashes_for_column(col) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Value hashes and validity of a DeviceColumn (dictionary codes hash as
    codes: distinct codes are distinct strings in a sorted dictionary)."""
    from . import kernels as K

    return K.hash64([col.data]), col.validity
