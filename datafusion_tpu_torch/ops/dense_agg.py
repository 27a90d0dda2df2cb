"""Exact 64-bit grouped product sums: the dense aggregation kernel.

Port of datafusion_tpu/ops/pallas_agg.py. `dense_groupby_sums` fuses every
sum/avg/count of a dense small-G group-by (and of a global aggregate, G = 1)
into one pass that reads each input column once: for each live row with
0 <= seg < G it adds a_i * b_i to sums[seg, i] and 1 to counts[seg], exactly,
wrapping mod 2^64.

On a CUDA tensor it launches the hand-written Hopper kernel in
csrc/dense_groupby_sums.cu, or raises; on a CPU tensor it runs the plain
PyTorch version below, which is also what the card's kernel is held against.
The TPU version's 32-bit-lane limb arithmetic and its N % 2048 precondition
have no counterpart here: the card multiplies int64 natively and the kernel
handles a ragged tail.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

SOURCE = "dense_groupby_sums.cu"
ROUTES = ("one_group", "shared", "global")  # csrc ROUTE_* order

# Kernel launches since the last reset (the plain version never counts).
launches = 0

_FACTOR_DTYPES = (torch.int32, torch.int64)
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _lib
    if _lib is None:
        from . import cuda_build

        lib = cuda_build.load(SOURCE)
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.dense_groupby_sums_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ptrs, ints, ptrs, ints, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.dense_groupby_sums_launch.restype = ctypes.c_int
        lib.dense_groupby_sums_route.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.dense_groupby_sums_route.restype = ctypes.c_int
        lib.dense_groupby_sums_max_pairs.argtypes = []
        lib.dense_groupby_sums_max_pairs.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_route(G: int, n_pairs: int) -> str:
    """Which of the kernel's three routes a launch of this size takes."""
    return ROUTES[_kernel().dense_groupby_sums_route(int(G), int(n_pairs))]


def dense_groupby_sums_plain(
    seg: torch.Tensor,
    mask: torch.Tensor,
    pairs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    G: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: one int64 index_add_ of the product matrix,
    with dead and out-of-range rows sent to an extra bucket G that is sliced
    off (index_add_ would raise on them on the CPU and write out of bounds on
    the card)."""
    n = seg.shape[0]
    live = mask & (seg >= 0) & (seg < G)
    bucket = torch.where(live, seg.to(torch.int64), G)
    cols = [a.to(torch.int64) * (1 if b is None else b.to(torch.int64))
            for a, b in pairs]
    ones = torch.ones(n, dtype=torch.int64, device=seg.device)
    vals = torch.stack(cols + [ones], dim=1)
    out = torch.zeros((G + 1, len(cols) + 1), dtype=torch.int64,
                      device=seg.device).index_add_(0, bucket, vals)[:G]
    sums = out[:, :-1] if cols else torch.zeros(
        (G, 1), dtype=torch.int64, device=seg.device)
    return sums, out[:, -1]


def _check(name: str, t: torch.Tensor, n: int, device, dtypes) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, seg on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}")
    if t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [{n}] tensor, got "
                         f"shape {tuple(t.shape)}")


def dense_groupby_sums(
    seg: torch.Tensor,   # [N] int32 dense group ids (out-of-range = dropped)
    mask: torch.Tensor,  # [N] bool live rows
    pairs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],  # b=None -> 1
    G: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sums of a_i * b_i per group plus group counts.

    Returns (sums[G, n_pairs] int64, counts[G] int64); with no pairs, sums is
    [G, 1] of zeros. Factors are int32 or int64 (on the card); a CPU `seg`
    takes the plain version, a CUDA `seg` launches the kernel or raises."""
    global launches
    if seg.device.type == "cpu":
        return dense_groupby_sums_plain(seg, mask, pairs, G)
    if seg.device.type != "cuda":
        raise ValueError(f"dense_groupby_sums: no kernel for {seg.device}")
    G = int(G)
    n = int(seg.shape[0])
    if G < 1:
        raise ValueError(f"dense_groupby_sums: G must be >= 1, got {G}")
    _check("seg", seg, n, seg.device, (torch.int32,))
    _check("mask", mask, n, seg.device, (torch.bool,))
    lib = _kernel()
    n_pairs = len(pairs)
    if n_pairs > lib.dense_groupby_sums_max_pairs():
        raise ValueError(f"dense_groupby_sums: {n_pairs} factor pairs exceed "
                         f"the kernel's {lib.dense_groupby_sums_max_pairs()}")
    a_ptr = (ctypes.c_void_p * max(n_pairs, 1))()
    b_ptr = (ctypes.c_void_p * max(n_pairs, 1))()
    a_bytes = (ctypes.c_int * max(n_pairs, 1))()
    b_bytes = (ctypes.c_int * max(n_pairs, 1))()
    for k, (a, b) in enumerate(pairs):
        _check(f"a[{k}]", a, n, seg.device, _FACTOR_DTYPES)
        a_ptr[k], a_bytes[k] = a.data_ptr(), a.element_size()
        if b is not None:
            _check(f"b[{k}]", b, n, seg.device, _FACTOR_DTYPES)
            b_ptr[k], b_bytes[k] = b.data_ptr(), b.element_size()
    out = torch.zeros((G, n_pairs + 1), dtype=torch.int64, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = lib.dense_groupby_sums_launch(
        seg.data_ptr(), mask.data_ptr(), n, G, n_pairs, a_ptr, a_bytes, b_ptr,
        b_bytes, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense_groupby_sums kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    sums = out[:, :n_pairs] if n_pairs else torch.zeros(
        (G, 1), dtype=torch.int64, device=seg.device)
    return sums, out[:, n_pairs]
