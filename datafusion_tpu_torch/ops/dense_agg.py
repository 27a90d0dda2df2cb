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
handles a ragged tail and a misaligned head.

Everything the kernel's launch depends on apart from the card is decided
here, in plain Python the CPU tests reach: which pairs are distinct
(`distinct_pairs`), which route and launch geometry (`launch_plan`), and
which rows the kernel reads with 16-byte loads (`vector_span`).
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

SOURCE = "dense_groupby_sums.cu"
ROUTES = ("registers", "shared", "global")  # csrc ROUTE_* order
MAX_PAIRS = 16  # csrc DGS_MAX_PAIRS
# csrc dgs_registers<G_MAX, P> instantiations (P: the exact number of
# distinct pairs), in the order of its kVariants
REGISTER_SHAPES = (tuple((1, p) for p in range(MAX_PAIRS + 1))
                   + tuple((8, p) for p in range(9)))
RUN = 4  # rows a thread takes per vector step (csrc DGS_RUN)
THREADS = 256  # block size of the register and global routes
SHARED_BYTES_MAX = 227 * 1024  # opt-in shared memory of one block on Hopper
SHARED_MIN_WARPS = 4  # fewer warp tables per block than this: global route

Pairs = Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]]

# Kernel launches since the last reset (the plain version never counts).
launches = 0

_FACTOR_DTYPES = (torch.int32, torch.int64)
_lib = None
_blocks_per_sm: Dict[tuple, int] = {}
_sm_count: Dict[int, int] = {}


class LaunchPlan(NamedTuple):
    route: str  # one of ROUTES
    variant: int  # index into REGISTER_SHAPES; -1 on the other routes
    threads: int
    smem_bytes: int  # dynamic shared memory of one block
    grid: int


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel():
    global _lib
    if _lib is None:
        from . import cuda_build

        _lib = bind(cuda_build.load(SOURCE))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a library built from csrc/dense_groupby_sums.cu
    and checks that it agrees with this module's constants."""
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.dense_groupby_sums_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptrs,
        ints, ptrs, ints, ctypes.POINTER(ctypes.c_uint), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.dense_groupby_sums_launch.restype = ctypes.c_int
    lib.dense_groupby_sums_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.dense_groupby_sums_blocks_per_sm.restype = ctypes.c_int
    lib.dense_groupby_sums_register_shapes.argtypes = [ints, ints, ctypes.c_int]
    lib.dense_groupby_sums_register_shapes.restype = ctypes.c_int
    for fn in (lib.dense_groupby_sums_max_pairs, lib.dense_groupby_sums_run_rows):
        fn.argtypes, fn.restype = [], ctypes.c_int
    cap = len(REGISTER_SHAPES)
    g_max, pairs = (ctypes.c_int * cap)(), (ctypes.c_int * cap)()
    count = lib.dense_groupby_sums_register_shapes(g_max, pairs, cap)
    shapes = tuple((g_max[v], pairs[v]) for v in range(min(count, cap)))
    if (shapes != REGISTER_SHAPES or lib.dense_groupby_sums_max_pairs() != MAX_PAIRS
            or lib.dense_groupby_sums_run_rows() != RUN):
        raise RuntimeError(f"{SOURCE} and ops/dense_agg.py disagree: register "
                           f"shapes {shapes}, max pairs, or rows per step")
    return lib


def distinct_pairs(pairs: Pairs) -> Tuple[List[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                                          List[int]]:
    """The distinct factor pairs (the same columns in the same order, as Q1's
    sum(x) and avg(x) give) and, for each, the bit mask of the output columns
    its sum goes to."""
    seen: Dict[tuple, int] = {}
    unique, cols = [], []
    for k, (a, b) in enumerate(pairs):
        key = (a.data_ptr(), a.dtype, a.shape,
               None if b is None else (b.data_ptr(), b.dtype, b.shape))
        u = seen.setdefault(key, len(unique))
        if u == len(unique):
            unique.append((a, b))
            cols.append(0)
        cols[u] |= 1 << k
    return unique, cols


def launch_plan(G: int, n_pairs: int, n: int, sm_count: int,
                blocks_per_sm: Callable[[str, int, int, int], int]) -> LaunchPlan:
    """Route and launch geometry of one call over n rows, G groups and
    n_pairs distinct pairs. blocks_per_sm(route, variant, threads,
    smem_bytes) is the resident blocks per SM the kernel reaches (the
    library asks the CUDA occupancy calculator); the grid is one wave of it,
    or fewer blocks when n is small.

    - registers: G = 1, or G <= 8 with <= 8 pairs; the REGISTER_SHAPES
      entry of G_MAX 1 or 8 and exactly n_pairs pairs.
    - shared: a [G, n_pairs + 1] uint64 table per warp, with as many warps
      (up to 8) as fit in SHARED_BYTES_MAX, and at least SHARED_MIN_WARPS.
    - global: everything larger (up to the dense limit, G = 16384)."""
    if G < 1 or not 0 <= n_pairs <= MAX_PAIRS:
        raise ValueError(f"dense_groupby_sums: no plan for G={G}, "
                         f"{n_pairs} pairs")
    route, variant, threads, smem = "global", -1, THREADS, 0
    shape = (1 if G == 1 else 8, n_pairs)
    if G <= 8 and shape in REGISTER_SHAPES:
        route, variant = "registers", REGISTER_SHAPES.index(shape)
    else:
        table = G * (n_pairs + 1) * 8
        warps = min(THREADS // 32, SHARED_BYTES_MAX // table)
        if warps >= SHARED_MIN_WARPS:
            route, threads, smem = "shared", 32 * warps, warps * table
    per_sm = blocks_per_sm(route, variant, threads, smem)
    if per_sm < 1:
        raise RuntimeError(f"dense_groupby_sums: the {route} route cannot "
                           f"run {threads} threads with {smem} B of shared "
                           f"memory ({per_sm})")
    steps = math.ceil(max(n, 1) / RUN)
    grid = max(1, min(sm_count * per_sm, math.ceil(steps / threads)))
    return LaunchPlan(route, variant, threads, smem, grid)


def kernel_route(G: int, n_pairs: int) -> str:
    """Which of the kernel's routes a launch with G groups and n_pairs
    distinct pairs takes."""
    return launch_plan(G, n_pairs, 1, 1, lambda *_: 1).route


def vector_span(n: int, seg_ptr: int, mask_ptr: int,
                factors: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Rows [head, tail) that the kernel reads with vector loads: from the
    first row h < RUN at which seg is 16-byte aligned, the mask 4-byte
    aligned and every factor (address, item size) aligned to two items, in
    whole steps of RUN rows. Rows outside it take the kernel's scalar loop;
    when no row aligns them all (views at different offsets), that is every
    row: (n, n)."""
    for h in range(min(RUN, n + 1)):
        if ((seg_ptr + 4 * h) % 16 == 0 and (mask_ptr + h) % 4 == 0
                and all((p + s * h) % (2 * s) == 0 for p, s in factors)):
            return h, h + (n - h) // RUN * RUN
    return n, n


def dense_groupby_sums_plain(
    seg: torch.Tensor,
    mask: torch.Tensor,
    pairs: Pairs,
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


def card_plan(seg: torch.Tensor, G: int, n_pairs: int) -> LaunchPlan:
    """launch_plan for a call on seg's card: its SM count and the kernel's
    occupancy there (both asked once per card and kept)."""
    idx = seg.device.index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count

    def blocks_per_sm(route: str, variant: int, threads: int, smem: int) -> int:
        key = (idx, route, variant, threads, smem)
        if key not in _blocks_per_sm:
            with torch.cuda.device(idx):
                _blocks_per_sm[key] = _kernel().dense_groupby_sums_blocks_per_sm(
                    ROUTES.index(route), variant, threads, smem)
        return _blocks_per_sm[key]

    return launch_plan(G, n_pairs, int(seg.shape[0]), _sm_count[idx],
                       blocks_per_sm)


def dense_groupby_sums(
    seg: torch.Tensor,   # [N] int32 dense group ids (out-of-range = dropped)
    mask: torch.Tensor,  # [N] bool live rows
    pairs: Pairs,        # (a, b) factor columns; b=None -> 1
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
    n_pairs = len(pairs)
    if G < 1:
        raise ValueError(f"dense_groupby_sums: G must be >= 1, got {G}")
    if n_pairs > MAX_PAIRS:
        raise ValueError(f"dense_groupby_sums: {n_pairs} factor pairs exceed "
                         f"the kernel's {MAX_PAIRS}")
    _check("seg", seg, n, seg.device, (torch.int32,))
    _check("mask", mask, n, seg.device, (torch.bool,))
    for k, (a, b) in enumerate(pairs):
        _check(f"a[{k}]", a, n, seg.device, _FACTOR_DTYPES)
        if b is not None:
            _check(f"b[{k}]", b, n, seg.device, _FACTOR_DTYPES)
    lib = _kernel()
    unique, out_cols = distinct_pairs(pairs)
    plan = card_plan(seg, G, len(unique))
    size = max(len(unique), 1)
    a_ptr, b_ptr = (ctypes.c_void_p * size)(), (ctypes.c_void_p * size)()
    a_bytes, b_bytes = (ctypes.c_int * size)(), (ctypes.c_int * size)()
    cols = (ctypes.c_uint * size)(*out_cols)
    factors = []
    for u, (a, b) in enumerate(unique):
        a_ptr[u], a_bytes[u] = a.data_ptr(), a.element_size()
        factors.append((a.data_ptr(), a.element_size()))
        if b is not None:
            b_ptr[u], b_bytes[u] = b.data_ptr(), b.element_size()
            factors.append((b.data_ptr(), b.element_size()))
    head, tail = vector_span(n, seg.data_ptr(), mask.data_ptr(), factors)
    out = torch.zeros((G, n_pairs + 1), dtype=torch.int64, device=seg.device)
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    err = lib.dense_groupby_sums_launch(
        seg.data_ptr(), mask.data_ptr(), n, head, tail, G, n_pairs,
        len(unique), a_ptr, a_bytes, b_ptr, b_bytes, cols, out.data_ptr(),
        ROUTES.index(plan.route), plan.variant, plan.grid, plan.threads,
        plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"dense_groupby_sums kernel launch failed: CUDA "
                           f"error {err} ({plan})")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1  # a captured launch runs on each replay, uncounted
    sums = out[:, :n_pairs] if n_pairs else torch.zeros(
        (G, 1), dtype=torch.int64, device=seg.device)
    return sums, out[:, n_pairs]
