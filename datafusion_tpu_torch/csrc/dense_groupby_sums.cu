// Fused exact 64-bit grouped product sums for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel datafusion_tpu/ops/pallas_agg.py::dense_groupby_sums
// (kernel body `_kernel` at line 116, `pl.pallas_call` at line 200).
//
// What it computes: one pass over N rows. For every live row whose dense group
// id g = seg[i] lies in [0, G), it adds a_u[i] * b_u[i] to sums[g, u] for each
// distinct factor pair u (a null b_u means 1) and adds 1 to counts[g]. Sums
// are exact and wrap mod 2^64, as the reference's int64 arithmetic does.
// The wrapper (ops/dense_agg.py) merges repeated pairs (Q1 asks for
// sum(l_quantity) and avg(l_quantity)): out_cols[u] names every output column
// that pair u's sum goes to.
//
// What bounds it on the card: bytes. Each row is read once -- 4 B of seg, 1 B
// of mask and 4 or 8 B of each factor column at live rows -- and costs a few
// integer adds per (group, pair) cell, below the card's integer rate. At
// TPC-H Q1's shape (N = 2^23, G = 6, 5 distinct pairs over 6 int64 columns,
// 6.0M live rows) that is 330 MB, 0.098 ms at 3.35 TB/s.
//
// What held the first design back (kept in csrc/baseline/ so that
// chip_smoke.py can time it beside this one; NVIDIA H100 80GB HBM3, 700 W,
// cold L2: 0.885 ms at Q1's shape, 9.0x the bound):
//  1. Every live row issued n_pairs + 1 64-bit atomicAdds on a shared-memory
//     table of G rows. Hopper has no native 64-bit shared add: cuobjdump
//     -sass shows each as an ATOMS.CAST.SPIN.64 compare-and-swap loop, and
//     at G = 6 the 32 lanes of a warp land on at most 6 rows, so most lanes
//     retry.
//  2. Too few bytes in flight: one row per thread per step, a 1-byte mask
//     load whose test had to finish before the seg load was issued, and a
//     grid capped at 8 blocks of 256 threads per SM. Even its G = 1 route,
//     which had no shared atomics, ran at 4.5x its bound at Q6's shape.
//
// This design has three routes; the wrapper picks one, with the grid and the
// dynamic shared memory (launch_plan in ops/dense_agg.py):
//  - ROUTE_REGISTERS, small tables (G = 1, or G <= 8 with <= 8 pairs):
//    every thread keeps acc[G_MAX][P] sums and G_MAX counts in registers,
//    one instantiation per G_MAX (1 or 8) and exact number of distinct
//    pairs P, so that no test of the pair count is left in the row loop. A
//    row updates them with compile-time-unrolled predicated adds
//    (`if (g == j) acc[j][k] += x[k]`): no atomic and no runtime index into
//    a register array (which would go to local memory). At the end each
//    cell is summed across the warp with shuffles, across the warps of the
//    block through shared memory, and added to the output with one global
//    atomic per nonzero cell per block (a native RED). __launch_bounds__
//    with one block per SM lets ptxas take the registers it needs: without
//    it, it capped some instantiations at 128 and spilled.
//  - ROUTE_SHARED, tables that fit in shared memory at least 4 times: each
//    warp owns a private table in opt-in dynamic shared memory (up to
//    227 KB a block). Before touching it, a warp merges the rows of one step
//    that share a group (__match_any_sync, then a shuffle tree over the
//    peers), so one leader lane per group adds with a plain read-modify-write:
//    no two lanes, and no two warps, ever write one address. The warp tables
//    are summed and added to the output as in the register route.
//  - ROUTE_GLOBAL, the largest G (up to the dense limit of 16384): the same
//    warp merge, then the leader adds to the output with global atomics.
// Bytes in flight: a thread takes DGS_RUN = 4 consecutive rows per step, seg
// as one 16-byte int4 and the mask as one 4-byte word, fetched AHEAD steps
// early, so no test waits on a load. Factors follow in pairs of rows, as
// 16-byte longlong2 (int64) or 8-byte int2 (int32) loads, all issued before
// the first product, and only for pairs of rows of which one is live: the
// 98% dead rows of Q6 cost their seg and mask bytes only. Where registers
// allow (Q1's 6 x 5 table does), the register route issues the loads of a
// pair of rows before it adds the previous pair, so its 8 warps a SM rarely
// wait on a load they have just issued. The grid is one
// full wave at the occupancy the register count allows (the wrapper asks
// dense_groupby_sums_blocks_per_sm). A head of up to 3 rows before the
// first 16-byte-aligned seg (a view at an offset), the ragged tail, and any
// input whose columns cannot all be aligned at one row go through a scalar
// loop in the same kernel.
//
// Integer addition commutes, so every route is bit-exact and the same on
// every run, whatever order the atomics land in.
#include <cuda_runtime.h>
#include <stdint.h>

#define DGS_MAX_PAIRS 16
#define DGS_RUN 4
#define DGS_THREADS_MAX 256
#define DGS_SHARED_MAX (227 * 1024)

typedef unsigned long long u64;

// Route order of ROUTES in ops/dense_agg.py.
enum { ROUTE_REGISTERS = 0, ROUTE_SHARED = 1, ROUTE_GLOBAL = 2 };

struct Args {
  const int* seg;
  const unsigned char* mask;
  long long n;
  // rows [head, tail) are read in steps of DGS_RUN with vector loads (seg at
  // row head is 16-byte aligned); the others go through the scalar loop
  long long head, tail;
  int G, n_unique;
  int width;  // output columns: n_pairs + 1, the last one the counts
  const void* a[DGS_MAX_PAIRS];
  const void* b[DGS_MAX_PAIRS];
  int a_bytes[DGS_MAX_PAIRS];  // 4 = int32, 8 = int64
  int b_bytes[DGS_MAX_PAIRS];  // 0 = b is 1
  // output columns (bit mask) of distinct pair u; entry n_unique: the counts
  unsigned out_cols[DGS_MAX_PAIRS + 1];
  u64* out;  // [G, width], zeroed by the caller
};

__device__ __forceinline__ int group_of(int s, unsigned live, int G) {
  return live && (unsigned)s < (unsigned)G ? s : -1;
}

// sign-extend, then reinterpret: unsigned products wrap exactly as the
// two's-complement int64 product does, without signed-overflow UB
__device__ __forceinline__ u64 load1(const void* p, int bytes, long long i) {
  return bytes == 8 ? (u64)__ldg(static_cast<const long long*>(p) + i)
                    : (u64)(long long)__ldg(static_cast<const int*>(p) + i);
}

// rows i and i + 1; i - head is even, so the address is 16-byte (int64) or
// 8-byte (int32) aligned
__device__ __forceinline__ void load2(const void* p, int bytes, long long i,
                                      u64& v0, u64& v1) {
  if (bytes == 8) {
    const longlong2 t = __ldg(
        reinterpret_cast<const longlong2*>(static_cast<const long long*>(p) + i));
    v0 = (u64)t.x;
    v1 = (u64)t.y;
  } else {
    const int2 t =
        __ldg(reinterpret_cast<const int2*>(static_cast<const int*>(p) + i));
    v0 = (u64)(long long)t.x;
    v1 = (u64)(long long)t.y;
  }
}

// The products of the first U <= P pairs at one row (the rest are 0).
template <int P>
__device__ __forceinline__ void products1(const Args& p, int U, long long i,
                                          u64 (&x)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    x[k] = 0;
    if (k < U) {
      const u64 a = load1(p.a[k], p.a_bytes[k], i);
      x[k] = p.b_bytes[k] ? a * load1(p.b[k], p.b_bytes[k], i) : a;
    }
  }
}

// seg and mask of vector step r (4 rows), or 4 dead rows past the end
__device__ __forceinline__ void fetch(const int4* seg4, const unsigned* mask4,
                                      long long r, long long runs, int4& s,
                                      unsigned& m) {
  if (r < runs) {
    s = __ldg(seg4 + r);
    m = __ldg(mask4 + r);
  } else {
    s = make_int4(-1, -1, -1, -1);
    m = 0;
  }
}

__device__ __forceinline__ void classify(int4 s, unsigned m, int G,
                                         int (&g)[DGS_RUN]) {
  g[0] = group_of(s.x, m & 0xffu, G);
  g[1] = group_of(s.y, (m >> 8) & 0xffu, G);
  g[2] = group_of(s.z, (m >> 16) & 0xffu, G);
  g[3] = group_of(s.w, m >> 24, G);
}

__device__ __forceinline__ u64 warp_sum(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void add_cols(u64* row, unsigned cols, u64 v) {
  for (; cols; cols &= cols - 1) atomicAdd(row + (__ffs(cols) - 1), v);
}

// Adds v, the block's total of cell (g, u), to the output columns of u
// (u == n_unique: the count). The select loop keeps the index into the
// parameter array at compile time.
__device__ __forceinline__ void add_to_output(const Args& p, int g, int u,
                                              u64 v) {
  if (v == 0) return;
  unsigned cols = 0;
#pragma unroll
  for (int q = 0; q <= DGS_MAX_PAIRS; ++q)
    if (q == u) cols = p.out_cols[q];
  add_cols(p.out + (long long)g * p.width, cols, v);
}

// The raw factors of one pair of rows, and their groups (-1: dead).
template <int PA>
struct RowPair {
  u64 a[2][PA], b[2][PA];
  int g[2];
};

// Issues the factor loads of the first U <= PA pairs at rows i, i + 1
// (nothing if both rows are dead; i - head is even, so every load is
// aligned).
template <int PA>
__device__ __forceinline__ void load_pair(const Args& p, int U, long long i,
                                          int g0, int g1, RowPair<PA>& f) {
  f.g[0] = g0;
  f.g[1] = g1;
  if ((g0 & g1) < 0) return;
#pragma unroll
  for (int k = 0; k < PA; ++k) {
    if (k >= U) break;
    load2(p.a[k], p.a_bytes[k], i, f.a[0][k], f.a[1][k]);
    f.b[0][k] = f.b[1][k] = 1;
    if (p.b_bytes[k]) load2(p.b[k], p.b_bytes[k], i, f.b[0][k], f.b[1][k]);
  }
}

// ---------------------------------------------------------------------------
// ROUTE_REGISTERS
// ---------------------------------------------------------------------------

// One row of group g (-1: dead) into the thread's registers. Both loops are
// unrolled, so every index into acc and cnt is a compile-time constant; P is
// the exact number of distinct pairs, so the pair loop has no test, and the
// runtime G only cuts the group loop short.
template <int GM, int P, int PA>
__device__ __forceinline__ void add_row(u64 (&acc)[GM][PA], unsigned (&cnt)[GM],
                                        int G, int g, const u64 (&x)[PA]) {
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    if (j >= G) break;
    const bool hit = g == j;
    cnt[j] += hit;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (hit) acc[j][k] += x[k];
  }
}

template <int GM, int P, int PA>
__device__ __forceinline__ void add_pair(u64 (&acc)[GM][PA], unsigned (&cnt)[GM],
                                         int G, const RowPair<PA>& f) {
  if ((f.g[0] & f.g[1]) < 0) return;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    u64 x[PA];
#pragma unroll
    for (int k = 0; k < PA; ++k) x[k] = k < P ? f.a[t][k] * f.b[t][k] : 0;
    add_row<GM, P, PA>(acc, cnt, G, f.g[t], x);
  }
}

// G <= GM groups and exactly P distinct pairs. Where the registers allow
// two pairs of rows in flight next to the GM x P sums, the loads of one
// pair of rows go out before the previous pair is added (buffers A and B
// take turns), so a warp never waits on a factor load it has just issued;
// else each pair of rows is loaded, then added.
template <int GM, int P>
__global__ void __launch_bounds__(DGS_THREADS_MAX, 1)
dgs_registers(const Args p) {
  constexpr int PA = P > 0 ? P : 1;
  constexpr bool DEFER = 2 * GM * P + 16 * P <= 176;
  constexpr int AHEAD = GM * P <= 2 ? 3 : 2;  // steps of seg/mask in flight
  u64 acc[GM][PA];
  unsigned cnt[GM];
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    cnt[j] = 0;
#pragma unroll
    for (int k = 0; k < PA; ++k) acc[j][k] = 0;
  }
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;

  for (int part = 0; part < 2; ++part) {  // scalar head, then scalar tail
    const long long lo = part ? p.tail : 0, hi = part ? p.n : p.head;
    for (long long i = lo + tid; i < hi; i += nthreads) {
      const int g = group_of(p.seg[i], p.mask[i], p.G);
      if (g < 0) continue;
      u64 x[PA];
      products1<PA>(p, P, i, x);
      add_row<GM, P, PA>(acc, cnt, p.G, g, x);
    }
  }

  const int4* seg4 = reinterpret_cast<const int4*>(p.seg + p.head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(p.mask + p.head);
  const long long runs = (p.tail - p.head) / DGS_RUN;
  int4 sq[AHEAD];
  unsigned mq[AHEAD];
#pragma unroll
  for (int d = 0; d < AHEAD; ++d)
    fetch(seg4, mask4, tid + d * nthreads, runs, sq[d], mq[d]);
  RowPair<PA> fa, fb;
  fb.g[0] = fb.g[1] = -1;
#pragma unroll 1
  for (long long r = tid; r < runs; r += nthreads) {
    int g[DGS_RUN];
    classify(sq[0], mq[0], p.G, g);
#pragma unroll
    for (int d = 0; d + 1 < AHEAD; ++d) {
      sq[d] = sq[d + 1];
      mq[d] = mq[d + 1];
    }
    fetch(seg4, mask4, r + AHEAD * nthreads, runs, sq[AHEAD - 1],
          mq[AHEAD - 1]);
    if ((g[0] & g[1] & g[2] & g[3]) < 0) continue;  // all four dead
    const long long row = p.head + r * DGS_RUN;
    if (DEFER) {
      load_pair(p, P, row, g[0], g[1], fa);
      add_pair<GM, P>(acc, cnt, p.G, fb);
      load_pair(p, P, row + 2, g[2], g[3], fb);
      add_pair<GM, P>(acc, cnt, p.G, fa);
    } else {
      load_pair(p, P, row, g[0], g[1], fa);
      add_pair<GM, P>(acc, cnt, p.G, fa);
      load_pair(p, P, row + 2, g[2], g[3], fa);
      add_pair<GM, P>(acc, cnt, p.G, fa);
    }
  }
  if (DEFER) add_pair<GM, P>(acc, cnt, p.G, fb);

  // the block's total of every cell, then one atomic per nonzero cell
  __shared__ u64 part[DGS_THREADS_MAX / 32][GM * (P + 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < GM; ++j) {
    if (j >= p.G) break;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const u64 v = warp_sum(acc[j][k]);
      if (lane == 0) part[warp][j * (P + 1) + k] = v;
    }
    const u64 c = warp_sum((u64)cnt[j]);
    if (lane == 0) part[warp][j * (P + 1) + P] = c;
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  for (int c = threadIdx.x; c < p.G * (P + 1); c += blockDim.x) {
    u64 v = 0;
    for (int w = 0; w < warps; ++w) v += part[w][c];
    const int j = c / (P + 1);
    add_to_output(p, j, c - j * (P + 1), v);
  }
}

// ---------------------------------------------------------------------------
// ROUTE_SHARED and ROUTE_GLOBAL
// ---------------------------------------------------------------------------

// All 32 lanes call this together, each with one row of group g (-1: dead)
// and its products x. Lanes of one group are merged first: a shuffle tree
// over the peers __match_any_sync finds (at step s, each remaining lane adds
// the partial of its next remaining peer, and lanes of odd rank drop out),
// so the lowest lane of each group holds the group's sums and adds them once:
// to the warp's own shared table, or to the output with global atomics.
template <bool SHARED>
__device__ __forceinline__ void aggregate(const Args& p, u64* table, int g,
                                          u64 (&x)[DGS_MAX_PAIRS]) {
  const unsigned full = 0xffffffffu;
  if (!__any_sync(full, g >= 0)) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(full, g);
  unsigned rank = __popc(peers & ((1u << lane) - 1));
  const bool leader = rank == 0;
  unsigned higher = peers & (0xfffffffeu << lane);
  while (__any_sync(full, higher != 0)) {
    const int next = __ffs(higher) - 1;  // -1: none left
#pragma unroll
    for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
      if (k >= p.n_unique) break;
      const u64 t = __shfl_sync(full, x[k], next & 31);
      if (next >= 0) x[k] += t;
    }
    higher &= __ballot_sync(full, (rank & 1) == 0);
    rank >>= 1;
  }
  if (!leader || g < 0) return;
  const int U = p.n_unique;
  const u64 count = (u64)__popc(peers);
  if (SHARED) {
    u64* cell = table + g * (U + 1);
#pragma unroll
    for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
      if (k >= U) break;
      cell[k] += x[k];
    }
    cell[U] += count;
  } else {
    u64* row = p.out + (long long)g * p.width;
#pragma unroll
    for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
      if (k >= U) break;
      if (x[k]) add_cols(row, p.out_cols[k], x[k]);
    }
    atomicAdd(row + (p.width - 1), count);
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(DGS_THREADS_MAX, 1)
dgs_aggregated(const Args p) {
  constexpr int AHEAD = 2;
  extern __shared__ u64 tables[];  // SHARED: [warps][G][n_unique + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cells = p.G * (p.n_unique + 1);
  u64* table = tables + (long long)warp * cells;
  if (SHARED) {
    for (int c = threadIdx.x; c < (blockDim.x >> 5) * cells; c += blockDim.x)
      tables[c] = 0;
    __syncthreads();
  }
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  // loops run over whole warps, so that every lane reaches the collectives
  const long long base =
      (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31);

  for (int part = 0; part < 2; ++part) {  // scalar head, then scalar tail
    const long long lo = part ? p.tail : 0, hi = part ? p.n : p.head;
    for (long long i0 = lo + base; i0 < hi; i0 += nthreads) {
      const long long i = i0 + lane;
      u64 x[DGS_MAX_PAIRS];
      int g = -1;
      if (i < hi) g = group_of(p.seg[i], p.mask[i], p.G);
      if (g >= 0) {
        products1<DGS_MAX_PAIRS>(p, p.n_unique, i, x);
      } else {
#pragma unroll
        for (int k = 0; k < DGS_MAX_PAIRS; ++k) x[k] = 0;
      }
      aggregate<SHARED>(p, table, g, x);
    }
  }

  const int4* seg4 = reinterpret_cast<const int4*>(p.seg + p.head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(p.mask + p.head);
  const long long runs = (p.tail - p.head) / DGS_RUN;
  int4 sq[AHEAD];
  unsigned mq[AHEAD];
#pragma unroll
  for (int d = 0; d < AHEAD; ++d)
    fetch(seg4, mask4, base + lane + d * nthreads, runs, sq[d], mq[d]);
#pragma unroll 1
  for (long long r0 = base; r0 < runs; r0 += nthreads) {
    const long long r = r0 + lane;
    int g[DGS_RUN];
    classify(sq[0], mq[0], p.G, g);
#pragma unroll
    for (int d = 0; d + 1 < AHEAD; ++d) {
      sq[d] = sq[d + 1];
      mq[d] = mq[d + 1];
    }
    fetch(seg4, mask4, r + AHEAD * nthreads, runs, sq[AHEAD - 1],
          mq[AHEAD - 1]);
    if (__all_sync(0xffffffffu, (g[0] & g[1] & g[2] & g[3]) < 0)) continue;
    const long long row = p.head + r * DGS_RUN;
#pragma unroll
    for (int h = 0; h < DGS_RUN; h += 2) {
      RowPair<DGS_MAX_PAIRS> f;
      load_pair(p, p.n_unique, row + h, g[h], g[h + 1], f);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        u64 x[DGS_MAX_PAIRS];
#pragma unroll
        for (int k = 0; k < DGS_MAX_PAIRS; ++k)
          x[k] = k < p.n_unique && f.g[t] >= 0 ? f.a[t][k] * f.b[t][k] : 0;
        aggregate<SHARED>(p, table, f.g[t], x);
      }
    }
  }

  if (SHARED) {
    __syncthreads();
    const int U = p.n_unique, warps = blockDim.x >> 5;
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      u64 v = 0;
      for (int w = 0; w < warps; ++w) v += tables[(long long)w * cells + c];
      const int j = c / (U + 1);
      add_to_output(p, j, c - j * (U + 1), v);
    }
  }
}

// Register-route instantiations <G_MAX, P>: G = 1 with 0..16 distinct
// pairs, G <= 8 with 0..8, in the order of REGISTER_SHAPES in
// ops/dense_agg.py.
struct Variant {
  int g_max, pairs;
  const void* fn;
};
#define DGS_G1(P) {1, P, (const void*)dgs_registers<1, P>}
#define DGS_G8(P) {8, P, (const void*)dgs_registers<8, P>}
static const Variant kVariants[] = {
    DGS_G1(0),  DGS_G1(1),  DGS_G1(2),  DGS_G1(3),  DGS_G1(4),  DGS_G1(5),
    DGS_G1(6),  DGS_G1(7),  DGS_G1(8),  DGS_G1(9),  DGS_G1(10), DGS_G1(11),
    DGS_G1(12), DGS_G1(13), DGS_G1(14), DGS_G1(15), DGS_G1(16), DGS_G8(0),
    DGS_G8(1),  DGS_G8(2),  DGS_G8(3),  DGS_G8(4),  DGS_G8(5),  DGS_G8(6),
    DGS_G8(7),  DGS_G8(8)};
#define DGS_VARIANTS ((int)(sizeof(kVariants) / sizeof(kVariants[0])))

static const void* kernel_of(int route, int variant) {
  switch (route) {
    case ROUTE_REGISTERS:
      return variant >= 0 && variant < DGS_VARIANTS ? kVariants[variant].fn
                                                    : nullptr;
    case ROUTE_SHARED: return (const void*)dgs_aggregated<true>;
    case ROUTE_GLOBAL: return (const void*)dgs_aggregated<false>;
  }
  return nullptr;
}

static cudaError_t allow_shared(const void* fn, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

static bool aligned(const void* p, long long offset, int to) {
  return ((uintptr_t)p + (uintptr_t)offset) % (uintptr_t)to == 0;
}

extern "C" {

int dense_groupby_sums_max_pairs(void) { return DGS_MAX_PAIRS; }
int dense_groupby_sums_run_rows(void) { return DGS_RUN; }

// The register route's instantiations: fills g_max[v] and pairs[v] for
// v < cap and returns how many there are.
int dense_groupby_sums_register_shapes(int* g_max, int* pairs, int cap) {
  for (int v = 0; v < DGS_VARIANTS && v < cap; ++v) {
    g_max[v] = kVariants[v].g_max;
    pairs[v] = kVariants[v].pairs;
  }
  return DGS_VARIANTS;
}

// Resident blocks per SM of one route's kernel at this block size and
// dynamic shared memory, or minus a cudaError_t.
int dense_groupby_sums_blocks_per_sm(int route, int variant, int threads,
                                     int smem_bytes) {
  const void* fn = kernel_of(route, variant);
  if (!fn) return -(int)cudaErrorInvalidValue;
  cudaError_t err = allow_shared(fn, smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      (size_t)smem_bytes);
  return err != cudaSuccess ? -(int)err : blocks;
}

// seg: [n] int32; mask: [n] bool (1 byte); a[u], b[u]: [n] int32 or int64
// device pointers of the n_unique distinct pairs (b[u] ignored when
// b_bytes[u] == 0); out_cols[u]: bit mask of the output columns pair u's sum
// goes to; out: [G, n_pairs + 1] int64, zeroed by the caller, counts last.
// Rows [head, tail) must start 16-byte aligned for seg, 4 for mask, 16 for
// int64 and 8 for int32 factors. route, variant, grid, threads and
// smem_bytes come from launch_plan in ops/dense_agg.py. Enqueues on
// `stream` and returns the launch's cudaError_t.
int dense_groupby_sums_launch(const void* seg, const void* mask, long long n,
                              long long head, long long tail, int G,
                              int n_pairs, int n_unique, const void* const* a,
                              const int* a_bytes, const void* const* b,
                              const int* b_bytes, const unsigned* out_cols,
                              void* out, int route, int variant, int grid,
                              int threads, int smem_bytes, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (n < 0 || head < 0 || head > tail || tail > n ||
      (tail - head) % DGS_RUN != 0 || G < 1 || n_pairs < 0 ||
      n_pairs > DGS_MAX_PAIRS || n_unique < 0 || n_unique > n_pairs ||
      grid < 1 || threads < 32 || threads > DGS_THREADS_MAX ||
      threads % 32 != 0 || smem_bytes < 0)
    return (int)bad;
  const void* fn = kernel_of(route, variant);
  if (!fn) return (int)bad;
  const long long table_bytes = (long long)G * (n_unique + 1) * sizeof(u64);
  if (route == ROUTE_REGISTERS &&
      (G > kVariants[variant].g_max || n_unique != kVariants[variant].pairs ||
       smem_bytes != 0))
    return (int)bad;
  if (route == ROUTE_SHARED &&
      ((long long)smem_bytes != table_bytes * (threads / 32) ||
       smem_bytes > DGS_SHARED_MAX))
    return (int)bad;
  if (route == ROUTE_GLOBAL && smem_bytes != 0) return (int)bad;

  Args p;
  p.seg = static_cast<const int*>(seg);
  p.mask = static_cast<const unsigned char*>(mask);
  p.n = n;
  p.head = head;
  p.tail = tail;
  p.G = G;
  p.n_unique = n_unique;
  p.width = n_pairs + 1;
  const bool vector = tail > head;
  if (vector && (!aligned(seg, 4 * head, 16) || !aligned(mask, head, 4)))
    return (int)cudaErrorMisalignedAddress;
  for (int u = 0; u < DGS_MAX_PAIRS; ++u) {
    const bool used = u < n_unique;
    p.a[u] = used ? a[u] : nullptr;
    p.a_bytes[u] = used ? a_bytes[u] : 0;
    p.b_bytes[u] = used ? b_bytes[u] : 0;
    p.b[u] = p.b_bytes[u] ? b[u] : nullptr;
    p.out_cols[u] = used ? out_cols[u] : 0u;
    if (!used) continue;
    if ((p.a_bytes[u] != 4 && p.a_bytes[u] != 8) ||
        (p.b_bytes[u] != 0 && p.b_bytes[u] != 4 && p.b_bytes[u] != 8) ||
        (out_cols[u] >> n_pairs) != 0u)
      return (int)bad;
    if (vector && (!aligned(p.a[u], p.a_bytes[u] * head, 2 * p.a_bytes[u]) ||
                   (p.b_bytes[u] &&
                    !aligned(p.b[u], p.b_bytes[u] * head, 2 * p.b_bytes[u]))))
      return (int)cudaErrorMisalignedAddress;
  }
  p.out_cols[DGS_MAX_PAIRS] = 0u;
  p.out_cols[n_unique] = 1u << n_pairs;  // the counts
  p.out = static_cast<u64*>(out);

  cudaError_t err = allow_shared(fn, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&p};
  err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3((unsigned)threads),
                         params, (size_t)smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
