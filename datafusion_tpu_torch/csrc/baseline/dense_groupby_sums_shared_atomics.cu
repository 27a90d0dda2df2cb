// The first design of the dense_groupby_sums kernel, kept only as a yardstick:
// chip_smoke.py builds it beside csrc/dense_groupby_sums.cu and times both by
// the same method on the same inputs. The engine never calls it.
//
// A grid-stride loop with one thread per row. Each block accumulates into a
// [G, n_pairs + 1] table of unsigned 64-bit integers in shared memory (the
// last column holds the counts) with shared atomics -- on sm_90 each is an
// ATOMS.CAST.SPIN.64 compare-and-swap loop -- then adds every nonzero cell to
// the output with one global atomic. G == 1 sums in registers and reduces
// each warp with shuffles first. Tables over 48 KB take global atomics.
#include <cuda_runtime.h>

#define DGS_MAX_PAIRS 16
#define DGS_THREADS 256
#define DGS_BLOCKS_PER_SM 8
#define DGS_MAX_SHARED_TABLE (48 * 1024)

enum { ROUTE_ONE_GROUP = 0, ROUTE_SHARED = 1, ROUTE_GLOBAL = 2 };

// Factor pointers travel to the kernel by value. a_bytes / b_bytes give each
// column's element size (4 = int32, 8 = int64); b_bytes == 0 means b is 1.
struct Pairs {
  const void* a[DGS_MAX_PAIRS];
  const void* b[DGS_MAX_PAIRS];
  int a_bytes[DGS_MAX_PAIRS];
  int b_bytes[DGS_MAX_PAIRS];
};

__device__ __forceinline__ unsigned long long load_factor(const void* p,
                                                          int bytes,
                                                          long long i) {
  // sign-extend, then reinterpret: unsigned products wrap exactly as the
  // two's-complement int64 product does, without signed-overflow UB
  return bytes == 8
      ? (unsigned long long)((const long long*)p)[i]
      : (unsigned long long)(long long)((const int*)p)[i];
}

__device__ __forceinline__ unsigned long long product(const Pairs& p, int k,
                                                      long long i) {
  unsigned long long a = load_factor(p.a[k], p.a_bytes[k], i);
  if (p.b_bytes[k] == 0) return a;
  return a * load_factor(p.b[k], p.b_bytes[k], i);
}

// Adds every live row of this thread's grid stride into table[G, n_pairs+1].
// The pair loop is unrolled over the struct's fixed size so that each factor
// pointer is read from the parameter space at a constant offset.
__device__ __forceinline__ void accumulate(const int* __restrict__ seg,
                                           const unsigned char* __restrict__ mask,
                                           const Pairs& p, int n_pairs, int G,
                                           long long n,
                                           unsigned long long* table) {
  const int width = n_pairs + 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int g = seg[i];
    if (!mask[i] || g < 0 || g >= G) continue;
    unsigned long long* row = table + (long long)g * width;
#pragma unroll
    for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
      if (k < n_pairs) atomicAdd(row + k, product(p, k, i));
    }
    atomicAdd(row + n_pairs, 1ULL);
  }
}

__global__ void __launch_bounds__(DGS_THREADS)
dgs_shared(const int* __restrict__ seg, const unsigned char* __restrict__ mask,
           Pairs p, int n_pairs, int G, long long n,
           unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long table[];
  const int cells = G * (n_pairs + 1);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) table[c] = 0ULL;
  __syncthreads();
  accumulate(seg, mask, p, n_pairs, G, n, table);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned long long v = table[c];
    if (v) atomicAdd(out + c, v);
  }
}

__global__ void __launch_bounds__(DGS_THREADS)
dgs_global(const int* __restrict__ seg, const unsigned char* __restrict__ mask,
           Pairs p, int n_pairs, int G, long long n,
           unsigned long long* __restrict__ out) {
  accumulate(seg, mask, p, n_pairs, G, n, out);
}

__global__ void __launch_bounds__(DGS_THREADS)
dgs_one_group(const int* __restrict__ seg,
              const unsigned char* __restrict__ mask, Pairs p, int n_pairs,
              long long n, unsigned long long* __restrict__ out) {
  unsigned long long acc[DGS_MAX_PAIRS];
  unsigned long long count = 0;
#pragma unroll
  for (int k = 0; k < DGS_MAX_PAIRS; ++k) acc[k] = 0ULL;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i] || seg[i] != 0) continue;
#pragma unroll
    for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
      if (k < n_pairs) acc[k] += product(p, k, i);
    }
    count += 1ULL;
  }
  // n_pairs is uniform across the block, so every lane takes the same
  // branches around the shuffles
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
    if (k < n_pairs) {
      unsigned long long v = acc[k];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane0 && v) atomicAdd(out + k, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane0 && count) atomicAdd(out + n_pairs, count);
}

extern "C" {

// Which kernel a launch with these sizes takes (ROUTE_*).
int dense_groupby_sums_route(int G, int n_pairs) {
  if (G == 1) return ROUTE_ONE_GROUP;
  const long long table_bytes =
      (long long)G * (n_pairs + 1) * (long long)sizeof(unsigned long long);
  return table_bytes <= DGS_MAX_SHARED_TABLE ? ROUTE_SHARED : ROUTE_GLOBAL;
}

int dense_groupby_sums_max_pairs(void) { return DGS_MAX_PAIRS; }

// seg: [n] int32; mask: [n] bool (1 byte); a[k], b[k]: [n] int32 or int64
// device pointers (b[k] null when b_bytes[k] == 0); out: [G, n_pairs + 1]
// int64, zeroed by the caller. Enqueues on `stream` and returns the launch's
// cudaError_t.
int dense_groupby_sums_launch(const void* seg, const void* mask, long long n,
                              int G, int n_pairs, const void* const* a,
                              const int* a_bytes, const void* const* b,
                              const int* b_bytes, void* out, void* stream) {
  if (n < 0 || G < 1 || n_pairs < 0 || n_pairs > DGS_MAX_PAIRS)
    return (int)cudaErrorInvalidValue;
  Pairs p;
  for (int k = 0; k < DGS_MAX_PAIRS; ++k) {
    const bool used = k < n_pairs;
    p.a[k] = used ? a[k] : nullptr;
    p.a_bytes[k] = used ? a_bytes[k] : 0;
    p.b[k] = used ? b[k] : nullptr;
    p.b_bytes[k] = used ? b_bytes[k] : 0;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + DGS_THREADS - 1) / DGS_THREADS;
  const long long max_blocks = (long long)sms * DGS_BLOCKS_PER_SM;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
  const int* segp = (const int*)seg;
  const unsigned char* maskp = (const unsigned char*)mask;
  unsigned long long* outp = (unsigned long long*)out;
  switch (dense_groupby_sums_route(G, n_pairs)) {
    case ROUTE_ONE_GROUP:
      dgs_one_group<<<(int)blocks, DGS_THREADS, 0, s>>>(segp, maskp, p,
                                                        n_pairs, n, outp);
      break;
    case ROUTE_SHARED: {
      const size_t table_bytes =
          (size_t)G * (n_pairs + 1) * sizeof(unsigned long long);
      dgs_shared<<<(int)blocks, DGS_THREADS, table_bytes, s>>>(
          segp, maskp, p, n_pairs, G, n, outp);
      break;
    }
    default:
      dgs_global<<<(int)blocks, DGS_THREADS, 0, s>>>(segp, maskp, p, n_pairs,
                                                     G, n, outp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
