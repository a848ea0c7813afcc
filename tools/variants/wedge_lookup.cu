// Per-edge weighted intersection of capped neighbor windows (int32): a
// lower-bound lookup in the ascending W(v), timed against the committed
// kernel by tools/wedge_intersect_variants.py.  Same C interface.
//
// Replaces repro/kernels/wedge_intersect/kernel.py:wedge_intersect, the TPU
// kernel behind common_neighbor_stats.  Same function: for every directed
// edge e = (u, v) = (row[e], col[e]) with windows W(u) = window[u, :] and
// W(v) = window[v, :],
//     C[e] = sum of weights[x] over the entries x of W(u) that occur in W(v)
//            and are active,
//     K[e] = the number of such entries,
// each entry of W(u) counted once per position (as the reference's
// any(-1) over the [D, D] compare).  A nil entry of W(u) matches a nil entry
// of W(v) but counts only if active[nil] is set, which it never is in a
// reduction state.  int32 sums wrap like the reference's.
//
// Layout: one thread per edge.  The thread gathers both window rows itself
// (row[e], col[e] index the [V, D] window; 16-byte vectors where the window
// is aligned), and reads active[x] and weights[x] only for an entry x of
// W(u) that occurs in W(v).  The [E, D, D] compare and the four [E, D]
// operands the TPU path gathered outside its kernel never reach device
// memory.
//
// Bound: bytes (0.062 ms at the full-size instance: row, col, C and K per
// edge, the window, weights and activity per vertex).  What set the pace of
// the first design (D x D = 256 compares an edge in registers) was
// the compares, not the gather: they took about 0.13 of its 0.245 ms, the
// W(v) gather about 0.045 (tools/wedge_intersect_variants.py).  The int32
// compares share the CUDA cores' integer pipe (64 lanes a SM a clock) with
// the predicate logic around them.  So the membership test now uses the
// partition's layout: each window is ascending (core/partition.py sorts
// every row's neighbours; nil, the PE's largest index, pads the tail).  For
// D = 8, 16 and 32 the thread checks that W(v) is ascending (D - 1
// compares), puts it in shared memory (a column a thread, so lanes at
// different positions never share a bank) and finds each entry of W(u) by
// a branch-free lower bound: log2(D) + 1 compares an entry instead of D,
// the first step against a register.  A W(v) that is not ascending takes
// the all-pairs compare in registers, exact for any window;
// wedge_unsorted_edges() counts the edges that took it.  Other widths up to
// 32 run the all-pairs compare, predicated.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
__device__ unsigned long long g_unsorted = 0;  // see wedge_unsorted_edges
constexpr unsigned kFull = 0xffffffffu;

// Load a window row of DMAX entries (past d: 0) into registers: 16-byte
// vectors when VEC (d == DMAX, a multiple of 4, rows aligned).
template <int DMAX, bool VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ w, int d,
                                         int (&x)[DMAX]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < DMAX / 4; ++q) {
      const int4 a = reinterpret_cast<const int4*>(w)[q];
      x[4 * q] = a.x; x[4 * q + 1] = a.y; x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) x[j] = j < d ? w[j] : 0;
  }
}

// Bit i set iff u[i] occurs in v[0 .. d), i < d: the all-pairs compare.
template <int DMAX, bool EXACT>
__device__ __forceinline__ unsigned hits_all_pairs(const int (&u)[DMAX],
                                                   const int (&v)[DMAX],
                                                   int d) {
  unsigned hits = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < DMAX; ++j) hit |= (EXACT || j < d) && u[i] == v[j];
    hits |= (unsigned)((EXACT || i < d) && hit) << i;
  }
  return hits;
}

template <int DMAX>
__device__ __forceinline__ void finish(unsigned hits, const int (&u)[DMAX],
                                       const int* __restrict__ weights,
                                       const unsigned char* __restrict__ active,
                                       int* __restrict__ out_c,
                                       int* __restrict__ out_k, long long e) {
  unsigned c = 0;  // unsigned: wraps like the reference's int32 sum
  int k = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (((hits >> i) & 1u) && active[u[i]]) {
      c += (unsigned)weights[u[i]];
      ++k;
    }
  out_c[e] = (int)c;
  out_k[e] = k;
}

// D a power of two (8, 16, 32): lower-bound lookups in an ascending W(v).
template <int D, bool VEC>
__global__ void __launch_bounds__(kThreads) wedge_lookup_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k,
    long long n_edges) {
  __shared__ int sv[D * kThreads];  // sv[j * kThreads + t]: W(v)[j], thread t
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = e < n_edges;
  int u[D], v[D];
  bool sorted = true;
  if (live) {
    load_row<D, VEC>(window + (long long)row[e] * D, D, u);
    load_row<D, VEC>(window + (long long)col[e] * D, D, v);
#pragma unroll
    for (int j = 1; j < D; ++j) sorted &= v[j - 1] <= v[j];
  }
  {  // edges that take the all-pairs path
    const unsigned n = __popc(__ballot_sync(kFull, live && !sorted));
    if (n && (threadIdx.x & 31) == 0) atomicAdd(&g_unsorted, n);
  }
  if (!live) return;
  unsigned hits;
  if (sorted) {
    int* mine = sv + threadIdx.x;
#pragma unroll
    for (int j = 0; j < D; ++j) mine[j * kThreads] = v[j];
    hits = 0;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int x = u[i];
      // p = the number of entries below x, at most D - 1
      int p = v[D / 2 - 1] < x ? D / 2 : 0;
#pragma unroll
      for (int step = D / 4; step >= 1; step >>= 1)
        p += mine[(p + step - 1) * kThreads] < x ? step : 0;
      hits |= (unsigned)(mine[p * kThreads] == x) << i;
    }
  } else {
    hits = hits_all_pairs<D, true>(u, v, D);
  }
  finish<D>(hits, u, weights, active, out_c, out_k, e);
}

// Any width up to DMAX: the all-pairs compare in registers.
template <int DMAX, bool VEC>
__global__ void __launch_bounds__(kThreads) wedge_all_pairs_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k, long long n_edges, int d) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  int u[DMAX], v[DMAX];
  load_row<DMAX, VEC>(window + (long long)row[e] * d, d, u);
  load_row<DMAX, VEC>(window + (long long)col[e] * d, d, v);
  const unsigned hits = VEC ? hits_all_pairs<DMAX, true>(u, v, d)
                            : hits_all_pairs<DMAX, false>(u, v, d);
  finish<DMAX>(hits, u, weights, active, out_c, out_k, e);
}

template <int D, bool VEC>
int launch_lookup(const void* window, const void* weights, const void* active,
                  const void* row, const void* col, void* out_c, void* out_k,
                  long long n_edges, cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_lookup_kernel<D, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)window, (const int*)weights, (const unsigned char*)active,
      (const int*)row, (const int*)col, (int*)out_c, (int*)out_k,
      n_edges);
  return (int)cudaGetLastError();
}

template <int DMAX, bool VEC>
int launch_all_pairs(const void* window, const void* weights,
                     const void* active, const void* row, const void* col,
                     void* out_c, void* out_k, long long n_edges, int d,
                     cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_all_pairs_kernel<DMAX, VEC><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      (const int*)window, (const int*)weights, (const unsigned char*)active,
      (const int*)row, (const int*)col, (int*)out_c, (int*)out_k, n_edges, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// 1 <= d <= 32; n_edges >= 1; n_vertices unused.  vec16 != 0 reads rows as
// 16-byte vectors where d is 4, 8, 16 or 32: the window must then be
// 16-byte aligned.
extern "C" int wedge_intersect_launch(
    const void* window, const void* weights, const void* active,
    const void* row, const void* col, void* out_c, void* out_k,
    long long n_edges, int d, int vec16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define WEDGE_LOOKUP(D, VEC)                                                 \
  launch_lookup<D, VEC>(window, weights, active, row, col, out_c, out_k,    \
                        n_edges, s)
#define WEDGE_ALL_PAIRS(DMAX, VEC)                                           \
  launch_all_pairs<DMAX, VEC>(window, weights, active, row, col, out_c,     \
                              out_k, n_edges, d, s)
  switch (d) {
    case 4:
      return vec16 ? WEDGE_ALL_PAIRS(4, true) : WEDGE_ALL_PAIRS(4, false);
    case 8:
      return vec16 ? WEDGE_LOOKUP(8, true) : WEDGE_LOOKUP(8, false);
    case 16:
      return vec16 ? WEDGE_LOOKUP(16, true) : WEDGE_LOOKUP(16, false);
    case 32:
      return vec16 ? WEDGE_LOOKUP(32, true) : WEDGE_LOOKUP(32, false);
    default:
      if (d < 1 || d > 32) return (int)cudaErrorInvalidValue;
      return WEDGE_ALL_PAIRS(32, false);
  }
#undef WEDGE_LOOKUP
#undef WEDGE_ALL_PAIRS
}

// The edges that took the all-pairs compare since the last call; resets.
extern "C" unsigned long long wedge_unsorted_edges() {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaMemcpyFromSymbol(&n, g_unsorted, sizeof(n));
  cudaMemcpyToSymbol(g_unsorted, &zero, sizeof(zero));
  return n;
}
