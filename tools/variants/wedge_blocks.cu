// Per-edge weighted intersection of capped neighbor windows (int32): a
// block lookup of each W(row) entry in the ascending W(col), timed against
// the committed kernel by tools/wedge_intersect_variants.py.  Same C
// interface.
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
// is aligned), tests each entry of W(u) for membership in W(v), loads the
// activity of every hit as soon as its test ends and the weights of the
// active ones after the last, so that an edge's gathers are in flight
// together.  The [E, D, D] compare and the four [E, D] operands the TPU
// path gathered outside its kernel never reach device memory.
//
// Bound: bytes (0.062 ms at the full-size instance: row, col, C and K per
// edge, the window, weights and activity per vertex).  What set the pace of
// the first design (every entry of W(u) against every entry of
// W(v), D x D = 256 int32 compares an edge) was the integer pipe, not the
// gather: without its compares it took 0.11 of its 0.245 ms, and an integer
// compare issues at half rate (64 lanes a SM a clock); the FP32 pipe's
// compares take the same pipe (tools/wedge_intersect_variants.py).  So the
// membership test now uses the partition's layout, where every window is
// ascending (core/partition.py sorts each row's neighbours; nil, the PE's
// largest index, pads the tail).  At D = 8, 16 and 32 the thread checks
// that W(v) is ascending (D - 1 compares) and splits it into D / 4 blocks
// of four: an entry x can only occur in the first block whose last entry
// is not below x, found by D / 4 - 1 compares against those last entries
// in registers; that block is read again as one 16-byte vector (from L1:
// the row was just loaded) and compared four times.  So D / 4 + 3 compares
// an entry instead of D (7 instead of 16 at D = 16).  A W(v) that is not
// ascending takes the all-pairs compare, exact for any window;
// wedge_unsorted_edges() counts the edges that took it.  Other widths, and
// unaligned windows, take the all-pairs compare.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
__device__ unsigned long long g_unsorted = 0;  // see wedge_unsorted_edges

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

// Does x occur in v[0 .. d)?  All pairs.
template <int DMAX, bool EXACT>
__device__ __forceinline__ bool occurs(int x, const int (&v)[DMAX], int d) {
  bool hit = false;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) hit |= (EXACT || j < d) && x == v[j];
  return hit;
}

// Does x occur in the ascending v[0 .. D), whose 16-byte blocks are also at
// vb?  Only in the first block whose last entry is not below x.
template <int D>
__device__ __forceinline__ bool occurs_sorted(int x, const int (&v)[D],
                                              const int4* __restrict__ vb) {
  int block = 0;
#pragma unroll
  for (int q = 0; q < D / 4 - 1; ++q) block += x > v[4 * q + 3];
  const int4 b = vb[block];
  return x == b.x || x == b.y || x == b.z || x == b.w;
}

// C[e] and K[e] from the active hits of the entries of u.
template <int DMAX>
__device__ __forceinline__ void store_stats(const bool (&act)[DMAX],
                                            const int (&u)[DMAX],
                                            const int* __restrict__ weights,
                                            int* __restrict__ out_c,
                                            int* __restrict__ out_k,
                                            long long e) {
  unsigned c = 0;  // unsigned: wraps like the reference's int32 sum
  int k = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    c += act[i] ? (unsigned)weights[u[i]] : 0u;
    k += act[i];
  }
  out_c[e] = (int)c;
  out_k[e] = k;
}

// D = 8, 16 or 32, aligned: block lookups where W(col) is ascending.
template <int D>
__global__ void __launch_bounds__(kThreads) wedge_sorted_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k,
    long long n_edges) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const int* wv = window + (long long)col[e] * D;
  int u[D], v[D];
  load_row<D, true>(window + (long long)row[e] * D, D, u);
  load_row<D, true>(wv, D, v);
  bool sorted = true;
#pragma unroll
  for (int j = 1; j < D; ++j) sorted &= v[j - 1] <= v[j];
  bool act[D];
  if (sorted) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      act[i] = occurs_sorted<D>(u[i], v, reinterpret_cast<const int4*>(wv))
               && active[u[i]] != 0;
  } else {
    atomicAdd(&g_unsorted, 1ull);
#pragma unroll
    for (int i = 0; i < D; ++i)
      act[i] = occurs<D, true>(u[i], v, D) && active[u[i]] != 0;
  }
  store_stats<D>(act, u, weights, out_c, out_k, e);
}

// Any width up to DMAX: the all-pairs compare.
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
  bool act[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    act[i] = (VEC || i < d) && occurs<DMAX, VEC>(u[i], v, d)
             && active[u[i]] != 0;
  store_stats<DMAX>(act, u, weights, out_c, out_k, e);
}

template <int D>
int launch_sorted(const void* window, const void* weights, const void* active,
                  const void* row, const void* col, void* out_c, void* out_k,
                  long long n_edges, cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_sorted_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
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
// 1 <= d <= 32; n_edges >= 1.  vec16 != 0 reads rows as 16-byte vectors
// where d is 4, 8, 16 or 32: the window must then be 16-byte aligned.
extern "C" int wedge_intersect_launch(
    const void* window, const void* weights, const void* active,
    const void* row, const void* col, void* out_c, void* out_k,
    long long n_edges, int d, int vec16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define WEDGE_SORTED(D)                                                      \
  launch_sorted<D>(window, weights, active, row, col, out_c, out_k,         \
                   n_edges, s)
#define WEDGE_ALL_PAIRS(DMAX, VEC)                                           \
  launch_all_pairs<DMAX, VEC>(window, weights, active, row, col, out_c,     \
                              out_k, n_edges, d, s)
  switch (d) {
    case 4:
      return vec16 ? WEDGE_ALL_PAIRS(4, true) : WEDGE_ALL_PAIRS(4, false);
    case 8:
      return vec16 ? WEDGE_SORTED(8) : WEDGE_ALL_PAIRS(8, false);
    case 16:
      return vec16 ? WEDGE_SORTED(16) : WEDGE_ALL_PAIRS(16, false);
    case 32:
      return vec16 ? WEDGE_SORTED(32) : WEDGE_ALL_PAIRS(32, false);
    default:
      if (d < 1 || d > 32) return (int)cudaErrorInvalidValue;
      return WEDGE_ALL_PAIRS(32, false);
  }
#undef WEDGE_SORTED
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
