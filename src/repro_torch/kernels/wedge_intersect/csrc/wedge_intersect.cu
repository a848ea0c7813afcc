// Per-edge weighted intersection of capped neighbor windows (int32).
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
// reduction state.  int32 sums wrap like the reference's.  Exact for any
// window: no order of the entries is assumed.
//
// Layout: one thread per edge.  The thread gathers both window rows itself
// (row[e], col[e] index the [V, D] window; 16-byte vectors where the window
// is aligned), tests every entry of W(u) against every entry of W(v) in
// registers, and loads the activity of an entry as soon as its test hits
// and the weights of the active hits after the last test, without
// branches, so that all of an edge's gathers are in flight together.  The
// [E, D, D] compare and the four [E, D] operands the TPU path gathered
// outside its kernel never reach device memory.
//
// Bound: bytes (0.062 ms at the full-size instance: row, col, C and K per
// edge, the window, weights and activity per vertex).  Measured there
// (tools/wedge_intersect_variants.py, PERF.md): the row loads alone take
// 0.11 ms, 0.067 ms when W(col) is the row's own, cached window, so the
// random W(col) rows cost the L2 and memory latency the bytes do not
// show; the D x D = 256 int32 compares an edge add about 0.08 ms (an integer
// compare issues at half rate, 64 lanes a SM a clock, and a float compare
// takes the same pipe), the activity and weight gathers the rest.  Designs
// that use the partition's ascending windows to compare less (a merge, a
// binary search, a lookup by blocks of four) spent more on their shared
// memory, index arithmetic or reloads than they saved, and a warp-wide
// __match_any_sync was five times slower; they are kept in tools/variants/.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

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

// C[e] and K[e] from the rows u and v (d entries each; EXACT: d == DMAX).
template <int DMAX, bool EXACT>
__device__ __forceinline__ void intersect(
    const int (&u)[DMAX], const int (&v)[DMAX], int d,
    const int* __restrict__ weights, const unsigned char* __restrict__ active,
    int* __restrict__ out_c, int* __restrict__ out_k, long long e) {
  bool act[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < DMAX; ++j) hit |= (EXACT || j < d) && u[i] == v[j];
    act[i] = (EXACT || i < d) && hit && active[u[i]] != 0;
  }
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

// D = 4, 8, 16 or 32, rows aligned.
template <int D>
__global__ void __launch_bounds__(kThreads) wedge_exact_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k, long long n_edges) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  int u[D], v[D];
  load_row<D, true>(window + (long long)row[e] * D, D, u);
  load_row<D, true>(window + (long long)col[e] * D, D, v);
  intersect<D, true>(u, v, D, weights, active, out_c, out_k, e);
}

// Any width up to DMAX, rows read element by element, compares predicated.
template <int DMAX>
__global__ void __launch_bounds__(kThreads) wedge_any_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k, long long n_edges, int d) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  int u[DMAX], v[DMAX];
  load_row<DMAX, false>(window + (long long)row[e] * d, d, u);
  load_row<DMAX, false>(window + (long long)col[e] * d, d, v);
  intersect<DMAX, false>(u, v, d, weights, active, out_c, out_k, e);
}

template <int D>
int launch_exact(const void* window, const void* weights, const void* active,
                 const void* row, const void* col, void* out_c, void* out_k,
                 long long n_edges, cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_exact_kernel<D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const int*)window, (const int*)weights, (const unsigned char*)active,
      (const int*)row, (const int*)col, (int*)out_c, (int*)out_k, n_edges);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_any(const void* window, const void* weights, const void* active,
               const void* row, const void* col, void* out_c, void* out_k,
               long long n_edges, int d, cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_any_kernel<DMAX><<<(unsigned)blocks, kThreads, 0, stream>>>(
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
#define WEDGE_EXACT(D)                                                       \
  launch_exact<D>(window, weights, active, row, col, out_c, out_k, n_edges, \
                  s)
  if (d < 1 || d > 32) return (int)cudaErrorInvalidValue;
  if (vec16 && d == 4) return WEDGE_EXACT(4);
  if (vec16 && d == 8) return WEDGE_EXACT(8);
  if (vec16 && d == 16) return WEDGE_EXACT(16);
  if (vec16 && d == 32) return WEDGE_EXACT(32);
  return launch_any<32>(window, weights, active, row, col, out_c, out_k,
                        n_edges, d, s);
#undef WEDGE_EXACT
}
