// Per-edge weighted intersection of capped neighbor windows (int32): the
// first design of the port, one thread an edge with the D x D compare in
// registers and a branch around each hit's gathers, kept to be timed
// against (tools/wedge_intersect_variants.py).
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
// (row[e], col[e] index the [V, D] window), keeps W(v) in registers, and for
// each entry of W(u) runs the D-wide compare in registers; only for a match
// does it read active[x] and weights[x].  The [E, D, D] compare and the four
// [E, D] operands the TPU path gathered outside its kernel (W(u), W(v),
// masked weights, activity) never reach device memory.
//
// Bound: bytes, narrowly, at the windows' width D = 16.  Per edge the
// kernel must read row and col (8 B) and write C and K (8 B); the window
// (4D B), weights and activity (5 B) are per vertex.  Against that it does
// D^2 = 256 int32 compares per edge, which at the CUDA cores' rate take
// about half the time of those bytes.  In practice the gathered rows set
// the pace: W(v) is a random 4D-byte row per edge, and the [V, D] window
// (67 MB at the full-size instance) does not fit the 50 MB L2.  What the
// design does about it: for D = 4, 8, 16 and 32 (a template parameter)
// the compare is fully unrolled in registers, and a 16-byte aligned window
// is read as 16-byte vectors, one row per thread, with no bounds tests; an
// unaligned window of those widths is read element by element, and other
// widths up to 32 run the compare predicated; activity and weight are read
// only for an entry that matched.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads) wedge_intersect_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k, long long n_edges, int d) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const int* wu = window + (long long)row[e] * d;
  const int* wv = window + (long long)col[e] * d;
  int u[DMAX], v[DMAX];
  if constexpr (EXACT) {  // d == DMAX, a multiple of 4, rows aligned
#pragma unroll
    for (int q = 0; q < DMAX / 4; ++q) {
      const int4 a = reinterpret_cast<const int4*>(wu)[q];
      const int4 b = reinterpret_cast<const int4*>(wv)[q];
      u[4 * q] = a.x; u[4 * q + 1] = a.y; u[4 * q + 2] = a.z;
      u[4 * q + 3] = a.w;
      v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z;
      v[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      u[j] = j < d ? wu[j] : 0;
      v[j] = j < d ? wv[j] : 0;
    }
  }
  unsigned c = 0;  // unsigned: wraps like the reference's int32 sum
  int k = 0;
#pragma unroll
  for (int i = 0; i < DMAX; ++i) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < DMAX; ++j)
      hit |= (EXACT || j < d) && u[i] == v[j];
    if ((EXACT || i < d) && hit && active[u[i]]) {
      c += (unsigned)weights[u[i]];
      ++k;
    }
  }
  out_c[e] = (int)c;
  out_k[e] = k;
}

template <int DMAX, bool EXACT>
int launch(const void* window, const void* weights, const void* active,
           const void* row, const void* col, void* out_c, void* out_k,
           long long n_edges, int d, cudaStream_t stream) {
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_intersect_kernel<DMAX, EXACT><<<(unsigned)blocks, kThreads, 0,
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
#define WEDGE_LAUNCH(DMAX, EXACT)                                          \
  launch<DMAX, EXACT>(window, weights, active, row, col, out_c, out_k,   \
                      n_edges, d, s)
  switch (d) {
    case 4:
      return vec16 ? WEDGE_LAUNCH(4, true) : WEDGE_LAUNCH(4, false);
    case 8:
      return vec16 ? WEDGE_LAUNCH(8, true) : WEDGE_LAUNCH(8, false);
    case 16:
      return vec16 ? WEDGE_LAUNCH(16, true) : WEDGE_LAUNCH(16, false);
    case 32:
      return vec16 ? WEDGE_LAUNCH(32, true) : WEDGE_LAUNCH(32, false);
    default:
      if (d < 1 || d > 32) return (int)cudaErrorInvalidValue;
      return WEDGE_LAUNCH(32, false);
  }
#undef WEDGE_LAUNCH
}
