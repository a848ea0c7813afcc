// Per-edge weighted intersection of capped neighbor windows (int32):
// warp-cooperative match.  Same function and C interface as
// src/repro_torch/kernels/wedge_intersect/csrc/wedge_intersect.cu.
//
// A warp takes P = 32 / (2 S) edges at a time, S = the window width rounded
// up to a power of two (at most 16): lanes [2 S q, 2 S q + S) of slot q hold
// W(row) and the next S lanes W(col), one entry a lane (two when D > 16).
// One __match_any_sync over (slot, entry) keys does the D x D compare: an
// entry of W(row) occurs in W(col) iff its mask has a lane of the slot's
// W(col) half.  Lanes past D read the row's last entry again, which adds
// no member to W(col) and is not counted for W(row).  activity and weight
// are read only for a hit; C and K come from a reduction over the slot.
// Each warp takes kSteps steps of P edges, their loads issued together.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSteps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int S, int R>
__global__ void __launch_bounds__(kWarps * 32) wedge_match_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k, long long n_edges, int d) {
  constexpr int P = 32 / (2 * S);
  const int lane = threadIdx.x & 31;
  const int slot = lane / (2 * S);
  const bool is_v = (lane / S) & 1;
  const int pos = lane % S;
  const unsigned v_lanes = ((1u << S) - 1u) << (slot * 2 * S + S);
  const long long e0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (kSteps * P);
  int x[kSteps];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const long long e = e0 + t * P + slot;
    x[t] = e < n_edges ? (is_v ? col[e] : row[e]) : 0;
  }
  int val[kSteps][R];
#pragma unroll
  for (int t = 0; t < kSteps; ++t)
#pragma unroll
    for (int r = 0; r < R; ++r)
      val[t][r] = window[(long long)x[t] * d + min(pos + r * S, d - 1)];
  unsigned hits[kSteps];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    unsigned h = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool hit = false;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        // W(row) lanes offer entry r, W(col) lanes entry q
        const int mine = is_v ? val[t][q] : val[t][r];
        unsigned m;
        if constexpr (P == 1) {
          m = __match_any_sync(kFull, mine);
        } else {
          m = __match_any_sync(
              kFull, ((unsigned long long)slot << 32) | (unsigned)mine);
        }
        hit |= (m & v_lanes) != 0;
      }
      h |= (unsigned)(hit && !is_v && pos + r * S < d) << r;
    }
    hits[t] = h;
  }
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    unsigned c = 0;
    int k = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((hits[t] >> r) & 1) {
        const int u = val[t][r];
        if (active[u]) {
          c += (unsigned)weights[u];
          ++k;
        }
      }
    if constexpr (P == 1) {
      c = __reduce_add_sync(kFull, c);
      k = (int)__reduce_add_sync(kFull, (unsigned)k);
    } else {
#pragma unroll
      for (int off = S; off >= 1; off >>= 1) {
        c += __shfl_xor_sync(kFull, c, off);
        k += __shfl_xor_sync(kFull, k, off);
      }
    }
    const long long e = e0 + t * P + slot;
    if (lane % (2 * S) == 0 && e < n_edges) {
      out_c[e] = (int)c;
      out_k[e] = k;
    }
  }
}

template <int S, int R>
int launch(const void* window, const void* weights, const void* active,
           const void* row, const void* col, void* out_c, void* out_k,
           long long n_edges, int d, cudaStream_t stream) {
  constexpr long long per_block = (long long)kWarps * kSteps * (32 / (2 * S));
  const long long blocks = (n_edges + per_block - 1) / per_block;
  wedge_match_kernel<S, R><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      (const int*)window, (const int*)weights, (const unsigned char*)active,
      (const int*)row, (const int*)col, (int*)out_c, (int*)out_k, n_edges, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wedge_intersect_launch(
    const void* window, const void* weights, const void* active,
    const void* row, const void* col, void* out_c, void* out_k,
    long long n_edges, int d, int vec16, void* stream) {
  (void)vec16;     // a lane reads one entry
  const cudaStream_t s = (cudaStream_t)stream;
#define WEDGE_LAUNCH(S, R)                                                 \
  launch<S, R>(window, weights, active, row, col, out_c, out_k, n_edges, d, \
               s)
  if (d < 1 || d > 32) return (int)cudaErrorInvalidValue;
  if (d == 1) return WEDGE_LAUNCH(1, 1);
  if (d == 2) return WEDGE_LAUNCH(2, 1);
  if (d <= 4) return WEDGE_LAUNCH(4, 1);
  if (d <= 8) return WEDGE_LAUNCH(8, 1);
  if (d <= 16) return WEDGE_LAUNCH(16, 1);
  return WEDGE_LAUNCH(16, 2);
#undef WEDGE_LAUNCH
}
