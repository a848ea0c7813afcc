// The embedding_bag kernels as they stood before the backward was redesigned:
// the first design of the backward (one thread a bag and column vector, one
// global vector atomic a lookup), kept unchanged to be timed against
// (tools/embedding_bag_variants.py --backward).
//
// Sum-mode EmbeddingBag with per-sample weights (float32 or bfloat16 table).
//
// Replaces repro/kernels/embedding_bag/kernel.py:embedding_bag_fused, the
// TPU kernel behind embedding_bag.  Same function:
//     out[b, :] = sum_k wgt[b, k] * table[idx[b, k], :]
// accumulated in float32, k = 0 .. K-1 in order, and written in the table's
// type (one rounding).  An index is read as the reference's table[idx] reads
// it: a negative one wraps once (+ V), then it is clamped into [0, V - 1],
// in registers, one wrap and one clamp a lookup; no index reads outside the
// table.
//
// Layout: a table row is read as 16-byte vectors (one element when the row
// or the table is not 16-byte aligned), neighbouring lanes on neighbouring
// vectors; the ragged end of the batch is masked, where the TPU kernel
// padded B to a multiple of its bag tile.  Two paths, by the row's width in
// vectors (n_vec):
//   narrow (n_vec <= 16, e.g. bfloat16 at D = 128): the warp splits into
//     32 / n_vec lane groups and each group owns whole bags, several at a
//     time; a lane sums its column of each bag, loading the bags' indices
//     and weights ahead and several lookups a bag at once, so that it keeps
//     four row loads in flight (kBagsPerGroup x kUnroll; at K = 1,
//     kSingleHotBags bags of one lookup); no lane waits on another and no
//     shuffle is needed;
//   wide (n_vec > 16, e.g. float32 at D = 128): one warp per bag, lanes
//     walking the row's vectors with stride 32.
//
// A lookup's liveness (bag and k in range) is kept apart from its index, so
// every index, -1 included, is a row.
//
// Bound: bytes.  Each lookup must read one table row (D x 2 or 4 bytes)
// and the bag's idx and wgt, and each bag writes one row; there are two
// flops per element read.  What the design does about it: every row is read
// once, as whole 16-byte vectors, straight from device memory into
// registers (the TPU kernel's per-row DMA), with several independent loads
// in flight per lane to cover the latency of random rows; the gathered
// [B, K, D] rows of the plain version are never written; the weighted sum
// stays in registers.
//
// The backward (embedding_bag_bwd_launch) is the port's own: the reference
// has no backward kernel, JAX differentiates jnp.take.  It computes the
// table's gradient
//     grad[r, :] += wgt[b, k] * grad_out[b, :]   for every live lookup,
// into a zeroed float32 [V, D] buffer.  A lookup is live when its index,
// wrapped once if negative, lies in [0, V): JAX's gather transposes to a
// scatter that drops the cotangent of an index it clamped in the forward,
// so an index out of range after the wrap adds nothing and its weight (NaN
// in DLRM's lookup) is never read.  Layout: one thread per (bag, column
// vector of 4 floats, or 1 where the row or a pointer is not aligned), so
// a warp reads grad_out[b] coalesced; a thread loads its vector once and
// adds w * g into each of its bag's K rows, one vector atomicAdd (float4,
// global memory, sm_90) a lookup.  Atomics add in any order, so the sums
// agree with the plain version within float32 rounding, not bit for bit.
// Lookups of one row serialise on its addresses (DLRM's tables of 3 to 14
// rows take every bag of a batch on a handful of rows).
// Bound: bytes.  It must read grad_out once, idx and wgt once, and read
// and write each touched row of the buffer once; one float32 FMA per
// element of each live lookup.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block
// narrow rows: the bags a lane group takes at once and the lookups of a bag
// loaded together, for single-hot bags (K = 1) and for the others
constexpr int kSingleHotBags = 4;
constexpr int kBagsPerGroup = 2;
constexpr int kUnroll = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
// The reference's table[idx]: wrap a negative index once, then clamp.
__device__ __forceinline__ long long table_row(int i, int v) {
  const int w = i < 0 ? i + v : i;
  return (long long)min(max(w, 0), v - 1);
}

template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC elements of T move as one load / store (16 bytes, or one element).
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Narrow rows: the lane groups of the grid, numbered in order, own BAGS
// consecutive bags each; lane c of a group (c < n_vec) sums column vector c
// of each of its bags, UNROLL lookups a bag at a time.
template <typename T, int VEC, int BAGS, int UNROLL>
__global__ void __launch_bounds__(kWarps * 32) embedding_bag_narrow(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wgt, T* __restrict__ out, int n_bags,
    int k_bag, int n_vec, int n_rows) {
  const int lane = threadIdx.x & 31;
  const int groups = 32 / n_vec;  // lane groups a warp
  const int g = lane / n_vec;
  const int c = lane - g * n_vec;
  if (g >= groups) return;  // lanes left over: n_vec does not divide 32
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long first = (warp * groups + g) * BAGS;
  const Vec<T, VEC>* rows = reinterpret_cast<const Vec<T, VEC>*>(table);
  Vec<T, VEC>* dst = reinterpret_cast<Vec<T, VEC>*>(out);
  float acc[BAGS][VEC];
#pragma unroll
  for (int j = 0; j < BAGS; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.f;
  for (int k0 = 0; k0 < k_bag; k0 += UNROLL) {
    long long row[BAGS][UNROLL];
    float w[BAGS][UNROLL];
    bool live[BAGS][UNROLL];
#pragma unroll
    for (int j = 0; j < BAGS; ++j)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long b = first + j;
        live[j][u] = b < n_bags && k0 + u < k_bag;
        row[j][u] = live[j][u]
            ? table_row(idx[b * k_bag + k0 + u], n_rows) : 0;
        w[j][u] = live[j][u] ? wgt[b * k_bag + k0 + u] : 0.f;
      }
    Vec<T, VEC> x[BAGS][UNROLL];
#pragma unroll
    for (int j = 0; j < BAGS; ++j)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (live[j][u]) x[j][u] = rows[row[j][u] * n_vec + c];
#pragma unroll
    for (int j = 0; j < BAGS; ++j)
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (live[j][u]) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[j][i] += w[j][u] * to_f32(x[j][u].v[i]);
        }
  }
#pragma unroll
  for (int j = 0; j < BAGS; ++j) {
    const long long b = first + j;
    if (b >= n_bags) break;
    Vec<T, VEC> y;
#pragma unroll
    for (int i = 0; i < VEC; ++i) y.v[i] = from_f32<T>(acc[j][i]);
    dst[b * n_vec + c] = y;
  }
}

// Wide rows: one warp per bag, lane c sums column vectors c, c + 32, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32) embedding_bag_wide(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wgt, T* __restrict__ out, int n_bags,
    int k_bag, int n_vec, int n_rows) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_bags) return;  // the whole warp: b is the same for its lanes
  const int* bag_idx = idx + b * k_bag;
  const float* bag_wgt = wgt + b * k_bag;
  const Vec<T, VEC>* rows = reinterpret_cast<const Vec<T, VEC>*>(table);
  Vec<T, VEC>* dst = reinterpret_cast<Vec<T, VEC>*>(out + b * n_vec * VEC);
  for (int c = lane; c < n_vec; c += 32) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < k_bag; ++k) {
      const Vec<T, VEC> x = rows[table_row(bag_idx[k], n_rows) * n_vec + c];
      const float w = bag_wgt[k];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += w * to_f32(x.v[i]);
    }
    Vec<T, VEC> y;
#pragma unroll
    for (int i = 0; i < VEC; ++i) y.v[i] = from_f32<T>(acc[i]);
    dst[c] = y;
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, const void* wgt, void* out,
           int n_bags, int k_bag, int d, int n_rows, cudaStream_t stream) {
  const int n_vec = d / VEC;  // vectors per row
  if (n_vec <= 16) {
    // single-hot bags load no lookup ahead (the registers of kUnroll rows
    // would only cost resident warps) and take more bags at once instead
    const int bags = k_bag == 1 ? kSingleHotBags : kBagsPerGroup;
    const long long per_block = (long long)kWarps * (32 / n_vec) * bags;
    const unsigned blocks = (unsigned)((n_bags + per_block - 1) / per_block);
    if (k_bag == 1)
      embedding_bag_narrow<T, VEC, kSingleHotBags, 1>
          <<<blocks, kWarps * 32, 0, stream>>>(
              (const T*)table, (const int*)idx, (const float*)wgt, (T*)out,
              n_bags, k_bag, n_vec, n_rows);
    else
      embedding_bag_narrow<T, VEC, kBagsPerGroup, kUnroll>
          <<<blocks, kWarps * 32, 0, stream>>>(
              (const T*)table, (const int*)idx, (const float*)wgt, (T*)out,
              n_bags, k_bag, n_vec, n_rows);
  } else {
    const int blocks = (n_bags + kWarps - 1) / kWarps;
    embedding_bag_wide<T, VEC><<<blocks, kWarps * 32, 0, stream>>>(
        (const T*)table, (const int*)idx, (const float*)wgt, (T*)out, n_bags,
        k_bag, n_vec, n_rows);
  }
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 256;  // threads a block of the backward

// grad[row, c*VEC ...] += v[0..VEC-1]: one float4 atomic on sm_90.
template <int VEC>
__device__ __forceinline__ void add_vec(float* dst, const float* v) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, v[i]);
  }
}

// Thread t owns bag t / n_vec and its column vector t % n_vec.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads) embedding_bag_bwd(
    const T* __restrict__ grad_out, const int* __restrict__ idx,
    const float* __restrict__ wgt, float* __restrict__ grad,
    long long n_items, int k_bag, int n_vec, int n_rows) {
  const long long t = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (t >= n_items) return;
  const long long b = t / n_vec;
  const int c = (int)(t - b * n_vec);
  const Vec<T, VEC> x = reinterpret_cast<const Vec<T, VEC>*>(grad_out)[t];
  float g[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) g[i] = to_f32(x.v[i]);
  for (int k = 0; k < k_bag; ++k) {
    int r = idx[b * k_bag + k];
    if (r < 0) r += n_rows;
    if (r < 0 || r >= n_rows) continue;  // dropped, as JAX's scatter does
    const float w = wgt[b * k_bag + k];
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = w * g[i];
    add_vec<VEC>(grad + ((long long)r * n_vec + c) * VEC, v);
  }
}

template <typename T, int VEC>
int launch_bwd(const void* grad_out, const void* idx, const void* wgt,
               void* grad, int n_bags, int k_bag, int d, int n_rows,
               cudaStream_t stream) {
  const int n_vec = d / VEC;
  const long long n_items = (long long)n_bags * n_vec;
  const unsigned blocks = (unsigned)((n_items + kBwdThreads - 1) / kBwdThreads);
  embedding_bag_bwd<T, VEC><<<blocks, kBwdThreads, 0, stream>>>(
      (const T*)grad_out, (const int*)idx, (const float*)wgt, (float*)grad,
      n_items, k_bag, n_vec, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward: add the table's gradient into `grad` ([n_rows, d] float32,
// zeroed by the caller) on `stream` without synchronising; returns
// cudaGetLastError().  dtype: 0 = float32, 1 = bfloat16 (grad_out).
// vec4: d a multiple of 4, grad_out aligned to 4 elements and grad to 16
// bytes; otherwise one element at a time.  n_bags, k_bag, d >= 1.
extern "C" int embedding_bag_bwd_launch(
    const void* grad_out, const void* idx, const void* wgt, void* grad,
    int n_bags, int k_bag, int d, int n_rows, int dtype, int vec4,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return vec4 ? launch_bwd<float, 4>(grad_out, idx, wgt, grad, n_bags,
                                       k_bag, d, n_rows, s)
                : launch_bwd<float, 1>(grad_out, idx, wgt, grad, n_bags,
                                       k_bag, d, n_rows, s);
  if (dtype == 1)
    return vec4 ? launch_bwd<bf16, 4>(grad_out, idx, wgt, grad, n_bags,
                                      k_bag, d, n_rows, s)
                : launch_bwd<bf16, 1>(grad_out, idx, wgt, grad, n_bags,
                                      k_bag, d, n_rows, s);
  return (int)cudaErrorInvalidValue;
}

// Launch on `stream` without synchronising; returns cudaGetLastError().
// dtype: 0 = float32, 1 = bfloat16 (table and out).  vec16: rows move as
// 16-byte vectors (d x element size a multiple of 16, table 16-byte
// aligned); otherwise one element at a time.  n_bags >= 1, k_bag >= 1,
// n_rows (the table's V) >= 1.
extern "C" int embedding_bag_launch(
    const void* table, const void* idx, const void* wgt, void* out,
    int n_bags, int k_bag, int d, int n_rows, int dtype, int vec16,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int v = n_rows;
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return vec16
        ? launch<float, 4>(table, idx, wgt, out, n_bags, k_bag, d, v, s)
        : launch<float, 1>(table, idx, wgt, out, n_bags, k_bag, d, v, s);
  if (dtype == 1)
    return vec16
        ? launch<bf16, 8>(table, idx, wgt, out, n_bags, k_bag, d, v, s)
        : launch<bf16, 1>(table, idx, wgt, out, n_bags, k_bag, d, v, s);
  return (int)cudaErrorInvalidValue;
}
