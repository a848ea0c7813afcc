// Sum-mode EmbeddingBag with per-sample weights (float32 or bfloat16 table):
// the first design of the port, a warp a bag with narrow rows split over
// lane groups by lookup, kept to be timed against
// (tools/embedding_bag_variants.py).
//
// Replaces repro/kernels/embedding_bag/kernel.py:embedding_bag_fused, the
// TPU kernel behind embedding_bag.  Same function:
//     out[b, :] = sum_k wgt[b, k] * table[idx[b, k], :]
// accumulated in float32 and written in the table's type.  Indices are
// taken to be in range: the kernel does not clamp (as JAX's gather does) or
// raise (as torch's does).
//
// Layout: one warp per bag, eight bags per block; the ragged end of the
// batch is masked (a warp past the last bag returns), where the TPU kernel
// padded B to a multiple of its bag tile.  A table row is read as 16-byte
// vectors, neighbouring lanes on neighbouring vectors.  When a row is
// narrower than the warp (bfloat16 at D = 128 is 16 vectors), the warp
// splits into groups that each take every (32 / width)-th lookup of the bag,
// and the groups' partial sums meet by shuffles; wider rows are walked by
// all 32 lanes.
//
// Bound: bytes.  Each lookup must read one table row (D x 2 or 4 bytes)
// and the bag's idx and wgt, and each bag writes one row; there are two
// flops per element read.  What the design does about it: every row is read
// once, as whole 16-byte vectors, straight from device memory into
// registers (the TPU kernel's per-row DMA); the gathered [B, K, D] rows of
// the plain version are never written; the weighted sum stays in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // bags per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32) embedding_bag_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ wgt, T* __restrict__ out, int n_bags,
    int k_bag, int d) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_bags) return;  // the whole warp: b is the same for its lanes
  const int n_vec = d / VEC;  // vectors per row
  // width lanes cover one row (n_vec when it divides 32); groups of them
  // take every groups-th lookup
  const int width = (n_vec < 32 && 32 % n_vec == 0) ? n_vec : 32;
  const int groups = 32 / width;
  const int g = lane / width;
  const int* bag_idx = idx + b * k_bag;
  const float* bag_wgt = wgt + b * k_bag;
  const Vec<T, VEC>* rows = reinterpret_cast<const Vec<T, VEC>*>(table);
  Vec<T, VEC>* dst = reinterpret_cast<Vec<T, VEC>*>(out + b * d);
  for (int c = lane % width; c < n_vec; c += width) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = g; k < k_bag; k += groups) {
      const Vec<T, VEC> x = rows[(long long)bag_idx[k] * n_vec + c];
      const float w = bag_wgt[k];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += w * to_f32(x.v[i]);
    }
    // groups > 1 only when every lane runs exactly one c: all lanes shuffle
    for (int off = width; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
    if (g == 0) {
      Vec<T, VEC> y;
#pragma unroll
      for (int i = 0; i < VEC; ++i) y.v[i] = from_f32<T>(acc[i]);
      dst[c] = y;
    }
  }
}

template <typename T, int VEC>
int launch(const void* table, const void* idx, const void* wgt, void* out,
           int n_bags, int k_bag, int d, cudaStream_t stream) {
  const int blocks = (n_bags + kWarps - 1) / kWarps;
  embedding_bag_kernel<T, VEC><<<blocks, kWarps * 32, 0, stream>>>(
      (const T*)table, (const int*)idx, (const float*)wgt, (T*)out, n_bags,
      k_bag, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// dtype: 0 = float32, 1 = bfloat16 (table and out).  vec16: rows move as
// 16-byte vectors (d x element size a multiple of 16, table 16-byte
// aligned); otherwise one element at a time.  n_bags >= 1, k_bag >= 1.
// n_rows is the committed kernel's table height; this first design reads
// indices unchecked and ignores it (its callers pass ids in range).
extern "C" int embedding_bag_launch(
    const void* table, const void* idx, const void* wgt, void* out,
    int n_bags, int k_bag, int d, int n_rows, int dtype, int vec16,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec16 ? launch<float, 4>(table, idx, wgt, out, n_bags, k_bag, d, s)
                 : launch<float, 1>(table, idx, wgt, out, n_bags, k_bag, d, s);
  if (dtype == 1)
    return vec16
        ? launch<__nv_bfloat16, 8>(table, idx, wgt, out, n_bags, k_bag, d, s)
        : launch<__nv_bfloat16, 1>(table, idx, wgt, out, n_bags, k_bag, d, s);
  return (int)cudaErrorInvalidValue;
}
