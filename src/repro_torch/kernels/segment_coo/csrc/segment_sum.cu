// Blocked segment sum over float payloads (float32 or bfloat16).
//
// Replaces repro/kernels/segment_coo/kernel.py:segment_sum_blocked, the TPU
// kernel behind segment_sum_coo.  Same function: for every output row, the
// sum of each payload column over the row's edges, accumulated in float32
// and rounded to the payload's type once (the TPU kernel's one-hot matmul
// with preferred_element_type=f32); empty rows get 0.
//
// Layout: the host packs the row-sorted edge list into blocked ELL
// (pack_blocks): row block b owns output rows [b*r_blk, (b+1)*r_blk) and the
// slots edge_perm[b, :], lrow[b, :] (lrow == r_blk marks a padding slot).
// Grid (n_blocks, ceil(d / kCols)): one thread block per row block and
// column tile, one thread per payload column.  The block stages kCols slots
// of (lrow, edge_perm) at a time in shared memory; every thread then walks
// the slots in order and adds its column of each live edge's payload row to
// its own [r_blk] float32 accumulators (a shared-memory column no other
// thread touches).  No atomics: every output element is summed in slot order,
// so the result is the same on every run.
//
// Bound: bytes.  Per call the kernel must read lrow (and edge_perm for live
// slots) once, each live edge's payload row once, and write n_rows x d
// values; it does one add per payload element read.  What the design does
// about it: the payload gather happens here, through edge_perm, so the
// [n_blocks, e_blk, d] blocked copy the TPU path materialised is never
// written; neighbouring threads read neighbouring columns of one payload
// row, so every row is one coalesced read; four slots' loads are issued
// before their adds so several rows are in flight per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // payload columns per block = threads per block
constexpr int kUnroll = 4;  // slots whose loads are issued together

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

template <typename T>
__global__ void __launch_bounds__(kCols) segment_sum_kernel(
    const int* __restrict__ edge_perm, const int* __restrict__ lrow,
    const T* __restrict__ data, T* __restrict__ out,
    int e_blk, int r_blk, int n_rows, int d) {
  extern __shared__ float acc[];  // [r_blk, kCols]; column threadIdx.x is ours
  __shared__ int s_row[kCols];
  __shared__ int s_edge[kCols];
  const int t = threadIdx.x;
  const int c = blockIdx.y * kCols + t;  // payload column of this thread
  const bool live_col = c < d;
  for (int r = 0; r < r_blk; ++r) acc[r * kCols + t] = 0.f;

  const long long base = (long long)blockIdx.x * e_blk;
  for (int j0 = 0; j0 < e_blk; j0 += kCols) {
    const int n = min(kCols, e_blk - j0);
    __syncthreads();  // the previous stage is consumed
    if (t < n) {
      const int r = lrow[base + j0 + t];
      s_row[t] = (r < 0 || r >= r_blk) ? -1 : r;  // -1: padding slot
      s_edge[t] = edge_perm[base + j0 + t];
    }
    __syncthreads();
    if (!live_col) continue;
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      int r[kUnroll];
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = s_row[j + u];
        x[u] = r[u] < 0 ? 0.f
                        : to_f32(data[(long long)s_edge[j + u] * d + c]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r[u] >= 0) acc[r[u] * kCols + t] += x[u];
    }
    for (; j < n; ++j) {
      const int r = s_row[j];
      if (r >= 0)
        acc[r * kCols + t] += to_f32(data[(long long)s_edge[j] * d + c]);
    }
  }
  if (!live_col) return;
  const long long row0 = (long long)blockIdx.x * r_blk;
  for (int r = 0; r < r_blk && row0 + r < n_rows; ++r)
    out[(row0 + r) * d + c] = from_f32<T>(acc[r * kCols + t]);
}

template <typename T>
int launch(const void* edge_perm, const void* lrow, const void* data,
           void* out, int n_blocks, int e_blk, int r_blk, int n_rows, int d,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)r_blk * kCols;
  // beyond 48 KB a block's shared memory (the 1 KB staged slots included)
  // needs the opt-in
  if (smem + 2 * kCols * sizeof(int) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segment_sum_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_blocks, (d + kCols - 1) / kCols);
  segment_sum_kernel<T><<<grid, kCols, smem, stream>>>(
      (const int*)edge_perm, (const int*)lrow, (const T*)data, (T*)out,
      e_blk, r_blk, n_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// dtype: 0 = float32, 1 = bfloat16 (data and out).
extern "C" int segment_sum_launch(
    const void* edge_perm, const void* lrow, const void* data, void* out,
    int n_blocks, int e_blk, int r_blk, int n_rows, int d, int dtype,
    void* stream) {
  if (dtype == 0)
    return launch<float>(edge_perm, lrow, data, out, n_blocks, e_blk, r_blk,
                         n_rows, d, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(edge_perm, lrow, data, out, n_blocks, e_blk,
                                 r_blk, n_rows, d, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
