// Blocked segment sum over float payloads (float32 or bfloat16).
//
// Replaces repro/kernels/segment_coo/kernel.py:segment_sum_blocked, the TPU
// kernel behind segment_sum_coo.  Same function: for every output row, the
// sum of each payload column over the row's edges, accumulated in float32
// and rounded to the payload's type once (the TPU kernel's one-hot matmul
// with preferred_element_type=f32); empty rows get 0.
//
// Layout: the host packs the edge list into blocked ELL (pack_blocks): row
// block b owns output rows [b*r_blk, (b+1)*r_blk) and the slots
// edge_perm[b, :], lrow[b, :] (lrow outside [0, r_blk) marks a padding
// slot).  The op promises nothing about the order of the slots or where
// the padding sits.
//
// Work is split by warps.  One item is (row block, column span): a span is
// 32 lanes x VEC contiguous columns, VEC (1, 2 or 4) chosen by the wrapper
// from the row pitch's and the payload pointer's alignment.  A grid of as
// many blocks as fit the card at once walks the items in a grid-stride
// loop, one warp per item.  For each chunk of kStage slots the warp votes
// on which are live, compacts the live (row, edge) pairs into shared memory
// by a ballot prefix sum, and skips a chunk with none.  It then walks the
// live slots in order, kUnroll payload loads in flight per lane, keeping a
// register sum while consecutive slots share a row and adding it into the
// warp's [r_blk, 32*VEC] float32 accumulator in shared memory (its own
// columns only) when the row changes.  Every (row, column) is owned by one
// lane, so there are no atomics and the bits are the same on every run;
// rows sorted by slot (as pack_blocks packs them) are summed in slot order
// with one shared-memory add a row.  An item with no live slot only stores
// its zeros.
//
// Bound: bytes.  Per call the kernel must read lrow once, edge_perm for the
// live slots, each live edge's payload row once, and write n_rows x d
// values; it does one float32 add per payload element read.  What the
// design does about it: the payload gather happens here, so the blocked
// copy the TPU path materialised is never written; a lane reads 4-16 bytes
// of a payload row per load and a warp 128-512 contiguous bytes; kUnroll
// independent loads a lane keep enough bytes in flight to cover the memory
// latency; padding costs one lrow read, and an empty row block costs its
// lrow and its zero stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarp = 32;
constexpr int kStage = 128;   // slots a warp stages at a time
constexpr int kUnroll = 8;    // payload loads in flight per lane
constexpr int kMaxWarps = 8;  // warps per thread block
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

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

// Shared memory of one warp: acc [r_blk][VEC][32] floats (lane-minor, so
// the lanes of a warp hit 32 banks), then the staged rows and edges,
// [kStage] each.
__host__ __device__ constexpr size_t warp_smem(int r_blk, int vec) {
  return sizeof(float) * (size_t)r_blk * kWarp * vec + 2 * sizeof(int) * kStage;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxWarps * kWarp) segment_sum_kernel(
    const int* __restrict__ edge_perm, const int* __restrict__ lrow,
    const T* __restrict__ data, T* __restrict__ out, int n_blocks, int e_blk,
    int r_blk, int n_rows, int d) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  float* acc = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + warp * warp_smem(r_blk, VEC));
  int* s_row = reinterpret_cast<int*>(acc + (size_t)r_blk * kWarp * VEC);
  int* s_edge = s_row + kStage;
  float* my_acc = acc + lane;  // (row r, column v): my_acc[at(r, v)]
  auto at = [](int r, int v) { return (r * VEC + v) * kWarp; };
  for (int r = 0; r < r_blk; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) my_acc[at(r, v)] = 0.f;

  const int n_spans = (d + kWarp * VEC - 1) / (kWarp * VEC);
  const long long n_items = (long long)n_blocks * n_spans;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (long long item = (long long)blockIdx.x * warps + warp; item < n_items;
       item += (long long)gridDim.x * warps) {
    const int blk = (int)(item / n_spans);
    const int col = ((int)(item % n_spans) * kWarp + lane) * VEC;
    const bool live_col = col < d;  // d is a multiple of VEC
    const long long base = (long long)blk * e_blk;
    const T* src = data + col;
    int cur = -1;          // row of the running sum (-1: none yet)
    float run[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) run[v] = 0.f;
    bool any_live = false;

    for (int j0 = 0; j0 < e_blk; j0 += kStage) {
      // stage: vote, then compact the live slots of the chunk in order
      int n_live = 0;
#pragma unroll
      for (int h = 0; h < kStage / kWarp; ++h) {
        const int j = j0 + h * kWarp + lane;
        int r = -1;
        if (j < e_blk) {
          r = lrow[base + j];
          if (r < 0 || r >= r_blk) r = -1;
        }
        const unsigned live = __ballot_sync(kFull, r >= 0);
        if (r >= 0) {
          const int pos = n_live + __popc(live & lt_mask);
          s_row[pos] = r;
          s_edge[pos] = edge_perm[base + j];
        }
        n_live += __popc(live);
      }
      __syncwarp();
      if (n_live == 0) continue;
      any_live = true;
      // walk: kUnroll loads in flight, then the adds in slot order
      for (int k = 0; k < n_live; k += kUnroll) {
        int rr[kUnroll];
        Vec<T, VEC> x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          rr[u] = k + u < n_live ? s_row[k + u] : -1;
          if (rr[u] >= 0 && live_col) {
            x[u] = *reinterpret_cast<const Vec<T, VEC>*>(
                src + (long long)s_edge[k + u] * d);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) x[u].v[v] = from_f32<T>(0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] < 0) continue;  // past the live slots: warp-uniform
          if (rr[u] != cur) {
            if (cur >= 0)
#pragma unroll
              for (int v = 0; v < VEC; ++v) my_acc[at(cur, v)] += run[v];
            cur = rr[u];
#pragma unroll
            for (int v = 0; v < VEC; ++v) run[v] = to_f32(x[u].v[v]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) run[v] += to_f32(x[u].v[v]);
          }
        }
      }
      __syncwarp();  // the walk is done before the next chunk is staged
    }
    if (cur >= 0)
#pragma unroll
      for (int v = 0; v < VEC; ++v) my_acc[at(cur, v)] += run[v];

    if (!live_col) continue;  // a dead lane's accumulators hold only zeros
    const long long row0 = (long long)blk * r_blk;
    const int rows = (int)max(0LL, min((long long)r_blk, n_rows - row0));
    for (int r = 0; r < rows; ++r) {
      Vec<T, VEC> y;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = 0.f;
        if (any_live) {
          s = my_acc[at(r, v)];
          my_acc[at(r, v)] = 0.f;
        }
        y.v[v] = from_f32<T>(s);
      }
      *reinterpret_cast<Vec<T, VEC>*>(out + (row0 + r) * d + col) = y;
    }
    // rows past n_rows (the last block) were never written out: clear them
    if (any_live)
      for (int r = rows; r < r_blk; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) my_acc[at(r, v)] = 0.f;
  }
}

template <typename T, int VEC>
int launch(const void* edge_perm, const void* lrow, const void* data,
           void* out, int n_blocks, int e_blk, int r_blk, int n_rows, int d,
           cudaStream_t stream) {
  auto kernel = segment_sum_kernel<T, VEC>;
  const size_t per_warp = warp_smem(r_blk, VEC);
  int optin = 0, sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_warp > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int warps = (int)std::min<size_t>(kMaxWarps, optin / per_warp);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    warps * kWarp, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_spans = (d + kWarp * VEC - 1) / (kWarp * VEC);
  const long long blocks_needed =
      ((long long)n_blocks * n_spans + warps - 1) / warps;
  const int grid =
      (int)std::min<long long>(blocks_needed, (long long)std::max(per_sm, 1) * sms);
  kernel<<<grid, warps * kWarp, smem, stream>>>(
      (const int*)edge_perm, (const int*)lrow, (const T*)data, (T*)out,
      n_blocks, e_blk, r_blk, n_rows, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(const void* edge_perm, const void* lrow, const void* data,
               void* out, int n_blocks, int e_blk, int r_blk, int n_rows,
               int d, int vec, cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch<T, 1>(edge_perm, lrow, data, out, n_blocks, e_blk, r_blk,
                          n_rows, d, stream);
    case 2:
      return launch<T, 2>(edge_perm, lrow, data, out, n_blocks, e_blk, r_blk,
                          n_rows, d, stream);
    case 4:
      return launch<T, 4>(edge_perm, lrow, data, out, n_blocks, e_blk, r_blk,
                          n_rows, d, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// dtype: 0 = float32, 1 = bfloat16 (data and out).  vec: columns a lane
// reads at once (1, 2 or 4); d must be a multiple of it and data / out
// aligned to vec elements.
extern "C" int segment_sum_launch(
    const void* edge_perm, const void* lrow, const void* data, void* out,
    int n_blocks, int e_blk, int r_blk, int n_rows, int d, int dtype, int vec,
    void* stream) {
  if (d % vec != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_vec<float>(edge_perm, lrow, data, out, n_blocks, e_blk,
                             r_blk, n_rows, d, vec, (cudaStream_t)stream);
  if (dtype == 1)
    return launch_vec<__nv_bfloat16>(edge_perm, lrow, data, out, n_blocks,
                                     e_blk, r_blk, n_rows, d, vec,
                                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
