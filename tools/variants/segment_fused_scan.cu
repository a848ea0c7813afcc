// Fused blocked segment sum / max / min / bitwise-OR over int32 payloads:
// the port's second redesign for the live slots, kept to be timed against
// (tools/segment_fused_variants.py).  It has the committed kernel's C
// interface, live extents and splits, but folds every run of neighbouring
// lanes of one row by a segmented shuffle scan (as many steps as the
// warp's longest run needs) before one atomic per run and column, and
// keeps 2 slots a thread in flight without prefetching the next round.
// On RGG plans (about 8 slots a row) the scan costs more than the
// conflicting atomics it saves.
//
// Replaces src/repro/kernels/segment_coo/kernel.py:segment_fused_blocked;
// see src/repro_torch/kernels/segment_coo/csrc/segment_fused.cu for the
// function, the layout and the batch axis.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kUnroll = 2;     // slots a thread keeps in flight
constexpr int kGroupCols = 2;  // columns of each payload group loaded at once
constexpr int kChunk = 4096;   // live slots a thread block takes at most
constexpr int kGroups = 4;     // sum, max, min, or

struct Groups {
  const int* in[kGroups];  // [(B*)E, width] payloads (unread if width 0)
  int* out[kGroups];       // [(B*)n_rows, width] results
  int width[kGroups];
  int or_mask;
};

constexpr unsigned kWarp = 0xffffffffu;

// Group G's identity, its fold over the whole warp, and its shared atomic.
template <int G>
__device__ __forceinline__ int identity() {
  return G == 1 ? INT_MIN : G == 2 ? INT_MAX : 0;
}

template <int G>
__device__ __forceinline__ int warp_fold(int v) {
  if (G == 0) return (int)__reduce_add_sync(kWarp, (unsigned)v);
  if (G == 1) return __reduce_max_sync(kWarp, v);
  if (G == 2) return __reduce_min_sync(kWarp, v);
  return (int)__reduce_or_sync(kWarp, (unsigned)v);
}

template <int G>
__device__ __forceinline__ void accumulate(int* a, int v) {
  if (G == 0) atomicAdd(a, v);
  else if (G == 1) atomicMax(a, v);
  else if (G == 2) atomicMin(a, v);
  else atomicOr(a, v);
}

// The same for a group known only at run time (accumulator set-up and the
// merge of a split block's partials).
__device__ __forceinline__ int identity_of(int g) {
  return g == 1 ? INT_MIN : g == 2 ? INT_MAX : 0;
}

__device__ __forceinline__ int combine(int g, int a, int b) {
  if (g == 0) return (int)((unsigned)a + (unsigned)b);  // wraps as int32
  if (g == 1) return max(a, b);
  if (g == 2) return min(a, b);
  return a | b;
}

// Load kGroupCols columns (from column c0) of group G for the lane's slots.
template <int G>
__device__ __forceinline__ void load_group(
    const Groups& p, int c0, const int (&r)[kUnroll],
    const long long (&e)[kUnroll], int (&v)[kUnroll][kGroups][kGroupCols]) {
  const int w = p.width[G];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int q = 0; q < kGroupCols; ++q) {
      const int c = c0 + q;
      int x = identity<G>();
      if (c < w && r[u] >= 0) {
        x = __ldg(p.in[G] + e[u] * w + c);
        if (G == 3) x &= p.or_mask;
      }
      v[u][G][q] = x;
    }
}

template <int G>
__device__ __forceinline__ int op(int a, int b) {
  if (G == 0) return (int)((unsigned)a + (unsigned)b);  // wraps as int32
  if (G == 1) return max(a, b);
  if (G == 2) return min(a, b);
  return a | b;
}

// How one slot's row sits in the warp: the lanes that start a run of one
// row, the first lane of this lane's run, and the longest run.
struct Runs {
  unsigned heads;
  int start;
  int span;
  bool tail;  // this lane ends its run
};

__device__ __forceinline__ Runs runs_of(int r, int lane) {
  Runs x;
  const int up = __shfl_up_sync(kWarp, r, 1);
  x.heads = __ballot_sync(kWarp, lane == 0 || up != r);
  x.start = 31 - __clz(x.heads & (kWarp >> (31 - lane)));
  x.span = (int)__reduce_max_sync(kWarp, (unsigned)(lane - x.start + 1));
  x.tail = lane == 31 || ((x.heads >> lane >> 1) & 1u);
  return x;
}

// Fold group G's columns over each run of lanes and add each run's value
// into the shared accumulators [off, off + r_blk * width).
template <int G>
__device__ __forceinline__ void fold_group(
    const Groups& p, int c0, int* acc, int off, const Runs& x, int lane,
    int r, const int (&v)[kGroups][kGroupCols]) {
  const int w = p.width[G];
#pragma unroll
  for (int q = 0; q < kGroupCols; ++q) {
    if (c0 + q >= w) break;  // the same for the whole warp
    int s = v[G][q];
    if (x.heads == 1u) {
      s = warp_fold<G>(s);  // the whole warp is one run
    } else {
      for (int d = 1; d < x.span; d <<= 1) {  // segmented scan
        const int y = __shfl_up_sync(kWarp, s, d);
        if (lane - d >= x.start) s = op<G>(s, y);
      }
    }
    if (x.tail && r >= 0) accumulate<G>(acc + off + r * w + c0 + q, s);
  }
}

__global__ void __launch_bounds__(kThreads) segment_fused_kernel(
    const int* __restrict__ edge_perm, const int* __restrict__ lrow,
    const int* __restrict__ extent, Groups p, int* __restrict__ scratch,
    int n_blocks, int n_split, int e_blk, int r_blk, int n_rows,
    long long e_stride) {
  extern __shared__ int acc[];  // group by group, [r_blk, width] each
  __shared__ bool s_last;
  int off[kGroups + 1];
  off[0] = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) off[g + 1] = off[g] + r_blk * p.width[g];
  const int n_acc = off[kGroups];
  const int max_w = max(max(p.width[0], p.width[1]),
                        max(p.width[2], p.width[3]));

  const int blk = blockIdx.x / n_split;
  const int split = blockIdx.x - blk * n_split;
  const long long b = blockIdx.y;
  const long long slab = b * n_blocks + blk;  // this row block's plan row
  const int end = min(max(extent[slab], 0), e_blk);
  const int n_chunks = max(1, (end + kChunk - 1) / kChunk);
  if (split >= n_chunks) return;  // the row block needs fewer thread blocks

  for (int i = threadIdx.x; i < n_acc; i += kThreads)
    acc[i] = identity_of((i >= off[1]) + (i >= off[2]) + (i >= off[3]));
  __syncthreads();

  const int* lr = lrow + slab * e_blk;
  const int* ep = edge_perm + slab * e_blk;
  const int lane = threadIdx.x & 31;
  const int first = split * kChunk;
  const int stop = min(end, first + kChunk);
  for (int base = first; base < stop; base += kThreads * kUnroll) {
    int r[kUnroll];
    long long e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads + threadIdx.x;
      r[u] = j < stop ? __ldg(lr + j) : -1;
      e[u] = j < stop ? __ldg(ep + j) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r[u] < 0 || r[u] >= r_blk) r[u] = -1;  // padding slot
      e[u] += b * e_stride;
    }
    for (int c0 = 0; c0 < max_w; c0 += kGroupCols) {
      int v[kUnroll][kGroups][kGroupCols];
      load_group<0>(p, c0, r, e, v);
      load_group<1>(p, c0, r, e, v);
      load_group<2>(p, c0, r, e, v);
      load_group<3>(p, c0, r, e, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // runs of neighbouring lanes of one row (padding lanes run as -1)
        const Runs x = runs_of(r[u], lane);
        fold_group<0>(p, c0, acc, off[0], x, lane, r[u], v[u]);
        fold_group<1>(p, c0, acc, off[1], x, lane, r[u], v[u]);
        fold_group<2>(p, c0, acc, off[2], x, lane, r[u], v[u]);
        fold_group<3>(p, c0, acc, off[3], x, lane, r[u], v[u]);
      }
    }
  }
  __syncthreads();

  if (n_chunks > 1) {
    // scratch: a done-counter per row block (zeroed by the launcher), then
    // [row block, split] partial accumulator sets
    int* parts = scratch + (long long)gridDim.y * n_blocks
                 + slab * n_split * n_acc;
    for (int i = threadIdx.x; i < n_acc; i += kThreads)
      parts[split * n_acc + i] = acc[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(scratch + slab, 1) == n_chunks - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      const int g = (i >= off[1]) + (i >= off[2]) + (i >= off[3]);
      int x = acc[i];
      for (int s = 0; s < n_chunks; ++s)
        if (s != split) x = combine(g, x, __ldcg(parts + s * n_acc + i));
      acc[i] = x;
    }
    __syncthreads();
  }

  const int rows = min(r_blk, n_rows - blk * r_blk);  // ragged last block
  const long long row0 = b * n_rows + (long long)blk * r_blk;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int w = p.width[g];
    for (int i = threadIdx.x; i < rows * w; i += kThreads)
      p.out[g][row0 * w + i] = acc[off[g] + i];
  }
}

// Thread blocks a row block may need: e_blk bounds every extent.
int n_splits(int e_blk) {
  const int n = (e_blk + kChunk - 1) / kChunk;
  return n > 1 ? n : 1;
}

}  // namespace

// Scratch (int32 elements) a launch of these shapes needs: none unless a row
// block can hold more than kChunk live slots; then a counter per row block
// and a partial accumulator set per (row block, chunk).
extern "C" long long segment_fused_scratch(int batch, int n_blocks, int e_blk,
                                           int r_blk, int d_total,
                                           int /*e_stride*/) {
  const int n_split = n_splits(e_blk);
  if (n_split == 1) return 0;
  const long long slabs = (long long)batch * n_blocks;
  return slabs + slabs * n_split * r_blk * d_total;
}

// Launch on `stream` without synchronising; returns the first CUDA error.
// Absent payload groups pass a width of 0 (their pointers are not read).
// `batch` instances of `n_blocks` row blocks each; `n_rows` and `e_stride`
// are per instance; `scratch` holds segment_fused_scratch(...) int32
// elements (null when that is 0).
extern "C" int segment_fused_launch(
    const void* edge_perm, const void* lrow, const void* extent,
    const void* d_sum, const void* d_max, const void* d_min, const void* d_or,
    void* o_sum, void* o_max, void* o_min, void* o_or, void* scratch,
    int batch, int n_blocks, int e_blk, int r_blk, int n_rows, int e_stride,
    int ds, int dm, int dn, int d_o, int or_nbits, void* stream) {
  Groups p;
  const void* in[kGroups] = {d_sum, d_max, d_min, d_or};
  void* out[kGroups] = {o_sum, o_max, o_min, o_or};
  const int width[kGroups] = {ds, dm, dn, d_o};
  for (int g = 0; g < kGroups; ++g) {
    p.in[g] = (const int*)in[g];
    p.out[g] = (int*)out[g];
    p.width[g] = width[g];
  }
  p.or_mask = (int)((1u << or_nbits) - 1u);
  const int n_split = n_splits(e_blk);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_split > 1) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(int) * (size_t)batch * n_blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = sizeof(int) * (size_t)r_blk * (ds + dm + dn + d_o);
  const dim3 grid(n_blocks * n_split, batch);
  segment_fused_kernel<<<grid, kThreads, smem, s>>>(
      (const int*)edge_perm, (const int*)lrow, (const int*)extent, p,
      (int*)scratch, n_blocks, n_split, e_blk, r_blk, n_rows, e_stride);
  return (int)cudaGetLastError();
}
