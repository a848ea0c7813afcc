// Variant kept to be timed against (tools/segment_fused_variants.py): the
// redesign's heavy-block split as first written, where the thread blocks
// that share a row block write partial accumulators to scratch, count
// themselves done, and the last to finish folds the partials.  Its C
// interface is the committed kernel's plus a scratch pointer, sized by
// segment_fused_scratch.
//
// Fused blocked segment sum / max / min / bitwise-OR over int32 payloads.
//
// Replaces src/repro/kernels/segment_coo/kernel.py:segment_fused_blocked,
// the TPU kernel behind engine.aggregate.  Same function: for every output
// row, the sum, max, min and OR (of the low or_nbits bits) of each payload
// column over the row's edges; empty rows get 0 / INT32_MIN / INT32_MAX / 0.
//
// Layout: the host packs the row-sorted edge list into blocked ELL
// (pack_blocks): row block k owns output rows [k*r_blk, (k+1)*r_blk) and the
// slots edge_perm[k, :], lrow[k, :] (lrow outside [0, r_blk) marks a padding
// slot).  extent[k] is one past the block's last live slot
// (engine.SegPlan.extent); pack_blocks writes a block's live slots first,
// so every slot from extent[k] on is padding.
//
// Bound: bytes of the live slots.  Per call the kernel must read each row
// block's extent, each live slot's lrow and edge_perm, each live edge's
// payload row once, and write n_rows x D* int32; there is almost no
// arithmetic.  What the design does about it:
//  * Padding.  A thread block stops at its row block's extent, so no
//    padding slot after it is read.  E_BLK is set by the plan's heaviest
//    block (2,952 slots at RGG 2^20, p 4, against a mean of 507; 13,112 in
//    a serve_m chunk, where most blocks hold about a hundred), so sweeping
//    all E_BLK slots read mostly padding.  Padding inside the extent is
//    still skipped by the lrow test, so any plan stays right.
//  * Runs of one row.  A partition puts every padding edge on its nil row
//    (about 13,100 slots of one row in each serve_m instance), and a
//    block's slots are row-sorted, so most warps there hold one row only.
//    Such a warp folds each column with one __reduce_*_sync and one lane
//    issues the shared atomic, instead of 32 atomics to one address that
//    serialise.  A warp over several rows (RGG: about 8 slots a row) gives
//    each live slot its own atomic: folding those runs too, by a segmented
//    shuffle scan or by __reduce_*_sync over each row's lane mask, was
//    measured slower (tools/segment_fused_variants.py).
//  * Heavy blocks.  Thread block k takes row block k.  In a plan whose
//    row blocks may hold more than kChunk slots (a serve chunk's nil
//    blocks) and whose instances have at most kScanBlocks row blocks, each
//    instance also gets as many extra thread blocks as its live slots fill
//    chunks.  Extra thread block i takes the i-th later chunk of the heavy
//    blocks in row-block order, found by a prefix sum over the instance's
//    extents (a chunk the extras cannot cover stays with its row block's
//    own thread block).  The thread blocks of a shared row block write
//    their partial accumulators to scratch and count themselves done; the
//    last to finish folds the partials and writes the rows.  No thread
//    block is launched for a chunk that cannot exist, and a light row
//    block's own thread block neither scans nor shares.
//  * Registers.  What bounds the kernel in practice is how many slots are
//    in flight, so it keeps few registers: one slot a thread a round, its
//    next round's lrow and edge_perm loaded while its payloads are
//    gathered; the fold and the split are separate code paths (the split
//    a separate instantiation), so a plan that needs neither does not pay
//    their registers.
//  * Stores.  Accumulators are kept group by group, so each group's rows of
//    a block are one contiguous store (no [n_blocks, e_blk, D] blocked copy
//    of a payload is written or read back either: the gather is here).
// Integer add / max / min / or are associative and commutative, so the
// order of the folds, the atomics and the partials' merge changes no bit:
// the result is the reference's.
//
// Batch axis (the serving layer's stacked plans; the reference vmaps the
// TPU kernel there): grid axis y is the instance b.  Instance b's plan is
// the b-th [n_blocks, e_blk] slab with extents extent[b, :], its edge ids
// index the payload rows [b*e_stride, (b+1)*e_stride) and its output rows
// are [b*n_rows, (b+1)*n_rows), with the ragged last row block guarded per
// instance.  A batch of 1 is the unbatched launch.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kGroupCols = 2;  // columns of each payload group loaded at once
constexpr int kChunk = 1024;   // live slots a thread block takes at most
constexpr int kScanBlocks = 4 * kThreads;  // row blocks an instance may
                                           // have for its blocks to split
constexpr int kGroups = 4;     // sum, max, min, or
constexpr unsigned kWarp = 0xffffffffu;

struct Groups {
  const int* in[kGroups];  // [(B*)E, width] payloads (unread if width 0)
  int* out[kGroups];       // [(B*)n_rows, width] results
  int width[kGroups];
  int or_mask;
};

// Group g's identity (0 / INT_MIN / INT_MAX / 0) and operation.
__device__ __forceinline__ int identity(int g) {
  return g == 1 ? INT_MIN : g == 2 ? INT_MAX : 0;
}

__device__ __forceinline__ int combine(int g, int a, int b) {
  if (g == 0) return (int)((unsigned)a + (unsigned)b);  // wraps as int32
  if (g == 1) return max(a, b);
  if (g == 2) return min(a, b);
  return a | b;
}

// Group G's fold over the whole warp, and its shared atomic.
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

// Group G's columns [c0, c0 + kGroupCols) of one slot (row r, edge e; r < 0
// is padding): gathered, folded over the warp if kFold (the warp holds one
// row), and added into the shared accumulators [off, off + r_blk * width)
// by this lane (by lane 31 alone if kFold).
template <int G, bool kFold>
__device__ __forceinline__ void add_group(const Groups& p, int c0, int* acc,
                                          int off, int r, long long e,
                                          int lane) {
  const int w = p.width[G];
  int v[kGroupCols];
#pragma unroll
  for (int q = 0; q < kGroupCols; ++q) {
    v[q] = identity(G);
    if (c0 + q < w && r >= 0) {
      v[q] = __ldg(p.in[G] + e * w + c0 + q);
      if (G == 3) v[q] &= p.or_mask;
    }
  }
#pragma unroll
  for (int q = 0; q < kGroupCols; ++q) {
    if (c0 + q >= w) break;  // the same for the whole warp
    if (kFold) v[q] = warp_fold<G>(v[q]);
    if (r >= 0 && (!kFold || lane == 31))
      accumulate<G>(acc + off + r * w + c0 + q, v[q]);
  }
}

template <bool kFold>
__device__ __forceinline__ void add_slot(const Groups& p, int* acc,
                                         const int (&off)[kGroups + 1],
                                         int max_w, int r, long long e,
                                         int lane) {
  for (int c0 = 0; c0 < max_w; c0 += kGroupCols) {
    add_group<0, kFold>(p, c0, acc, off[0], r, e, lane);
    add_group<1, kFold>(p, c0, acc, off[1], r, e, lane);
    add_group<2, kFold>(p, c0, acc, off[2], r, e, lane);
    add_group<3, kFold>(p, c0, acc, off[3], r, e, lane);
  }
}

// Exclusive prefix sum of v over the thread block (every thread calls it).
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kWarp, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[threadIdx.x >> 5] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) before += s_warp[w];
  return before + incl - v;
}

// kSplit: the plan's row blocks may be shared with extra thread blocks
// (n_extra > 0); without it, thread block k sweeps all of row block k.
// The two are separate instantiations so that a plan that never splits
// does not pay the split's registers.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads) segment_fused_kernel(
    const int* __restrict__ edge_perm, const int* __restrict__ lrow,
    const int* __restrict__ extent, Groups p, int* __restrict__ scratch,
    int n_blocks, int n_split, int n_extra, int e_blk, int r_blk,
    int n_rows, long long e_stride) {
  extern __shared__ int acc[];  // group by group, [r_blk, width] each
  __shared__ bool s_last;
  __shared__ int s_warp[kThreads / 32], s_work[3];
  int off[kGroups + 1];
  off[0] = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) off[g + 1] = off[g] + r_blk * p.width[g];
  const int n_acc = off[kGroups];
  const int max_w = max(max(p.width[0], p.width[1]),
                        max(p.width[2], p.width[3]));

  // What this thread block sweeps.  Thread block k < n_blocks takes row
  // block k from its first slot; with kSplit an instance's row blocks of
  // more than kChunk live slots hand their later chunks to the n_extra
  // thread blocks after them, in row-block order (a prefix sum of every
  // block's extra chunks), and row block k keeps the chunks that find no
  // thread block.  `shared` counts the thread blocks of row block k.
  const long long b = blockIdx.y;
  int blk = blockIdx.x, chunk = 0, shared = 1;
  // (a row block of one chunk needs no scan: no other thread block shares it)
  if (kSplit && (blk >= n_blocks || extent[b * n_blocks + blk] > kChunk)) {
    if (threadIdx.x == 0) s_work[0] = -1;
    int more[4], total = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * threadIdx.x + q;
      const int x = k < n_blocks
          ? min(max(extent[b * n_blocks + k], 0), e_blk) : 0;
      more[q] = max(0, (x + kChunk - 1) / kChunk - 1);
      total += more[q];
    }
    int before = block_exclusive_sum(total, s_warp);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * threadIdx.x + q;
      const int handed = min(max(n_extra - before, 0), more[q]);
      const int e = (int)blockIdx.x - n_blocks - before;  // extra chunk e
      if (k == (int)blockIdx.x && k < n_blocks)
        s_work[0] = k, s_work[1] = 0, s_work[2] = 1 + handed;
      else if (e >= 0 && e < more[q])
        s_work[0] = k, s_work[1] = 1 + e, s_work[2] = 1 + handed;
      before += more[q];
    }
    __syncthreads();
    blk = s_work[0], chunk = s_work[1], shared = s_work[2];
    if (blk < 0) return;  // the instance has fewer extra chunks
  }
  const long long slab = b * n_blocks + blk;  // this row block's plan row
  const int end = min(max(extent[slab], 0), e_blk);
  // [lo, hi), then (row block k's own thread block) the chunks no other
  // thread block took: [lo2, end)
  int lo = 0, hi = end, lo2 = end;
  if (kSplit) {
    lo = min(end, chunk * kChunk);
    hi = min(end, lo + kChunk);
    if (blk == (int)blockIdx.x) lo2 = min(end, shared * kChunk);
  }

  for (int i = threadIdx.x; i < n_acc; i += kThreads)
    acc[i] = identity((i >= off[1]) + (i >= off[2]) + (i >= off[3]));
  __syncthreads();

  const int* lr = lrow + slab * e_blk;
  const int* ep = edge_perm + slab * e_blk;
  const int lane = threadIdx.x & 31;
  // One slot a thread a round; its next round's lrow and edge_perm are
  // loaded while its payloads are gathered.
  auto sweep = [&](const int first, const int stop) {
    int j = first + threadIdx.x;
    int rn = j < stop ? __ldg(lr + j) : -1;
    int en = j < stop ? __ldg(ep + j) : 0;
    for (int base = first; base < stop; base += kThreads) {
      const int r = rn < 0 || rn >= r_blk ? -1 : rn;  // -1: padding
      const long long e = b * e_stride + en;
      j = base + kThreads + threadIdx.x;
      rn = j < stop ? __ldg(lr + j) : -1;
      en = j < stop ? __ldg(ep + j) : 0;
      const int up = __shfl_up_sync(kWarp, r, 1);
      const bool one_row = __all_sync(kWarp, lane == 0 || up == r);
      if (one_row) add_slot<true>(p, acc, off, max_w, r, e, lane);
      else add_slot<false>(p, acc, off, max_w, r, e, lane);
    }
  };
  sweep(lo, hi);
  if (kSplit) sweep(lo2, end);
  __syncthreads();

  if (kSplit && shared > 1) {
    // scratch: a done-counter per row block (zeroed by the launcher), then
    // [row block, chunk] partial accumulator sets
    int* parts = scratch + (long long)gridDim.y * n_blocks
                 + slab * n_split * n_acc;
    for (int i = threadIdx.x; i < n_acc; i += kThreads)
      parts[chunk * n_acc + i] = acc[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(scratch + slab, 1) == shared - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      const int g = (i >= off[1]) + (i >= off[2]) + (i >= off[3]);
      int x = acc[i];
      for (int c0 = 0; c0 < shared; c0 += 4) {  // 4 partials' loads at once
        int y[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + q;
          y[q] = c < shared && c != chunk ? __ldcg(parts + c * n_acc + i)
                                          : identity(g);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) x = combine(g, x, y[q]);
      }
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

// Chunks of kChunk slots a row block may hold (e_blk bounds every extent).
int n_splits(int e_blk) {
  const int n = (e_blk + kChunk - 1) / kChunk;
  return n > 1 ? n : 1;
}

// Extra thread blocks an instance gets for its heavy row blocks' later
// chunks: as many as its live slots can fill (e_stride / kChunk: each edge
// has one slot in a plan that pack_blocks built; a row block keeps the
// chunks that find none), none if no row block can split or the instance
// has too many row blocks to scan.
int n_extras(int n_blocks, int e_blk, int e_stride) {
  const int n_split = n_splits(e_blk);
  if (n_split == 1 || n_blocks > kScanBlocks) return 0;
  const long long most = (long long)n_blocks * (n_split - 1);
  const int fill = e_stride / kChunk > 1 ? e_stride / kChunk : 1;
  return most < fill ? (int)most : fill;
}

}  // namespace

// Scratch (int32 elements) a launch of these shapes needs: none unless row
// blocks split; then a counter per row block and a partial accumulator set
// per (row block, chunk).
extern "C" long long segment_fused_scratch(int batch, int n_blocks, int e_blk,
                                           int r_blk, int d_total,
                                           int e_stride) {
  if (n_extras(n_blocks, e_blk, e_stride) == 0) return 0;
  const long long slabs = (long long)batch * n_blocks;
  return slabs + slabs * n_splits(e_blk) * r_blk * d_total;
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
  const int n_extra = n_extras(n_blocks, e_blk, e_stride);
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_extra > 0) {
    const cudaError_t err = cudaMemsetAsync(
        scratch, 0, sizeof(int) * (size_t)batch * n_blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = sizeof(int) * (size_t)r_blk * (ds + dm + dn + d_o);
  const dim3 grid(n_blocks + n_extra, batch);
  auto kernel = n_extra > 0 ? segment_fused_kernel<true>
                            : segment_fused_kernel<false>;
  kernel<<<grid, kThreads, smem, s>>>(
      (const int*)edge_perm, (const int*)lrow, (const int*)extent, p,
      (int*)scratch, n_blocks, n_splits(e_blk), n_extra, e_blk, r_blk,
      n_rows, e_stride);
  return (int)cudaGetLastError();
}
