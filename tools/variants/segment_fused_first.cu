// Fused blocked segment sum / max / min / bitwise-OR over int32 payloads:
// the first design of the port (one thread block a row block, sweeping all
// e_blk slots, one shared atomic a live slot and column), kept to be timed
// against (tools/segment_fused_variants.py).  Its C interface is the one
// before the live extent: no extent, no scratch.
//
// Replaces repro/kernels/segment_coo/kernel.py:segment_fused_blocked, the
// TPU kernel behind engine.aggregate.  Same function: for every output row,
// the sum, max, min and OR (of the low or_nbits bits) of each payload column
// over the row's edges; empty rows get 0 / INT32_MIN / INT32_MAX / 0.
//
// Layout: the host packs the row-sorted edge list into blocked ELL
// (pack_blocks): row block b owns output rows [b*r_blk, (b+1)*r_blk) and the
// slots edge_perm[b, :], lrow[b, :] (lrow == r_blk marks a padding slot).
// One thread block per row block keeps its [r_blk, Ds+Dm+Dn+Do] int32
// accumulators in shared memory; threads stride over the block's e_blk slots
// and fold each live edge in with shared-memory integer atomics.  Integer
// add/max/min/or are associative and commutative, so the result does not
// depend on the order the atomics land in: it is bit-identical to the
// reference.
//
// Batch axis (the serving layer's stacked plans; the reference vmaps the
// TPU kernel there): grid axis y is the instance b.  Instance b's plan is the
// b-th [n_blocks, e_blk] slab, its edge ids index the payload rows
// [b*e_stride, (b+1)*e_stride) and its output rows are
// [b*n_rows, (b+1)*n_rows), with the ragged last row block guarded per
// instance.  A batch of 1 (e_stride unused) is the unbatched launch.
//
// Bound: bytes.  Per call the kernel must read lrow (and edge_perm for live
// slots) once, each live edge's payload row once, and write n_rows x D* int32;
// there is almost no arithmetic.  What the design does about it: the payload
// gather happens here, through edge_perm, so no [n_blocks, e_blk, D] blocked
// copy of any payload is written and read back (the TPU path materialised
// one per group), and a padding slot costs a 4-byte lrow read only.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void segment_fused_kernel(
    const int* __restrict__ edge_perm, const int* __restrict__ lrow,
    const int* __restrict__ d_sum, const int* __restrict__ d_max,
    const int* __restrict__ d_min, const int* __restrict__ d_or,
    int* __restrict__ o_sum, int* __restrict__ o_max,
    int* __restrict__ o_min, int* __restrict__ o_or,
    int e_blk, int r_blk, int n_rows, long long e_stride,
    int ds, int dm, int dn, int d_o, unsigned or_mask) {
  extern __shared__ int acc[];  // [r_blk, dt]
  const int dt = ds + dm + dn + d_o;
  const int n_acc = r_blk * dt;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const int c = i % dt;
    acc[i] = c < ds ? 0 : c < ds + dm ? INT_MIN : c < ds + dm + dn ? INT_MAX : 0;
  }
  __syncthreads();

  const long long b = blockIdx.y;
  const long long base = (b * gridDim.x + blockIdx.x) * e_blk;
  for (int j = threadIdx.x; j < e_blk; j += blockDim.x) {
    const int r = lrow[base + j];
    if (r < 0 || r >= r_blk) continue;  // padding slot
    const long long e = b * e_stride + edge_perm[base + j];
    int* a = acc + r * dt;
    for (int c = 0; c < ds; ++c) atomicAdd(a + c, d_sum[e * ds + c]);
    a += ds;
    for (int c = 0; c < dm; ++c) atomicMax(a + c, d_max[e * dm + c]);
    a += dm;
    for (int c = 0; c < dn; ++c) atomicMin(a + c, d_min[e * dn + c]);
    a += dn;
    for (int c = 0; c < d_o; ++c)
      atomicOr(a + c, (int)((unsigned)d_or[e * d_o + c] & or_mask));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const int r = i / dt;
    int c = i % dt;
    const int local = blockIdx.x * r_blk + r;
    if (local >= n_rows) continue;
    const long long row = b * n_rows + local;
    if (c < ds) { o_sum[row * ds + c] = acc[i]; continue; }
    c -= ds;
    if (c < dm) { o_max[row * dm + c] = acc[i]; continue; }
    c -= dm;
    if (c < dn) { o_min[row * dn + c] = acc[i]; continue; }
    c -= dn;
    o_or[row * d_o + c] = acc[i];
  }
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// Absent payload groups pass a width of 0 (their pointers are not read).
// `batch` instances of `n_blocks` row blocks each; `n_rows` and `e_stride`
// are per instance.
extern "C" int segment_fused_launch(
    const void* edge_perm, const void* lrow,
    const void* d_sum, const void* d_max, const void* d_min, const void* d_or,
    void* o_sum, void* o_max, void* o_min, void* o_or,
    int batch, int n_blocks, int e_blk, int r_blk, int n_rows, int e_stride,
    int ds, int dm, int dn, int d_o, int or_nbits, void* stream) {
  const unsigned or_mask = (1u << or_nbits) - 1u;
  const size_t smem = sizeof(int) * (size_t)r_blk * (ds + dm + dn + d_o);
  const dim3 grid(n_blocks, batch);
  segment_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)edge_perm, (const int*)lrow,
      (const int*)d_sum, (const int*)d_max, (const int*)d_min,
      (const int*)d_or, (int*)o_sum, (int*)o_max, (int*)o_min, (int*)o_or,
      e_blk, r_blk, n_rows, e_stride, ds, dm, dn, d_o, or_mask);
  return (int)cudaGetLastError();
}
