// Per-edge weighted intersection of capped neighbor windows (int32):
// one thread an edge, sorted merge.  Same function and C interface as
// src/repro_torch/kernels/wedge_intersect/csrc/wedge_intersect.cu (only
// d = 16, aligned: a variant to be timed); 
// wedge_unsorted_edges() counts the edges that took the all-pairs path.
//
// The partition lays each window out ascending, nil (the PE's largest
// index) padding last.  A thread reads W(row) and W(col) as 16-byte
// vectors, checks both are ascending (D - 1 compares each) and then walks
// them in one merge through shared memory (transposed, one column of words
// a thread, so lanes at different positions never share a bank): W(row)
// advances on every step that does not move W(col), so each position of
// W(row) is tested once, duplicates included, as the reference's any(-1).
// The hits form a bit mask; activity and weight are read for its bits.  An
// edge with an unsorted window takes the all-pairs compare in registers.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
__device__ unsigned long long g_unsorted = 0;  // see wedge_unsorted_edges

template <int D>
__global__ void __launch_bounds__(kThreads) wedge_merge_kernel(
    const int* __restrict__ window, const int* __restrict__ weights,
    const unsigned char* __restrict__ active, const int* __restrict__ row,
    const int* __restrict__ col, int* __restrict__ out_c,
    int* __restrict__ out_k,
    long long n_edges) {
  __shared__ int su[D * kThreads];
  __shared__ int sv[D * kThreads];
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const int* wu = window + (long long)row[e] * D;
  const int* wv = window + (long long)col[e] * D;
  int u[D], v[D];
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const int4 a = reinterpret_cast<const int4*>(wu)[q];
    const int4 b = reinterpret_cast<const int4*>(wv)[q];
    u[4 * q] = a.x; u[4 * q + 1] = a.y; u[4 * q + 2] = a.z;
    u[4 * q + 3] = a.w;
    v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z;
    v[4 * q + 3] = b.w;
  }
  bool sorted = true;
#pragma unroll
  for (int i = 1; i < D; ++i) sorted &= u[i - 1] <= u[i] && v[i - 1] <= v[i];
  unsigned hits = 0;
  if (sorted) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      su[i * kThreads + threadIdx.x] = u[i];
      sv[i * kThreads + threadIdx.x] = v[i];
    }
    int i = 0, j = 0;
    while (i < D && j < D) {
      const int a = su[i * kThreads + threadIdx.x];
      const int b = sv[j * kThreads + threadIdx.x];
      hits |= (unsigned)(a == b) << i;
      i += a <= b;
      j += a > b;
    }
  } else {
    atomicAdd(&g_unsorted, 1ull);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      bool hit = false;
#pragma unroll
      for (int j = 0; j < D; ++j) hit |= u[i] == v[j];
      hits |= (unsigned)hit << i;
    }
  }
  unsigned c = 0;
  int k = 0;
#pragma unroll
  for (int i = 0; i < D; ++i)
    if (((hits >> i) & 1) && active[u[i]]) {
      c += (unsigned)weights[u[i]];
      ++k;
    }
  out_c[e] = (int)c;
  out_k[e] = k;
}

}  // namespace

extern "C" int wedge_intersect_launch(
    const void* window, const void* weights, const void* active,
    const void* row, const void* col, void* out_c, void* out_k,
    long long n_edges, int d, int vec16, void* stream) {
  if (d != 16 || !vec16) return (int)cudaErrorInvalidValue;  // a variant
  const long long blocks = (n_edges + kThreads - 1) / kThreads;
  wedge_merge_kernel<16><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)window, (const int*)weights, (const unsigned char*)active,
      (const int*)row, (const int*)col, (int*)out_c, (int*)out_k,
      n_edges);
  return (int)cudaGetLastError();
}

// The edges that took the all-pairs compare since the last call; resets.
extern "C" unsigned long long wedge_unsorted_edges() {
  unsigned long long n = 0;
  const unsigned long long zero = 0;
  cudaMemcpyFromSymbol(&n, g_unsorted, sizeof(n));
  cudaMemcpyToSymbol(g_unsorted, &zero, sizeof(zero));
  return n;
}
