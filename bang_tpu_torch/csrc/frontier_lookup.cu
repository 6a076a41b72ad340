// K2 frontier_lookup: candidate ids and PQ distances straight from the
// ungathered fused frontier rows.
//
//   tables  [Q, m, 256] f32     per-query PQ distance tables
//   rows    [N, R*(4+m)] u8     fused rows: 4 little-endian id byte-planes
//                               of R bytes, then m chunk-major code groups
//                               of R bytes (ops/pq_kernels.pack_frontier_rows)
//   parents [Q, beam] i32       rows to expand for each query
//   ids     [Q, beam*R] i32     ids[q, b*R + j]  = neighbor j of parent b
//   dists   [Q, beam*R] f32     dists[q, b*R + j] = sum_c T[q, c, code_cj]
//
// Replaces the Pallas kernels frontier_lookup (bang_tpu/ops/pq_pallas.py:267,
// bodies _frontier_kernel :167 and _frontier_kernel_r32 :197) and
// frontier_lookup_dma (:411, body _frontier_dma_kernel :345): the fused
// gather + lookup of the reference's compute_neighborDist_par
// (BANG_Base/bang_search.cu:1201-1241). Like the DMA form, the kernel reads
// each parent's row itself, so no [Q, beam, row] copy is written to device
// memory. None of the Mosaic limits carry over (R=64 only, m%2, m%4,
// beam*R <= 128, the R=32 lane-rotation decode): any R, any m up to the
// shared-memory bound, any beam.
//
// What bounds it on an H100: bytes, and the tables dominate. At the main
// path's shape (Q=10K, m=64, R=64, beam=2) each call streams ~655 MB of
// tables against ~87 MB of rows (10K x 2 x 4352 B), so the floor is ~0.22 ms
// at 3.35 TB/s; the adds are trivial. Cutting the table traffic (bf16 or
// fp8 tables, several queries' work per table load) is work for later.
//
// Design: one block per query; the block stages the query's table in
// dynamic shared memory with 16-byte loads, then one thread per (parent,
// neighbor) lane decodes the id (shift-or of the 4 planes) and sums the m
// table entries. With the chunk-major layout the R threads of one parent
// read each chunk's R codes as consecutive bytes, so the row reads
// coalesce. A parent outside [0, N) reads nothing and yields id -1 and
// +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCenters = 256;
constexpr int kThreads = 256;

__global__ void frontier_lookup_kernel(const float* __restrict__ tables,
                                       const uint8_t* __restrict__ rows,
                                       const int32_t* __restrict__ parents,
                                       int32_t* __restrict__ ids,
                                       float* __restrict__ dists, int64_t n,
                                       int r, int m, int beam) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const int64_t q = blockIdx.x;

  const float4* src =
      reinterpret_cast<const float4*>(tables + q * (int64_t)m * kCenters);
  const int n4 = m * (kCenters / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = src[i];
  __syncthreads();

  const int c = beam * r;
  const int64_t row_w = (int64_t)r * (4 + m);
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    const int b = t / r;
    const int j = t - b * r;
    const int64_t p = parents[q * beam + b];
    const int64_t o = q * c + t;
    if (p < 0 || p >= n) {
      ids[o] = -1;
      dists[o] = INFINITY;
      continue;
    }
    const uint8_t* row = rows + p * row_w;
    const uint32_t id = (uint32_t)row[j] | ((uint32_t)row[r + j] << 8) |
                        ((uint32_t)row[2 * r + j] << 16) |
                        ((uint32_t)row[3 * r + j] << 24);
    const uint8_t* cm = row + 4 * r + j;
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s += tab[k * kCenters + cm[k * r]];
    ids[o] = (int32_t)id;
    dists[o] = s;
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch.
extern "C" int frontier_lookup_launch(const void* tables, const void* rows,
                                      const void* parents, void* ids,
                                      void* dists, long long n, int q, int r,
                                      int m, int beam, void* stream) {
  const size_t smem = (size_t)m * kCenters * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  frontier_lookup_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(tables), static_cast<const uint8_t*>(rows),
      static_cast<const int32_t*>(parents), static_cast<int32_t*>(ids),
      static_cast<float*>(dists), (int64_t)n, r, m, beam);
  return (int)cudaGetLastError();
}

extern "C" const char* frontier_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
