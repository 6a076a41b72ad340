// K5 frontier_packed: candidate ids and PQ distances from gathered frontier
// rows, over bf16-pair tables.
//
//   packed  [Q, m, 128] i32     bf16-pair tables (ops/pq.pack_tables)
//   rows    [Q, beam, P*R + m*R] u8   each query's gathered parent rows:
//                               P in {0, 4} little-endian id byte-planes of
//                               R bytes, then m chunk-major groups of R
//                               codes (the fused frontier row when P = 4)
//   ids     [Q, beam*R] i32     ids[q, b*R + j] = neighbor j of parent b
//                               (written only when P = 4)
//   dists   [Q, beam*R] f32     dists[q, b*R + j] = sum_c bf16(T)[q, c,
//                               code_cj], summed in f32
//
// Replaces two Pallas probes of the JAX package's scripts/:
//   fused_lookup  scripts/exp_fused.py:79  (body _kernel_fused :48), P = 4:
//                 the prototype of K2's fused row, on gathered rows;
//   v7            scripts/exp_flat2.py:148 (body _kernel_v7 :128), P = 0:
//                 the same lookup over chunk-major codes without ids.
// None of the Mosaic limits carry over (R < 128 lane tiling, the
// lanes-to-sublanes retile): any R <= 64, any m up to the shared-memory
// bound, any beam <= 16.
//
// What bounds it on an H100: bytes. At Q=10K, m=64, R=64, beam 2 a call
// reads 327.7 MB of packed tables and the 87.0 MB of gathered rows (81.9 MB
// without the id planes) and writes 10.2 MB of ids and distances (5.1 MB
// without ids): 425.0 MB, a floor of ~0.127 ms at 3.35 TB/s (v7: 414.7 MB,
// ~0.124 ms). K2 reads the same rows ungathered but streams f32 tables
// (~0.225 ms); the gather that feeds K5 (K6) costs 174 MB more.
//
// Design: K2's (csrc/frontier_lookup.cu) over the packed table. One block
// per query stages the query's 32 KB packed table (m=64) in dynamic shared
// memory with 16-byte loads, then one thread per (parent, neighbor) lane
// decodes the id (shift-or of the 4 planes) and sums the m entries. With
// the chunk-major layout the R threads of one parent read each chunk's R
// codes as consecutive bytes, so the row reads coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kWords = 128;  // packed words per (query, chunk) row
constexpr int kThreads = 256;

__global__ void frontier_packed_kernel(const int32_t* __restrict__ packed,
                                       const uint8_t* __restrict__ rows,
                                       int32_t* __restrict__ ids,
                                       float* __restrict__ dists, int r, int m,
                                       int beam, int id_planes,
                                       unsigned long long* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ uint4 smem4[];
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem4);
  const int64_t q = blockIdx.x;

  const uint4* src =
      reinterpret_cast<const uint4*>(packed + q * (int64_t)m * kWords);
  const int n4 = m * (kWords / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = src[i];
  __syncthreads();

  const int c = beam * r;
  const int64_t row_w = (int64_t)(id_planes + m) * r;
  for (int t = threadIdx.x; t < c; t += blockDim.x) {
    const int b = t / r;
    const int j = t - b * r;
    const int64_t o = q * c + t;
    const uint8_t* row = rows + (q * beam + b) * row_w;
    if (id_planes == 4) {
      ids[o] = (int32_t)((uint32_t)row[j] | ((uint32_t)row[r + j] << 8) |
                         ((uint32_t)row[2 * r + j] << 16) |
                         ((uint32_t)row[3 * r + j] << 24));
    }
    const uint8_t* cm = row + id_planes * r + j;
    float s = 0.0f;
    for (int k = 0; k < m; ++k) {
      const uint32_t code = cm[k * r];
      const uint32_t w = tab[k * kWords + (code >> 1)];
      s += __uint_as_float(((w >> ((code & 1u) << 4)) & 0xFFFFu) << 16);
    }
    dists[o] = s;
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. ids may be null when
// id_planes == 0.
extern "C" int frontier_packed_launch(const void* packed, const void* rows,
                                      void* ids, void* dists, int q, int r,
                                      int m, int beam, int id_planes,
                                      void* launches, void* stream) {
  if (id_planes != 0 && id_planes != 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m * kWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      frontier_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  frontier_packed_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const uint8_t*>(rows),
      static_cast<int32_t*>(ids), static_cast<float*>(dists), r, m, beam,
      id_planes, static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

extern "C" const char* frontier_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
