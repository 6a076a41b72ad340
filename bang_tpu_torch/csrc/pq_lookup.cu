// K1 pq_lookup: PQ distance accumulation over gathered candidate codes.
//
//   out[q, j] = sum_c tables[q, c, codes[q, j, c]]
//   tables [Q, m, 256] f32, codes [Q, C, m] u8, out [Q, C] f32.
//
// Replaces the Pallas kernel pq_lookup_packed (bang_tpu/ops/pq_pallas.py:74,
// body _lookup_kernel :44), itself the re-design of the reference's
// compute_neighborDist_par PQ path (BANG_Base/bang_search.cu:1201-1241).
// The TPU kernel packs the tables as bf16 pairs so one (query, chunk) row
// fits a 128-lane vreg for Mosaic's lane gather; that trick is not needed
// here and the tables stay f32.
//
// What bounds it on an H100: bytes. Every query reads its whole m x 256 f32
// table (64 KB at m=64) once per call, against C*m code bytes (8 KB at
// C=128, m=64) and C*4 output bytes: at Q=10K, m=64, C=128 that is ~655 MB
// of tables and ~82 MB of codes per call, so table streaming sets the floor
// (~0.22 ms at 3.35 TB/s). The arithmetic (C*m adds per query) is trivial.
//
// Design: one block per query. The block copies the query's table into
// dynamic shared memory with 16-byte loads (the only HBM pass over it), then
// each thread accumulates one candidate over all m chunks from shared
// memory, reading that candidate's m codes as one contiguous row. Above
// 48 KB of shared memory the launch raises the kernel's dynamic limit; the
// wrapper refuses tables above 227 KB (m > 227).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCenters = 256;
constexpr int kThreads = 256;

__global__ void pq_lookup_kernel(const float* __restrict__ tables,
                                 const uint8_t* __restrict__ codes,
                                 float* __restrict__ out, int c, int m) {
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const int64_t q = blockIdx.x;

  const float4* src =
      reinterpret_cast<const float4*>(tables + q * (int64_t)m * kCenters);
  const int n4 = m * (kCenters / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = src[i];
  __syncthreads();

  const uint8_t* qcodes = codes + q * (int64_t)c * m;
  float* qout = out + q * (int64_t)c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const uint8_t* row = qcodes + (int64_t)j * m;
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s += tab[k * kCenters + row[k]];
    qout[j] = s;
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch.
extern "C" int pq_lookup_launch(const void* tables, const void* codes,
                                void* out, int q, int c, int m,
                                void* stream) {
  const size_t smem = (size_t)m * kCenters * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pq_lookup_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(tables), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), c, m);
  return (int)cudaGetLastError();
}

extern "C" const char* pq_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
