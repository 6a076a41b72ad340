// K3 exact_frontier: candidate ids and exact squared-L2 distances straight
// from the ungathered fused exact rows.
//
//   queries [Q, D] f32          the batch's queries
//   rows    [N, R*(8+D)] u8     fused exact rows: 4 little-endian id
//                               byte-planes of R bytes, 4 little-endian
//                               byte-planes of the neighbors' f32 ||v||^2,
//                               then the R neighbor vectors of D u8,
//                               row-major (ops/l2.pack_exact_frontier_rows)
//   parents [Q, beam] i32       rows to expand for each query
//   ids     [Q, beam*R] i32     ids[q, b*R + j]   = neighbor j of parent b
//   dists   [Q, beam*R] f32     dists[q, b*R + j] = max(||v||^2 - 2 q.v
//                                                       + ||q||^2, 0)
//
// Replaces the Pallas kernel exact_frontier_dma (bang_tpu/ops/pq_pallas.py:
// 564, body _exact_frontier_dma_kernel :498): the traversal fetch of
// BANG_Exactdistance's compute_neighborDist_par (parANN.cu:1139-1179). Like
// the DMA form, the kernel reads each parent's row itself, so no
// [Q, beam, row] copy is written to device memory. None of the Mosaic limits
// carry over (R = 64 only, D % 128 == 0, 8-sublane DMA-tiled rows): any
// R <= 64, any D whose query fits shared memory, any beam <= 16, flat rows.
//
// What bounds it on an H100: bytes. At the main path's shape (Q=10K, beam 1,
// R=64, D=128) each call reads 87.0 MB of rows (10K x 8,704 B) and 5.1 MB of
// queries and writes 5.1 MB of ids and distances: ~97 MB, a floor of ~29 us
// at 3.35 TB/s. The arithmetic (10K x 64 x 128 FMAs, 0.16 GFLOP) is far
// below the f32 rate.
//
// Design: one block per query. The block stages the query in shared memory
// and reduces ||q||^2; one thread per (parent, neighbor) lane decodes the
// id and the norm from the planes (coalesced: the R lanes of one parent read
// R consecutive bytes of each plane). Then one warp per neighbor reads the
// neighbor's D bytes, 4 bytes a lane when D and the row base allow it and a
// byte a lane otherwise, does f32 FMAs against the staged query and reduces
// across the warp with shuffles. With u8 vectors, integer-valued queries and
// D <= 128, every partial sum is an integer below 2^24, so the result is
// exact whatever the summation order. A parent outside [0, N) reads nothing
// and yields id -1 and +inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// VW: bytes each lane loads at a time, 4 (one u32) or 1.
template <int VW>
__global__ void exact_frontier_kernel(const float* __restrict__ queries,
                                      const uint8_t* __restrict__ rows,
                                      const int32_t* __restrict__ parents,
                                      int32_t* __restrict__ ids,
                                      float* __restrict__ dists, int64_t n,
                                      int r, int d, int beam) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [d] the query
  float* norms = qs + d;                        // [beam * r] neighbor norms
  __shared__ float qn_part[kWarps];

  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = beam * r;
  const int64_t row_w = (int64_t)r * (8 + d);

  // stage the query and reduce ||q||^2
  const float* qsrc = queries + q * d;
  float part = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float x = qsrc[i];
    qs[i] = x;
    part = fmaf(x, x, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) qn_part[warp] = part;

  // ids and norms: one thread per candidate lane
  for (int t = threadIdx.x; t < c; t += kThreads) {
    const int b = t / r;
    const int j = t - b * r;
    const int64_t p = parents[q * beam + b];
    const int64_t o = q * c + t;
    if (p < 0 || p >= n) {
      ids[o] = -1;
      continue;
    }
    const uint8_t* row = rows + p * row_w;
    ids[o] = (int32_t)((uint32_t)row[j] | ((uint32_t)row[r + j] << 8) |
                       ((uint32_t)row[2 * r + j] << 16) |
                       ((uint32_t)row[3 * r + j] << 24));
    norms[t] = __uint_as_float(
        (uint32_t)row[4 * r + j] | ((uint32_t)row[5 * r + j] << 8) |
        ((uint32_t)row[6 * r + j] << 16) | ((uint32_t)row[7 * r + j] << 24));
  }
  __syncthreads();
  float qn = 0.0f;
  for (int w = 0; w < kWarps; ++w) qn += qn_part[w];

  // cross terms: one warp per candidate lane
  for (int t = warp; t < c; t += kWarps) {
    const int b = t / r;
    const int j = t - b * r;
    const int64_t p = parents[q * beam + b];
    const int64_t o = q * c + t;
    if (p < 0 || p >= n) {
      if (lane == 0) dists[o] = INFINITY;
      continue;
    }
    const uint8_t* vec = rows + p * row_w + 8 * r + (int64_t)j * d;
    float s = 0.0f;
    if (VW == 4) {
      const uint32_t* v4 = reinterpret_cast<const uint32_t*>(vec);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int k = lane; k < d / 4; k += 32) {
        const uint32_t w = __ldg(v4 + k);
        const float4 x = q4[k];
        s = fmaf(x.x, (float)(w & 0xffu), s);
        s = fmaf(x.y, (float)((w >> 8) & 0xffu), s);
        s = fmaf(x.z, (float)((w >> 16) & 0xffu), s);
        s = fmaf(x.w, (float)(w >> 24), s);
      }
    } else {
      for (int k = lane; k < d; k += 32) s = fmaf(qs[k], (float)__ldg(vec + k), s);
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dists[o] = fmaxf(norms[t] - 2.0f * s + qn, 0.0f);
  }
}

template <int VW>
cudaError_t launch(const void* queries, const void* rows, const void* parents,
                   void* ids, void* dists, long long n, int q, int r, int d,
                   int beam, cudaStream_t stream) {
  const size_t smem = (size_t)(d + beam * r) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      exact_frontier_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  exact_frontier_kernel<VW><<<q, kThreads, smem, stream>>>(
      static_cast<const float*>(queries), static_cast<const uint8_t*>(rows),
      static_cast<const int32_t*>(parents), static_cast<int32_t*>(ids),
      static_cast<float*>(dists), (int64_t)n, r, d, beam);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. u32 loads need every
// vector 4-byte aligned: D % 4 == 0 (then the row width R*(8+D) and the
// vector offset 8R + j*D are multiples of 4 too) and a 4-aligned base.
extern "C" int exact_frontier_launch(const void* queries, const void* rows,
                                     const void* parents, void* ids,
                                     void* dists, long long n, int q, int r,
                                     int d, int beam, void* stream) {
  const bool aligned4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 4 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(aligned4
                   ? launch<4>(queries, rows, parents, ids, dists, n, q, r, d, beam, s)
                   : launch<1>(queries, rows, parents, ids, dists, n, q, r, d, beam, s));
}

extern "C" const char* exact_frontier_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
