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
// R <= 64, any beam <= 16, any D whose query and one row fit shared memory,
// flat rows. A parent outside [0, N) reads nothing and yields id -1 and
// +inf.
//
// What bounds it on an H100: bytes. At the main path's shape (Q=10K, beam 1,
// R=64, D=128) each call reads 87.0 MB of rows (10K x 8,704 B) and 5.1 MB of
// queries and writes 5.1 MB of ids and distances: ~97 MB, a floor of ~29 us
// at 3.35 TB/s. The arithmetic (10K x 64 x 128 FMAs, 0.16 GFLOP) is far
// below the f32 rate. The first form of this kernel made four dependent
// trips to memory per block (query, parents and id/norm planes, parents
// again, then each neighbor's vector a warp at a time) and had ~1 KB a block
// in flight: latency bound at ~4.6x its floor.
//
// Design (K2's, csrc/frontier_lookup.cu): one block per query, and no thread
// waits on a load it issued.
//   1. Every thread issues 16-byte cp.async.cg copies of the f32 query and
//      of its parents' rows into dynamic shared memory, one commit group for
//      all of them. Rows whose width or base is not a multiple of 16 go by
//      4-byte cp.async, or by plain byte copies when not even 4 divides
//      them (the query by 4-byte copies when 4D or its base is not a
//      multiple of 16). A beam whose rows do not fit kSmemTarget beside the
//      query goes through in equal groups of parents.
//   2. cp.async.wait_group 0, __syncthreads().
//   3. From shared memory only. Each warp takes 32 (parent, neighbor) lanes
//      at a time. Its 32 threads read the 32 vectors word by word: thread k
//      reads u32 word k (+32, +64, ...) of every vector in turn, so the
//      warp reads 32 consecutive words of one vector at once (no bank
//      conflict, where one thread per vector would put all 32 on one bank:
//      vectors are D = 128 bytes apart) and keeps its 4 query values in
//      registers across the 32 vectors. The 32 partial sums of each thread
//      are then reduced across the warp by a transposing butterfly (31
//      shuffles in all, not 5 per vector), after which thread k holds the
//      cross term of lane k: it decodes that lane's id and norm and writes
//      both outputs, coalesced. Bytes become f32 by an exact bit trick
//      (2^23 + b has an ulp of 1), not by the slower int-to-float unit.
//      D % 4 != 0 reads a byte a thread in place of a word.
// With u8 vectors, integer-valued queries and D <= 128, every partial sum is
// an integer below 2^24, so the result is exact whatever the summation
// order. The block is C = beam*R lanes rounded up to a warp, at most 256
// threads: 64 threads and ~9.2 KB at the main shape, so many blocks share
// an SM and one block's compute overlaps the others' copies.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "launch_count.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 48 * 1024;  // the query + a group of parent rows
constexpr unsigned kFull = 0xffffffffu;

// Byte K of w as an exact f32: the bits of 2^23 + b, less 2^23.
template <int K>
__device__ __forceinline__ float byte_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + K)) - 8388608.0f;
}

// ||q||^2 of the staged query, reduced by one warp (every lane gets it).
__device__ __forceinline__ float warp_squared_norm(const float* qs, int d, int lane) {
  float part = 0.0f;
  for (int k = lane; k < d; k += 32) part = fmaf(qs[k], qs[k], part);
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  return part;
}

// One level of the transposing butterfly over acc[0 .. 2*O): each lane
// keeps the half of its partial sums that its side of the pair (lane ^ O)
// owns and adds its partner's sums of the same vectors. O is a template
// argument so that every index is known at compile time and acc stays in
// registers.
template <int O>
__device__ __forceinline__ void butterfly(float (&acc)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? acc[i] : acc[i + O];
    const float keep = upper ? acc[i + O] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// q . v for the 32 vectors at rowbuf + (lane k's `vec_off`), k = 0..31;
// returns lane k's. VW: bytes each thread reads at a time, 4 or 1.
template <int VW>
__device__ __forceinline__ float warp_cross_terms(const float* qs, const uint8_t* rowbuf,
                                                  int vec_off, int d, int lane) {
  float acc[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) acc[v] = 0.0f;
  if (VW == 4) {
    const int words = d >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int w = lane; w - lane < words; w += 32) {  // the same trips for all lanes
      const bool in = w < words;
      const float4 x = in ? q4[w] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int off = __shfl_sync(kFull, vec_off, v);
        const uint32_t b4 =
            in ? *reinterpret_cast<const uint32_t*>(rowbuf + off + 4 * w) : 0u;
        acc[v] = fmaf(x.x, byte_f32<0>(b4), acc[v]);
        acc[v] = fmaf(x.y, byte_f32<1>(b4), acc[v]);
        acc[v] = fmaf(x.z, byte_f32<2>(b4), acc[v]);
        acc[v] = fmaf(x.w, byte_f32<3>(b4), acc[v]);
      }
    }
  } else {
    for (int k = lane; k - lane < d; k += 32) {
      const bool in = k < d;
      const float x = in ? qs[k] : 0.0f;
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int off = __shfl_sync(kFull, vec_off, v);
        const uint32_t b = in ? rowbuf[off + k] : 0u;
        acc[v] = fmaf(x, byte_f32<0>(b), acc[v]);
      }
    }
  }
  // after the last level, acc[0] of lane k holds the sum over all 32 lanes
  // of vector k's partial sums
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
  return acc[0];
}

// RVEC: bytes per row copy (16, 4 or 1); VW: bytes per vector read (4, 1).
template <int RVEC, int VW>
__global__ void __launch_bounds__(kMaxThreads)
    exact_frontier_kernel(const float* __restrict__ queries,
                          const uint8_t* __restrict__ rows,
                          const int32_t* __restrict__ parents,
                          int32_t* __restrict__ ids, float* __restrict__ dists,
                          int64_t n, int r, int d, int beam, int group,
                          int row_pad, int q_pad, int query16,
                          unsigned long long* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ __align__(16) uint8_t smem[];
  const float* qs = reinterpret_cast<const float*>(smem);
  uint8_t* rowbuf = smem + q_pad;
  const int64_t q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int row_w = r * (8 + d);
  const int c = beam * r;
  const int32_t* qpar = parents + q * beam;

  const uint8_t* qsrc = reinterpret_cast<const uint8_t*>(queries + q * d);
  if (query16) {
    copy_to_shared<16>(smem, qsrc, 4 * d);
  } else {
    copy_to_shared<4>(smem, qsrc, 4 * d);
  }
  float qn = 0.0f;
  for (int g0 = 0; g0 < beam; g0 += group) {
    const int gb = min(group, beam - g0);
    for (int b = 0; b < gb; ++b) {
      const int64_t p = qpar[g0 + b];
      if (p >= 0 && p < n)
        copy_to_shared<RVEC>(rowbuf + b * row_pad, rows + p * row_w, row_w);
    }
    cp_async_wait_all();
    __syncthreads();
    if (g0 == 0) qn = warp_squared_norm(qs, d, lane);

    const int lanes = gb * r;
    for (int t0 = warp * 32; t0 < lanes; t0 += n_warps * 32) {
      const int t = t0 + lane;
      const bool live = t < lanes;
      const int b = live ? t / r : 0;
      const int j = live ? t - b * r : 0;
      const uint8_t* row = rowbuf + b * row_pad;
      const float s =
          warp_cross_terms<VW>(qs, rowbuf, b * row_pad + 8 * r + j * d, d, lane);
      if (!live) continue;
      const int64_t p = qpar[g0 + b];
      const int64_t o = q * c + g0 * r + t;
      if (p < 0 || p >= n) {
        ids[o] = -1;
        dists[o] = INFINITY;
        continue;
      }
      ids[o] = (int32_t)((uint32_t)row[j] | ((uint32_t)row[r + j] << 8) |
                         ((uint32_t)row[2 * r + j] << 16) |
                         ((uint32_t)row[3 * r + j] << 24));
      const float norm = __uint_as_float(
          (uint32_t)row[4 * r + j] | ((uint32_t)row[5 * r + j] << 8) |
          ((uint32_t)row[6 * r + j] << 16) | ((uint32_t)row[7 * r + j] << 24));
      dists[o] = fmaxf(norm - 2.0f * s + qn, 0.0f);
    }
    if (g0 + group < beam) __syncthreads();  // the next group reuses rowbuf
  }
}

using Kernel = void (*)(const float*, const uint8_t*, const int32_t*, int32_t*, float*,
                        int64_t, int, int, int, int, int, int, int,
                        unsigned long long*);

template <int VW>
Kernel pick(uintptr_t align) {
  return align % 16 == 0 ? &exact_frontier_kernel<16, VW>
         : align % 4 == 0 ? &exact_frontier_kernel<4, VW>
                          : &exact_frontier_kernel<1, VW>;
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. The query (4D bytes)
// and one row (R*(8+D)), each rounded up to 16, must fit a block's 227 KB of
// shared memory (the wrapper checks).
extern "C" int exact_frontier_launch(const void* queries, const void* rows,
                                     const void* parents, void* ids,
                                     void* dists, long long n, int q, int r,
                                     int d, int beam, void* launches,
                                     void* stream) {
  const int row_w = r * (8 + d);
  const int row_pad = (row_w + 15) & ~15;
  const int q_pad = (4 * d + 15) & ~15;
  // parents per group: as many as fit kSmemTarget beside the query (at
  // least one), then split evenly over the groups that takes
  int fit = (kSmemTarget - q_pad) / row_pad;
  fit = fit < 1 ? 1 : (fit > beam ? beam : fit);
  const int n_groups = (beam + fit - 1) / fit;
  const int group = (beam + n_groups - 1) / n_groups;
  const size_t smem = (size_t)q_pad + (size_t)group * row_pad;
  const int lanes = group * r;
  const int threads = lanes >= kMaxThreads ? kMaxThreads : (lanes + 31) / 32 * 32;

  const uintptr_t align = reinterpret_cast<uintptr_t>(rows) | (uintptr_t)row_w;
  const int query16 = (reinterpret_cast<uintptr_t>(queries) | (uintptr_t)(4 * d)) % 16 == 0;
  const Kernel kernel = d % 4 == 0 ? pick<4>(align) : pick<1>(align);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(queries), static_cast<const uint8_t*>(rows),
      static_cast<const int32_t*>(parents), static_cast<int32_t*>(ids),
      static_cast<float*>(dists), (int64_t)n, r, d, beam, group, row_pad, q_pad,
      query16, static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

extern "C" const char* exact_frontier_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
