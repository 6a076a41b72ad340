// K2 frontier_lookup: candidate ids and PQ distances straight from the
// ungathered fused frontier rows, over bf16-pair tables.
//
//   packed  [Q, m, 128] i32     bf16-pair tables (ops/pq.pack_tables): word
//                               i of chunk c holds entry 2i in its low half
//                               and entry 2i + 1 in its high half
//   rows    [N, R*(4+m)] u8     fused rows: 4 little-endian id byte-planes
//                               of R bytes, then m chunk-major code groups
//                               of R bytes (ops/pq_kernels.pack_frontier_rows)
//   parents [Q, beam] i32       rows to expand for each query
//   ids     [Q, beam*R] i32     ids[q, b*R + j]  = neighbor j of parent b
//   dists   [Q, beam*R] f32     dists[q, b*R + j] = sum_c bf16(T)[q, c,
//                               code_cj], summed in f32 in chunk order
//
// Replaces the Pallas kernels frontier_lookup (bang_tpu/ops/pq_pallas.py:267,
// bodies _frontier_kernel :167 and _frontier_kernel_r32 :197) and
// frontier_lookup_dma (:411, body _frontier_dma_kernel :345), and computes
// what their probe prototype fused_lookup (scripts/exp_fused.py:79) did: the
// fused gather + lookup of the reference's compute_neighborDist_par
// (BANG_Base/bang_search.cu:1201-1241). Like the DMA form it reads each
// parent's row itself, so no [Q, beam, row] copy is written to device
// memory. None of the Mosaic limits carry over (R=64 only, m%2, m%4,
// beam*R <= 128, the R=32 lane-rotation decode): any R <= 64, any m whose
// table and one row fit shared memory, any beam <= 16. A parent outside
// [0, N) reads nothing and yields id -1 and +inf.
//
// What bounds it on an H100: bytes. At the main path's shape (Q=10K, m=64,
// R=64, beam 2) a call reads 327.7 MB of packed tables and ~87 MB of parent
// rows (10K x 2 x 4,352 B) and writes 10.2 MB of ids and distances: ~425 MB,
// a floor of ~0.127 ms at 3.35 TB/s. The adds (m per lane) are trivial.
//
// Design: one block per query, and no thread waits on a load it issued.
//   1. Every thread issues 16-byte cp.async.cg copies of the query's packed
//      table (32 KB at m=64) and of its parents' rows (2 x 4,352 B) into
//      dynamic shared memory, one commit group for all of them. Rows whose
//      width or base is not a multiple of 16 go by 4-byte cp.async, or by
//      plain byte copies when not even 4 divides them. A beam whose rows do
//      not fit kSmemTarget beside the table goes through in equal groups of
//      parents.
//   2. cp.async.wait_group 0, __syncthreads().
//   3. One thread per (parent, neighbor) lane decodes the id (shift-or of
//      the 4 planes) and sums the m bf16 entries, from shared memory only:
//      the R lanes of a parent read each chunk's R codes as consecutive
//      bytes (no bank conflict), the table word by code >> 1.
// The block is C = beam*R lanes rounded up to a warp, at most 256 threads,
// so no half-block idles at C=128. At ~41 KB a block (m=64, R=64, beam 2)
// five blocks share an SM, and one block's lookup overlaps the others'
// copies without persistent blocks or a copy ring.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWords = 128;                  // packed words per (query, chunk)
constexpr int kChunkBytes = kWords * 4;      // 512 B of table per chunk
constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 48 * 1024;       // table + a group of parent rows

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    frontier_lookup_kernel(const int32_t* __restrict__ packed,
                           const uint8_t* __restrict__ rows,
                           const int32_t* __restrict__ parents,
                           int32_t* __restrict__ ids, float* __restrict__ dists,
                           int64_t n, int r, int m, int beam, int group,
                           int row_pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem);
  uint8_t* rowbuf = smem + m * kChunkBytes;
  const int64_t q = blockIdx.x;
  const int row_w = r * (4 + m);
  const int c = beam * r;
  const int32_t* qpar = parents + q * beam;

  copy_to_shared<16>(smem,
                     reinterpret_cast<const uint8_t*>(packed + q * m * kWords),
                     m * kChunkBytes);
  for (int g0 = 0; g0 < beam; g0 += group) {
    const int gb = min(group, beam - g0);
    for (int b = 0; b < gb; ++b) {
      const int64_t p = qpar[g0 + b];
      if (p >= 0 && p < n) copy_to_shared<VEC>(rowbuf + b * row_pad, rows + p * row_w, row_w);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int t = threadIdx.x; t < gb * r; t += blockDim.x) {
      const int b = t / r;
      const int j = t - b * r;
      const int64_t p = qpar[g0 + b];
      const int64_t o = q * c + g0 * r + t;
      if (p < 0 || p >= n) {
        ids[o] = -1;
        dists[o] = INFINITY;
        continue;
      }
      const uint8_t* row = rowbuf + b * row_pad;
      ids[o] = (int32_t)((uint32_t)row[j] | ((uint32_t)row[r + j] << 8) |
                         ((uint32_t)row[2 * r + j] << 16) |
                         ((uint32_t)row[3 * r + j] << 24));
      const uint8_t* cm = row + 4 * r + j;
      float s = 0.0f;
#pragma unroll 8
      for (int k = 0; k < m; ++k) {
        const uint32_t code = cm[k * r];
        const uint32_t w = tab[k * kWords + (code >> 1)];
        s += __uint_as_float(((w >> ((code & 1u) << 4)) & 0xFFFFu) << 16);
      }
      dists[o] = s;
    }
    if (g0 + group < beam) __syncthreads();  // the next group reuses rowbuf
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. `packed` must start on
// a 16-byte boundary (the wrapper checks); m*512 + R*(4+m) rounded up to 16
// must fit a block's 227 KB of shared memory.
extern "C" int frontier_lookup_launch(const void* packed, const void* rows,
                                      const void* parents, void* ids,
                                      void* dists, long long n, int q, int r,
                                      int m, int beam, void* stream) {
  const int row_w = r * (4 + m);
  const int row_pad = (row_w + 15) & ~15;
  const int table = m * kChunkBytes;
  // parents per group: as many as fit kSmemTarget beside the table (at
  // least one), then split evenly over the groups that takes
  int fit = (kSmemTarget - table) / row_pad;
  fit = fit < 1 ? 1 : (fit > beam ? beam : fit);
  const int n_groups = (beam + fit - 1) / fit;
  const int group = (beam + n_groups - 1) / n_groups;
  const size_t smem = (size_t)table + (size_t)group * row_pad;
  const int lanes = group * r;
  const int threads = lanes >= kMaxThreads ? kMaxThreads : (lanes + 31) / 32 * 32;

  const uintptr_t align = reinterpret_cast<uintptr_t>(rows) | (uintptr_t)row_w;
  void (*kernel)(const int32_t*, const uint8_t*, const int32_t*, int32_t*, float*,
                 int64_t, int, int, int, int, int) =
      align % 16 == 0 ? &frontier_lookup_kernel<16>
      : align % 4 == 0 ? &frontier_lookup_kernel<4>
                       : &frontier_lookup_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const uint8_t*>(rows),
      static_cast<const int32_t*>(parents), static_cast<int32_t*>(ids),
      static_cast<float*>(dists), (int64_t)n, r, m, beam, group, row_pad);
  return (int)cudaGetLastError();
}

extern "C" const char* frontier_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
