// K1 pq_lookup: PQ distances of candidates whose codes were gathered per
// candidate (the scattered-codes layout), over bf16-pair tables.
//
//   packed [Q, m, 128] i32   bf16-pair tables (ops/pq.pack_tables): word i
//                            of chunk c holds entry 2i in its low half and
//                            entry 2i + 1 in its high half
//   codes  [Q, C, m] u8      gathered per candidate; a flat [Q, C*m] buffer
//                            is the same bytes
//   out    [Q, C] f32        out[q, j] = sum_c bf16(T)[q, c, codes[q, j, c]],
//                            summed in f32 from 0.0f in chunk order 0..m-1,
//                            in one accumulator: K2's and K5's order, so the
//                            three kernels agree bit for bit on equal codes
//
// Replaces the Pallas kernel pq_lookup_packed (bang_tpu/ops/pq_pallas.py:74,
// body _lookup_kernel :44), itself the re-design of the reference's
// compute_neighborDist_par PQ path (BANG_Base/bang_search.cu:1201-1241), and
// the three probes of the JAX package's scripts/ that compute the same
// function and differ only in how Mosaic moved the code bytes into vector
// registers (ops/probe_kernels.lookup_packed launches this kernel for them):
//   lookup_v2   scripts/exp_lookup.py:85      (body _kernel_v2 :65)
//   lookup_flat scripts/exp_flat_lookup.py:90 (body _kernel_flat :72)
//   v6          scripts/exp_flat2.py:106      (body _kernel_v6 :92)
// None of the Mosaic limits carry over (C <= 128 or C % 128, the lane-tiled
// gather): any C, any m whose table and one code row fit shared memory.
//
// What bounds it on an H100: bytes. At the main shape (Q=10K, m=64, C=128)
// a call reads 327.7 MB of packed tables and 81.9 MB of codes and writes
// 5.1 MB: 414.7 MB, a floor of ~0.124 ms at 3.35 TB/s. The adds (m per
// candidate) are trivial.
//
// Design (K2's, csrc/frontier_lookup.cu): one block per query, and no thread
// waits on a load it issued.
//   1. Every thread issues 16-byte cp.async.cg copies of the query's packed
//      table (32 KB at m=64) and of its [C, m] code tile (8 KB at C=128)
//      into dynamic shared memory, one commit group for all of them. Code
//      rows whose length or base is not a multiple of 16 go by 4-byte
//      cp.async, or by plain byte copies when not even 4 divides them.
//      Candidates whose rows do not fit kSmemTarget beside the table go
//      through in equal groups (at least a warp's worth where shared memory
//      holds them).
//   2. cp.async.wait_group 0, __syncthreads().
//   3. One thread per candidate sums its m entries from shared memory only.
// Candidate-major rows m = 64 bytes apart would put a warp's byte reads on 2
// of the 32 banks. So each row is stored at a stride `ld` of an odd number
// of 16-byte units (80 bytes at m=64), and a thread reads its row 16 codes
// at a time: the 8 threads of each quarter-warp phase of a 16-byte load
// then hit 8 distinct 16-byte bank groups, conflict-free. The table word is
// read by code >> 1, one bank access per entry.
// The block is the group's candidates rounded up to a warp, at most 256
// threads, so no half-block idles at C=128. At ~42 KB a block (m=64,
// C=128) five blocks share an SM, and one block's sums overlap the others'
// copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "launch_count.cuh"

namespace {

constexpr int kWords = 128;                  // packed words per (query, chunk)
constexpr int kChunkBytes = kWords * 4;      // 512 B of table per chunk
constexpr int kMaxThreads = 256;
constexpr int kSmemTarget = 48 * 1024;       // table + a group of code rows
constexpr int kMaxSmem = 232448;             // an H100 block's shared memory

// Row stride in shared memory: m rounded up to 16 bytes, to an odd number
// of 16-byte units (ops/_build.MAX_LOOKUP_CHUNKS bounds m by it).
__host__ __device__ inline int row_stride(int m) {
  const int units = (m + 15) / 16;
  return 16 * (units | 1);
}

__device__ __forceinline__ float entry(const uint32_t* chunk, uint32_t code) {
  const uint32_t w = chunk[code >> 1];
  return __uint_as_float((code & 1u) ? (w & 0xFFFF0000u) : (w << 16));
}

// s plus the entries of the n <= 16 chunks from `tab`, whose codes are the
// bytes of v (little-endian), added in chunk order.
__device__ __forceinline__ float add_codes(const uint32_t* tab, uint4 v, int n,
                                           float s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i < n) s += entry(tab + i * kWords, (w[i / 4] >> (8 * (i % 4))) & 0xFFu);
  }
  return s;
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    pq_lookup_kernel(const int32_t* __restrict__ packed,
                     const uint8_t* __restrict__ codes, float* __restrict__ out,
                     int c, int m, int group,
                     unsigned long long* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem);
  uint8_t* tile = smem + m * kChunkBytes;
  const int64_t q = blockIdx.x;
  const int ld = row_stride(m);

  copy_to_shared<16>(smem,
                     reinterpret_cast<const uint8_t*>(packed + q * m * kWords),
                     m * kChunkBytes);
  for (int g0 = 0; g0 < c; g0 += group) {
    const int gc = min(group, c - g0);
    copy_rows_to_shared<VEC>(tile, ld, codes + (q * c + g0) * m, gc, m);
    cp_async_wait_all();
    __syncthreads();

    for (int t = threadIdx.x; t < gc; t += blockDim.x) {
      const uint8_t* row = tile + t * ld;
      float s = 0.0f;
      int k = 0;
      for (; k + 16 <= m; k += 16) {
        s = add_codes(tab + k * kWords, *reinterpret_cast<const uint4*>(row + k),
                      16, s);
      }
      if (k < m) {
        s = add_codes(tab + k * kWords, *reinterpret_cast<const uint4*>(row + k),
                      m - k, s);
      }
      out[q * c + g0 + t] = s;
    }
    if (g0 + group < c) __syncthreads();  // the next group reuses the tile
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. `packed` must start on
// a 16-byte boundary and m*512 plus one row's stride must fit a block's
// 227 KB of shared memory (the wrapper checks both).
extern "C" int pq_lookup_launch(const void* packed, const void* codes, void* out,
                                int q, int c, int m, void* launches,
                                void* stream) {
  const int ld = row_stride(m);
  const int table = m * kChunkBytes;
  // candidates per group: as many as fit kSmemTarget beside the table, or a
  // warp's worth (or what fits at all) when that is fewer; then split
  // evenly over the groups that takes
  int fit = (kSmemTarget - table) / ld;
  const int room = (kMaxSmem - table) / ld;
  if (fit < 32) fit = room < 32 ? room : 32;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  if (fit > c) fit = c;
  const int n_groups = (c + fit - 1) / fit;
  const int group = (c + n_groups - 1) / n_groups;
  const size_t smem = (size_t)table + (size_t)group * ld;
  const int threads =
      group >= kMaxThreads ? kMaxThreads : (group + 31) / 32 * 32;

  const uintptr_t align = reinterpret_cast<uintptr_t>(codes) | (uintptr_t)m;
  void (*kernel)(const int32_t*, const uint8_t*, float*, int, int, int,
                 unsigned long long*) =
      align % 16 == 0 ? &pq_lookup_kernel<16>
      : align % 4 == 0 ? &pq_lookup_kernel<4>
                       : &pq_lookup_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), c, m, group,
      static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

extern "C" const char* pq_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
