// visited_filter: the exact visited filter of one traversal step, in one
// launch.
//
//   cand         [Q, C] i32   candidate ids, C = beam*R: beam blocks of the
//                             R neighbors of each expanded parent
//   raw          [Q, C] f32   their distances
//   wl_ids       [Q, L] i32   the worklist's ids (INVALID_ID padding)
//   visited_ids  [Q, V] i32   the parents expanded so far (INVALID_ID padding)
//   parent_valid [Q, beam] u8 (bool) whether parent b was expanded
//   active       [Q] u8       (bool) whether the query still walks
//   new_mask     [Q, C] u8    (bool) new[q, j] = cand not in wl_ids or
//                             visited_ids, its parent valid, the query
//                             active, and (beam > 1) no block before j's
//                             holds the same id
//   dist         [Q, C] f32   raw where new, +inf elsewhere
//
// It computes, bit for bit, what ops/visited.visited_filter_plain computes
// with PyTorch's kernels: exact_new_mask, the parents' validity expanded
// over their blocks, the query's activity, first_occurrence_mask_blocks and
// a torch.where. An INVALID_ID candidate matches INVALID_ID padding in
// either list, so it is not new. Block b of the candidates is compared only
// with the blocks before it, over the raw ids, whatever the parents'
// validity; duplicates inside a block are all kept.
//
// It replaces no TPU kernel: the JAX package leaves this filter to XLA
// (bang_tpu/models/traversal.py), which fuses the compares and reductions.
// Eager PyTorch fuses nothing: its composition (a concatenation, a row
// sort, a binary search, a gather, a [Q, 64, 64] bool compare reduced with
// any(), the masks and a where) took 10.51 ms of a 29.55 ms 10K-query
// in-memory call at L=40, beam 2, 36% of it, in about a dozen launches a
// step. This kernel was added to take that in one launch a step.
//
// What bounds it on an H100: bytes. Per query it reads 4C (cand) + 4C (raw)
// + 4L + 4V + beam + 1 bytes and writes 4C + C. At the main path's shape
// (Q=10K, C=128, L=40, V=52, beam 2) that is 2,035 B a query, 20.35 MB a
// launch: a floor of 6.07 us at 3.35 TB/s, 0.152 ms a call of 25 steps.
// Compared pairwise, the ids would cost C*(L+V) + C*C/2 compares a query
// (16K here), which the SMs issue in about twice the bytes' time: a first
// form of this kernel that scanned the known ids from shared memory by
// broadcast ran 21.7 us at the main shape and 118 us at beam 16. So the
// ids go through a hash table instead, O(L + V + C) work a query.
//
// Design: one block per query, its threads max(C, (L + V + C) / 4) rounded
// up to a warp, at most 256; no thread waits on another's load.
//   1. An inactive query writes new = 0 and dist = +inf and reads nothing
//      else: the whole block returns together, before any barrier.
//   2. The block clears an open-addressing table in shared memory: a
//      power-of-two count of slots, at least 4/3 of L + V + C (a load of
//      at most 3/4), each a 64-bit key (bit 32 set over the id's 32 bits;
//      0 is empty, so every int32 id, INVALID_ID too, is a key) and the
//      first block that holds the id (int32).
//   3. Each thread inserts ids by atomicCAS with linear probing and lowers
//      the slot's block by atomicMin: the known ids with block -1 (an id
//      equal to the one before it in its list is skipped, so the INVALID_ID
//      padding, which fills most of the visited list early in a search,
//      inserts once and not hundreds of times into one slot), then each
//      candidate with its own block. The loads are 4 bytes a thread,
//      neighbouring threads on neighbouring addresses.
//   4. __syncthreads(); each candidate whose parent is valid looks its id
//      up: it is new iff the first block that holds it is its own (known
//      ids hold -1, an earlier block a smaller index). new and dist are
//      written coalesced.
// Nothing but the two outputs goes to device memory, there is no host
// sync and the launch allocates nothing, so it replays inside a captured
// WHILE body. The table holds 12 bytes a slot: 512 slots, 6 KB, at the main
// shape, so a full complement of blocks shares an SM.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kMaxThreads = 256;

// The home slot of `id` in a table of 2^(32 - shift) slots: Fibonacci
// hashing, which spreads runs of consecutive ids.
__device__ __forceinline__ uint32_t home_slot(int32_t id, int shift) {
  return ((uint32_t)id * 2654435761u) >> shift;
}

__device__ __forceinline__ unsigned long long key_of(int32_t id) {
  return (1ull << 32) | (uint32_t)id;
}

// Insert `id` with block b: the slot's block becomes min(its block, b).
__device__ __forceinline__ void insert(unsigned long long* keys, int* first,
                                       int32_t id, int b, int shift,
                                       uint32_t mask) {
  const unsigned long long key = key_of(id);
  for (uint32_t s = home_slot(id, shift);; s = (s + 1) & mask) {
    const unsigned long long old = atomicCAS(&keys[s], 0ull, key);
    if (old == 0ull || old == key) {
      atomicMin(&first[s], b);
      return;
    }
  }
}

// The first block that holds `id`, which is in the table.
__device__ __forceinline__ int first_block(const unsigned long long* keys,
                                           const int* first, int32_t id,
                                           int shift, uint32_t mask) {
  const unsigned long long key = key_of(id);
  uint32_t s = home_slot(id, shift);
  while (keys[s] != key) s = (s + 1) & mask;
  return first[s];
}

__global__ void __launch_bounds__(kMaxThreads)
    visited_filter_kernel(const int32_t* __restrict__ cand,
                          const float* __restrict__ raw,
                          const int32_t* __restrict__ wl_ids,
                          const int32_t* __restrict__ visited_ids,
                          const uint8_t* __restrict__ parent_valid,
                          const uint8_t* __restrict__ active,
                          uint8_t* __restrict__ new_mask,
                          float* __restrict__ dist, int c, int l, int v,
                          int r, int beam, int log2_slots,
                          unsigned long long* __restrict__ launches) {
  count_launch(launches);
  extern __shared__ __align__(16) unsigned long long keys[];
  const int slots = 1 << log2_slots;
  int* first = reinterpret_cast<int*>(keys + slots);
  const int shift = 32 - log2_slots;
  const uint32_t mask = slots - 1;
  const int64_t q = blockIdx.x;
  const int64_t row = q * c;
  if (!active[q]) {
    for (int j = threadIdx.x; j < c; j += blockDim.x) {
      new_mask[row + j] = 0;
      dist[row + j] = INFINITY;
    }
    return;
  }
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    keys[i] = 0ull;
    first[i] = INT_MAX;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < l + v; k += blockDim.x) {
    const int32_t* list = k < l ? wl_ids + q * l : visited_ids + q * v;
    const int i = k < l ? k : k - l;
    const int32_t id = list[i];
    if (i == 0 || list[i - 1] != id) insert(keys, first, id, -1, shift, mask);
  }
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    insert(keys, first, cand[row + j], j / r, shift, mask);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const int b = j / r;
    bool is_new = parent_valid[q * beam + b] != 0;
    if (is_new) is_new = first_block(keys, first, cand[row + j], shift, mask) == b;
    new_mask[row + j] = is_new;
    dist[row + j] = is_new ? raw[row + j] : INFINITY;
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch. The table, 12 bytes a
// slot over the least power of two (at least 32) not below 4/3 (L + V + C),
// must fit a block's 227 KB of shared memory (the wrapper checks).
extern "C" int visited_filter_launch(const void* cand, const void* raw,
                                     const void* wl_ids, const void* visited_ids,
                                     const void* parent_valid, const void* active,
                                     void* new_mask, void* dist, int q, int c,
                                     int l, int v, int beam, void* launches,
                                     void* stream) {
  const int n = l + v + c;
  int log2_slots = 5;
  while ((3 << log2_slots) < 4 * n) ++log2_slots;  // a load of at most 3/4
  const size_t smem = (size_t)12 << log2_slots;
  const int want = c > n / 4 ? c : n / 4;
  const int threads = want >= kMaxThreads ? kMaxThreads : (want + 31) / 32 * 32;
  cudaError_t err = cudaFuncSetAttribute(
      visited_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  visited_filter_kernel<<<q, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(cand), static_cast<const float*>(raw),
      static_cast<const int32_t*>(wl_ids), static_cast<const int32_t*>(visited_ids),
      static_cast<const uint8_t*>(parent_valid), static_cast<const uint8_t*>(active),
      static_cast<uint8_t*>(new_mask), static_cast<float*>(dist), c, l, v, c / beam,
      beam, log2_slots, static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

extern "C" const char* visited_filter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
