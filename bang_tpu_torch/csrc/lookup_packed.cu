// K4 lookup_packed: PQ distance accumulation over bf16-pair tables.
//
//   out[q, j] = sum_c bf16(T)[q, c, codes[q, j, c]]       (summed in f32)
//   packed [Q, m, 128] i32   word i of row (q, c) holds T[q, c, 2i] (bf16)
//                            in its low half-word and T[q, c, 2i+1] in its
//                            high one (ops/pq.pack_tables)
//   codes  [Q, C, m] u8      gathered per candidate; a flat [Q, C*m] buffer
//                            is the same bytes
//   out    [Q, C] f32
//
// Replaces three Pallas probes of the JAX package's scripts/, which compute
// this one function and differ only in how Mosaic moved the code bytes into
// vector registers (a distinction the card does not have):
//   lookup_v2   scripts/exp_lookup.py:85      (body _kernel_v2 :65)
//   lookup_flat scripts/exp_flat_lookup.py:90 (body _kernel_flat :72)
//   v6          scripts/exp_flat2.py:106      (body _kernel_v6 :92)
//
// What bounds it on an H100: bytes. Each query's packed table is m x 512 B
// (32 KB at m=64), read once per call. At Q=10K, m=64, C=128 a call reads
// 327.7 MB of tables and 81.9 MB of codes and writes 5.1 MB: 414.7 MB, a
// floor of ~0.124 ms at 3.35 TB/s, against K1's 742.4 MB (~0.222 ms) with
// f32 tables. The adds (C*m per query) are trivial.
//
// Design: K1's (csrc/pq_lookup.cu), so that the two differ only in the
// table form. One block per query copies the query's packed table into
// dynamic shared memory with 16-byte loads (its one pass over device
// memory), then each thread accumulates one candidate over all m chunks,
// reading that candidate's m codes as one contiguous row and decoding each
// entry as __uint_as_float(((word >> (code&1)*16) & 0xFFFF) << 16). Half
// the shared memory of K1 lets 7 blocks share an SM where K1 fits 3. Above
// 48 KB of shared memory (m > 96) the launch raises the kernel's dynamic
// limit; the wrapper refuses tables above 227 KB (m > 454).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 128;  // packed words per (query, chunk) row
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_entry(const uint32_t* tab, int k,
                                            uint32_t code) {
  const uint32_t w = tab[k * kWords + (code >> 1)];
  return __uint_as_float(((w >> ((code & 1u) << 4)) & 0xFFFFu) << 16);
}

__global__ void lookup_packed_kernel(const int32_t* __restrict__ packed,
                                     const uint8_t* __restrict__ codes,
                                     float* __restrict__ out, int c, int m) {
  extern __shared__ uint4 smem4[];
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem4);
  const int64_t q = blockIdx.x;

  const uint4* src =
      reinterpret_cast<const uint4*>(packed + q * (int64_t)m * kWords);
  const int n4 = m * (kWords / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) smem4[i] = src[i];
  __syncthreads();

  const uint8_t* qcodes = codes + q * (int64_t)c * m;
  float* qout = out + q * (int64_t)c;
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const uint8_t* row = qcodes + (int64_t)j * m;
    float s = 0.0f;
    for (int k = 0; k < m; ++k) s += bf16_entry(tab, k, row[k]);
    qout[j] = s;
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch.
extern "C" int lookup_packed_launch(const void* packed, const void* codes,
                                    void* out, int q, int c, int m,
                                    void* stream) {
  const size_t smem = (size_t)m * kWords * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      lookup_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lookup_packed_kernel<<<q, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(packed), static_cast<const uint8_t*>(codes),
      static_cast<float*>(out), c, m);
  return (int)cudaGetLastError();
}

extern "C" const char* lookup_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
