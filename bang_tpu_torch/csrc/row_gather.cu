// K6 row_gather: a dynamic row copy.
//
//   rows    [N, S] u8     flat rows of any width S
//   parents [P] i32       rows to copy
//   out     [P, S] u8     out[i, :] = rows[parents[i], :]; a zero row where
//                         parents[i] lies outside [0, N)
//
// Replaces the Pallas probe sublane_probe (scripts/exp_dma_tiled.py:71,
// inline body k :75): a scalar-prefetched single-row DMA of an [s, 128] u8
// block, the probe behind the in-kernel row read of frontier_lookup_dma.
// On the TPU the copied block needed a sublane extent that is a multiple
// of 8 (`_dma_sublanes`, bang_tpu/ops/pq_pallas.py:310-320), which padded
// the fused rows by 17.6% at R=64, m=64. That was a TPU limit and is not
// ported: the rows here are flat, S is any width.
//
// What bounds it on an H100: bytes. Each output row is one row read and one
// row written: at P=20K rows of 4,352 B that is 87.0 MB each way, 174.2 MB,
// a floor of ~0.052 ms at 3.35 TB/s.
//
// Design: one block per output row. When S is a multiple of 16 and both
// base pointers are 16-byte aligned (then every row is), the block copies
// with 16-byte vector loads and stores, neighbouring threads on
// neighbouring addresses; otherwise byte by byte. A parent outside [0, N)
// reads nothing and writes zeros; the wrapper checks the range only for CPU
// tensors, where reading the parents back is free. Bulk copies through the
// Tensor Memory Accelerator (cp.async.bulk) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ rows,
                                  const int32_t* __restrict__ parents,
                                  T* __restrict__ out, int64_t n,
                                  int64_t width,  // in units of T
                                  unsigned long long* __restrict__ launches) {
  count_launch(launches);
  const int64_t i = blockIdx.x;
  const int64_t p = parents[i];
  T* dst = out + i * width;
  if (p < 0 || p >= n) {
    for (int64_t k = threadIdx.x; k < width; k += blockDim.x) dst[k] = T{};
    return;
  }
  const T* src = rows + p * width;
  for (int64_t k = threadIdx.x; k < width; k += blockDim.x) dst[k] = src[k];
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch.
extern "C" int row_gather_launch(const void* rows, const void* parents,
                                 void* out, long long n, int p, long long s,
                                 void* launches, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec16 = s % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec16) {
    row_gather_kernel<uint4><<<p, kThreads, 0, st>>>(
        static_cast<const uint4*>(rows), static_cast<const int32_t*>(parents),
        static_cast<uint4*>(out), (int64_t)n, (int64_t)(s / 16),
        static_cast<unsigned long long*>(launches));
  } else {
    row_gather_kernel<uint8_t><<<p, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(rows), static_cast<const int32_t*>(parents),
        static_cast<uint8_t*>(out), (int64_t)n, (int64_t)s,
        static_cast<unsigned long long*>(launches));
  }
  return (int)cudaGetLastError();
}

extern "C" const char* row_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
