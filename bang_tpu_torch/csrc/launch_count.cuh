// Each kernel counts its own launches on the card: thread 0 of block 0 adds
// one to the wrapper's slot of the device's counter (ops/_build.
// launch_counter). A launch from a CUDA graph replay runs no host code, so
// this count is what shows how often a captured loop ran each kernel.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ULL);
}

}  // namespace
