// stage_clock: the device's stage clock inside a captured search.
//
//   clock  [S + 1] i64  clock[0..S) the nanoseconds each stage took, clock[S]
//                       the last stamp (%globaltimer, ns)
//
// A stamp of stage s is one thread: it reads %globaltimer, adds the time
// since the last stamp to clock[s] and makes `now` the last stamp. The
// stamps sit between a search's stages in the order the stream runs them
// (models/traversal.make_step, models/compiled.CapturedLoop), so each
// stage's bucket holds the device time from the stamp before it to its
// own, gaps between kernels included, and the buckets sum to the span from
// the first stamp to the last. The start stamp (stage -1) zeroes the
// buckets.
//
// The stage is a template argument, so each boundary is its own kernel
// name on a device trace (stage_clock_kernel<2> ends `visited`): a profile
// can put the graph's idle gaps between the stages. A kernel and not a
// CUDA event: the body graph of a conditional WHILE node takes kernel,
// memcpy, memset, empty, child-graph and conditional nodes only, no
// event-record node.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int kStages = 7;  // ops/stage_clock.STAGES

template <int S>
__global__ void stage_clock_kernel(long long* __restrict__ clock,
                                   unsigned long long* __restrict__ launches) {
  count_launch(launches);
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if constexpr (S < 0) {
    for (int i = 0; i < kStages; ++i) clock[i] = 0;
  } else {
    clock[S] += static_cast<long long>(now) - clock[kStages];
  }
  clock[kStages] = static_cast<long long>(now);
}

template <int S>
cudaError_t stamp(long long* clock, unsigned long long* launches,
                  cudaStream_t st) {
  stage_clock_kernel<S><<<1, 1, 0, st>>>(clock, launches);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t as int: 0 on a clean launch; cudaErrorInvalidValue
// for a stage outside [-1, kStages).
extern "C" int stage_clock_launch(void* clock, int stage, void* launches,
                                  void* stream) {
  long long* c = static_cast<long long*>(clock);
  unsigned long long* n = static_cast<unsigned long long*>(launches);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case -1: return (int)stamp<-1>(c, n, st);
    case 0: return (int)stamp<0>(c, n, st);
    case 1: return (int)stamp<1>(c, n, st);
    case 2: return (int)stamp<2>(c, n, st);
    case 3: return (int)stamp<3>(c, n, st);
    case 4: return (int)stamp<4>(c, n, st);
    case 5: return (int)stamp<5>(c, n, st);
    case 6: return (int)stamp<6>(c, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* stage_clock_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
