// Phase clocks for kernel K1, used by tools/k1_phases.py only: nvcc
// -include's this header before csrc/fused_beam.cu, whose K1_PHASE hooks
// are empty otherwise. Thread 0 of every block sums clock64() between the
// marks; the sums of all blocks land in k1_phase_clocks: [0, 6) the
// phases, [6] the number of blocks, [7] the clocks from K1_PHASE_BEGIN to
// K1_PHASE_END.
#pragma once
#include <cuda_runtime.h>

__device__ unsigned long long k1_phase_clocks[8];

#define K1_PHASE_BEGIN()                \
  const long long k1_t0 = clock64();    \
  long long k1_t = k1_t0;               \
  long long k1_acc[6] = {0, 0, 0, 0, 0, 0}

#define K1_PHASE(n)                       \
  do {                                    \
    if (threadIdx.x == 0) {               \
      const long long k1_now = clock64(); \
      k1_acc[n] += k1_now - k1_t;         \
      k1_t = k1_now;                      \
    }                                     \
  } while (0)

#define K1_PHASE_END()                                                   \
  do {                                                                   \
    if (threadIdx.x == 0) {                                              \
      for (int k1_i = 0; k1_i < 6; ++k1_i)                               \
        atomicAdd(&k1_phase_clocks[k1_i],                                \
                  static_cast<unsigned long long>(k1_acc[k1_i]));        \
      atomicAdd(&k1_phase_clocks[6], 1ull);                              \
      atomicAdd(&k1_phase_clocks[7],                                     \
                static_cast<unsigned long long>(clock64() - k1_t0));     \
    }                                                                    \
  } while (0)

// Copies the eight sums to out (host memory) and sets them to 0.
// Returns a cudaError_t.
extern "C" int k1_phase_clocks_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k1_phase_clocks,
                                         8 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(
      cudaMemcpyToSymbol(k1_phase_clocks, zero, sizeof(zero)));
}
