// Blocks of a cooperative kernel that fit on a device at once, for the
// launchers of the kernels that take a grid barrier (pyramid.cu, select.cu):
// a cooperative launch of more blocks than that is refused, so their grids
// never exceed it.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace coresident {

constexpr int MAX_DEVICES = 64;  // devices whose answer is kept

// Blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory, after its limit is raised to `smem_limit`) that fit on `device`
// at once, or 0 with *err set. `cache[device]` keeps the answer (0 until
// known).
inline int blocks(const void* kernel, int threads, int smem, int smem_limit, int device,
                  std::atomic<int> (&cache)[MAX_DEVICES], cudaError_t* err) {
  const bool kept = device >= 0 && device < MAX_DEVICES;
  if (kept) {
    const int known = cache[device].load(std::memory_order_relaxed);
    if (known > 0) return known;
  }
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit);
  if (*err != cudaSuccess) return 0;
  int per_sm = 0, n_sm = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  if (kept) cache[device].store(per_sm * n_sm, std::memory_order_relaxed);
  return per_sm * n_sm;
}

}  // namespace coresident
