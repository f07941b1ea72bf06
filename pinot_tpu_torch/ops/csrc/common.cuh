// Helpers shared by the per-segment query kernels (each .cu builds into its
// own shared library with a plain C interface; see ops/build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pinot {

constexpr int kThreads = 256;          // threads per block, every kernel
constexpr int kBlocksPerSm = 8;        // grid-stride grid: SMs x this

// Signed dictId lanes come at the width min_id_dtype chose (int8 / int16 /
// int32); every kernel reads a lane at its own width and computes in int32.
__device__ __forceinline__ int read_id(const void* lane, int elem_size,
                                       long long row) {
  switch (elem_size) {
    case 1: return static_cast<const int8_t*>(lane)[row];
    case 2: return static_cast<const int16_t*>(lane)[row];
    default: return static_cast<const int32_t*>(lane)[row];
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide int32 sum; the result is valid in thread 0. `scratch` holds
// one int per warp. Every thread of the block must call it.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();                      // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? scratch[lane] : 0;
    v = warp_sum(v);
  }
  return v;
}

inline int grid_for(long long rows) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace pinot
