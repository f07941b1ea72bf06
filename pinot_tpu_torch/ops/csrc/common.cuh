// Helpers shared by the per-segment query kernels (each .cu builds into its
// own shared library with a plain C interface; see ops/build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace pinot {

constexpr int kThreads = 256;          // threads per block, every kernel
constexpr int kBlocksPerSm = 8;        // grid-stride grid: SMs x this

// Element type of a lane, as ops/kernels.py:_ELEM codes it.
enum Elem : int { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kF32 = 4, kF64 = 5 };

// Signed dictId lanes come at the width min_id_dtype chose (int8 / int16 /
// int32); every kernel reads a lane at its own width and computes in int32.
__device__ __forceinline__ int read_id(const void* lane, int elem, long long row) {
  switch (elem) {
    case kI8: return static_cast<const int8_t*>(lane)[row];
    case kI16: return static_cast<const int16_t*>(lane)[row];
    default: return static_cast<const int32_t*>(lane)[row];
  }
}

// Any lane's element as a float64: exact for every id, int32 and float32
// value; int64 rounds as JAX's promotion to float64 does.
__device__ __forceinline__ double read_value(const void* lane, int elem, long long row) {
  switch (elem) {
    case kI8: return static_cast<const int8_t*>(lane)[row];
    case kI16: return static_cast<const int16_t*>(lane)[row];
    case kI32: return static_cast<const int32_t*>(lane)[row];
    case kI64: return static_cast<double>(static_cast<const long long*>(lane)[row]);
    case kF32: return static_cast<const float*>(lane)[row];
    default: return static_cast<const double*>(lane)[row];
  }
}

// A numeric lane's element as 1 or 2 int32 words whose lexicographic
// (signed) order is the value order, bit for bit the words of
// pinot_tpu/ops/kernels.py:_monotone_int32_keys: ids and int32 as they
// are; float32 through its bits with a negative value's magnitude bits
// flipped (-0.0 before +0.0, NaNs by bit pattern); int64 and float64 (its
// bits mapped the same way) as the high word and the low word biased by
// 2^31. Returns the number of words written to w.
__device__ __forceinline__ int monotone_words(const void* lane, int elem, long long row,
                                              int32_t* w) {
  switch (elem) {
    case kF32: {
      const int32_t b = __float_as_int(static_cast<const float*>(lane)[row]);
      w[0] = b ^ ((b >> 31) & 0x7fffffff);
      return 1;
    }
    case kI64:
    case kF64: {
      long long b;
      if (elem == kI64) {
        b = static_cast<const long long*>(lane)[row];
      } else {
        b = __double_as_longlong(static_cast<const double*>(lane)[row]);
        b ^= (b >> 63) & 0x7fffffffffffffffLL;
      }
      w[0] = static_cast<int32_t>(b >> 32);
      w[1] = static_cast<int32_t>((b & 0xffffffffLL) - 0x80000000LL);
      return 2;
    }
    default:
      w[0] = read_id(lane, elem, row);
      return 1;
  }
}

// The first position of v in the ascending keys sk[0..n) whose element is
// not less than v (jnp.searchsorted, side "left"), clipped to n - 1: the
// probe of a raw-key join, which then tests sk[pos] == v. n <= 65,536, so
// at most 17 steps; the keys are read from device memory and stay in L2.
template <typename T>
__device__ __forceinline__ int probe_position(const T* sk, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n ? lo : n - 1;
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

// v replaces the stored value when it is smaller (is_min) or larger, or is
// a NaN; a stored NaN is never replaced. Works on shared or device memory.
__device__ __forceinline__ void atomic_extreme(double* addr, double v, bool is_min) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = *a;
  while (true) {
    const double cur = __longlong_as_double(old);
    if (isnan(cur)) return;
    if (!(isnan(v) || (is_min ? v < cur : v > cur))) return;
    const unsigned long long seen = atomicCAS(a, old, __double_as_longlong(v));
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_extreme(int* addr, int v, bool is_min) {
  if (is_min ? v < *addr : v > *addr) {
    if (is_min) atomicMin(addr, v); else atomicMax(addr, v);
  }
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

// Grid-stride grid of one full wave of `kernel`: as many blocks as its
// registers and `smem` bytes of dynamic shared memory let every SM hold
// at once, at most kBlocksPerSm each. A fixed count above that leaves a
// partial second wave, with most SMs idle at its end.
template <typename Kernel>
inline int grid_for(Kernel kernel, long long rows, size_t smem) {
  int device = 0, sms = 132, per_sm = kBlocksPerSm;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  long long blocks = (rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace pinot
