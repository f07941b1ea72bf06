// K2 masked_part_sums: exact masked sums of 7-bit int8 part lanes, plus the
// match count.
//
// Replaces pinot_tpu/ops/kernels.py:_part_sums (:248) and the masked count
// of _agg_outputs (:579-600): out[l] = sum over matched rows of
// parts[l][row] for each part lane l, out[L] = number of matched rows.
//
// What bounds it: bytes. One mask byte per row, and one int8 per part lane
// for the rows that match; an integer add per byte.
//
// What the design does about it: a grid-stride loop with one row per
// thread reads the mask coalesced and touches a row's part lanes only when
// the row matched, so a selective filter leaves most part-lane sectors
// unread. Every thread keeps int32 sums in registers; a warp-shuffle and
// then a block reduction leave one integer atomicAdd per block per output.
// Integer atomics make the result exact and independent of block order.
// Exactness of int32: 7-bit lanes bound every sum by 127 * P, and the
// wrapper refuses P with 127 * P >= 2^31.

#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;

struct PartLanes {
  const int8_t* ptr[kMaxParts];
};

__global__ void masked_part_sums_kernel(const uint8_t* __restrict__ mask,
                                        PartLanes parts, int n_parts,
                                        long long padded,
                                        int* __restrict__ out) {
  __shared__ int scratch[32];
  int acc[kMaxParts];
#pragma unroll
  for (int l = 0; l < kMaxParts; ++l) acc[l] = 0;
  int count = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < padded; row += step) {
    if (mask[row]) {
      ++count;
#pragma unroll
      for (int l = 0; l < kMaxParts; ++l)
        if (l < n_parts) acc[l] += parts.ptr[l][row];
    }
  }
#pragma unroll
  for (int l = 0; l < kMaxParts; ++l) {
    if (l < n_parts) {                 // uniform across the block
      const int s = pinot::block_sum(acc[l], scratch);
      if (threadIdx.x == 0 && s != 0) atomicAdd(out + l, s);
    }
  }
  const int c = pinot::block_sum(count, scratch);
  if (threadIdx.x == 0 && c != 0) atomicAdd(out + n_parts, c);
}

}  // namespace

extern "C" int pinot_masked_part_sums(const void* mask,
                                      const void* const* part_ptrs,
                                      int n_parts, long long padded,
                                      void* out, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts) return -1;
  PartLanes parts{};
  for (int l = 0; l < n_parts; ++l)
    parts.ptr[l] = static_cast<const int8_t*>(part_ptrs[l]);
  masked_part_sums_kernel<<<pinot::grid_for(padded), pinot::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), parts, n_parts, padded,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
