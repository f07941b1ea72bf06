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
//
// Rows of seg_rows rows: the output has one row of L + 1 sums per
// seg_rows input rows, out[s][l] over rows [s * seg_rows, (s + 1) *
// seg_rows). For stacked segments (the counterpart of the vmap in
// pinot_tpu/parallel/sharded.py:get_sharded_kernel) a row is a segment,
// and the rows are the JAX `partsT` regime's exact partials: the host adds
// them in int64. A block's rows in one pass of the grid-stride loop never
// straddle two output rows (seg_rows is a multiple of the block), so a
// block adds its register sums with one atomic per output when its rows
// move to the next output row. Exactness of int32: 7-bit lanes bound every
// sum by 127 * seg_rows, and the wrapper splits a segment with 127 * rows
// >= 2^31 into row ranges below that bound (ops/kernels.py:
// part_sum_range), one output row each, as the JAX `_part_sums` returns
// block partials for such a segment (:276-279).

#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;

struct PartLanes {
  const int8_t* ptr[kMaxParts];
};

// kStacked: more than one output row (seg_rows < padded); one row runs an
// instantiation without the segment bookkeeping, which cost the
// single-segment sums 15% on the H100 (PERF.md).
template <bool kStacked>
__global__ void masked_part_sums_kernel(const uint8_t* __restrict__ mask,
                                        PartLanes parts, int n_parts,
                                        long long padded, long long seg_rows,
                                        int* __restrict__ out) {
  __shared__ int scratch[32];
  int acc[kMaxParts];
#pragma unroll
  for (int l = 0; l < kMaxParts; ++l) acc[l] = 0;
  int count = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long seg = 0, seg_end = padded;
  if constexpr (kStacked) {
    seg = row / seg_rows;
    seg_end = (seg + 1) * seg_rows;
  }
  // block-uniform: every thread of the block calls it at the same point
  auto flush = [&]() {
    int* dst = out + seg * (n_parts + 1);
#pragma unroll
    for (int l = 0; l < kMaxParts; ++l) {
      if (l < n_parts) {               // uniform across the block
        const int s = pinot::block_sum(acc[l], scratch);
        if (threadIdx.x == 0 && s != 0) atomicAdd(dst + l, s);
        acc[l] = 0;
      }
    }
    const int c = pinot::block_sum(count, scratch);
    if (threadIdx.x == 0 && c != 0) atomicAdd(dst + n_parts, c);
    count = 0;
  };
  for (; row < padded; row += step) {
    if constexpr (kStacked) {
      if (row >= seg_end) {
        flush();
        seg = row / seg_rows;
        seg_end = (seg + 1) * seg_rows;
      }
    }
    if (mask[row]) {
      ++count;
#pragma unroll
      for (int l = 0; l < kMaxParts; ++l)
        if (l < n_parts) acc[l] += parts.ptr[l][row];
    }
  }
  flush();
}

}  // namespace

// out: int32 [padded / seg_rows][n_parts + 1], zeroed.
extern "C" int pinot_masked_part_sums(const void* mask,
                                      const void* const* part_ptrs,
                                      int n_parts, long long padded,
                                      long long seg_rows, void* out,
                                      void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || seg_rows < 1 ||
      seg_rows % pinot::kThreads != 0 || padded % seg_rows != 0)
    return -1;
  PartLanes parts{};
  for (int l = 0; l < n_parts; ++l)
    parts.ptr[l] = static_cast<const int8_t*>(part_ptrs[l]);
  // one full wave: the stacked instantiation takes more registers, and a
  // fixed 8 blocks per SM would leave a partial second wave
  const auto kernel = seg_rows < padded ? masked_part_sums_kernel<true>
                                        : masked_part_sums_kernel<false>;
  kernel<<<pinot::grid_for(kernel, padded, 0), pinot::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), parts, n_parts, padded, seg_rows,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
