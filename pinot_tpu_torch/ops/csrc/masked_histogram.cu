// K4 masked_histogram: exact int32 counts of the dictIds of matched rows.
//
// Replaces pinot_tpu/ops/kernels.py:_histogram (:566), which takes
// _mxu_histogram (:354, one-hot matrix products built from _cmp_onehot
// :308 and _radix_onehots :324) up to DENSE_CARD_LIMIT and a scatter-add
// above it, and the MV entry histogram of _agg_outputs (:638-652):
// out[v] = number of entries e of rows with mask[row] != 0 and
// ids[row, e] == v, for v in [0, limit), where a single-value lane has one
// entry per row and limit = card_pad (ids outside count nowhere, as the
// one-hot compare drops them), and an MV lane [P, W] has W with limit =
// the cardinality (padding entries, id == cardinality, count nowhere, as
// the JAX entry mask drops them). `total`, when given, receives the number
// of entries counted: COUNTMV's answer, the JAX hist[:card].sum(). The
// planner uses it for DISTINCTCOUNT, PERCENTILE, SUM / AVG over a float
// dictionary, expression aggregations, the HLL registers' present set (K7
// reads it) and the MV aggregations (the host finishes each from the
// counts and the dictionary).
//
// What bounds it: bytes, one mask byte per row and one id (a [W] row for
// MV) for each matched row, plus the table written; unless many matched
// rows share few ids, when atomics on the same address serialise (teamID
// has 16 values, position 10).
//
// What the design does about it: the TPU built one-hot tiles for the
// matrix unit; on Hopper the histogram is an atomic increment. When the
// table fits in shared memory (card_pad <= 16384 counts, 64 KB), every
// block counts into its own copy there with shared atomics and adds it to
// the device table at the end, one atomic per non-zero bin per block. So
// hot ids contend only inside a block, in shared memory. Above that, rows
// add straight into the device table. Integer atomics: the counts are
// exact and do not depend on the order.

#include "common.cuh"

namespace {

constexpr int kMaxSmemBins = 16384;        // 64 KB of int32 counts

__global__ void masked_histogram_kernel(const uint8_t* __restrict__ mask,
                                        const void* __restrict__ ids,
                                        int elem, long long padded, int width,
                                        int limit, int card_pad, int use_smem,
                                        int* __restrict__ out,
                                        int* __restrict__ total) {
  extern __shared__ int bins[];
  __shared__ int scratch[32];
  mask += blockIdx.y * padded;                       // member blockIdx.y
  out += blockIdx.y * static_cast<long long>(card_pad);
  if (total != nullptr) total += blockIdx.y;
  int* table = out;
  if (use_smem) {
    for (int b = threadIdx.x; b < card_pad; b += blockDim.x) bins[b] = 0;
    __syncthreads();
    table = bins;
  }
  int local = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < padded; row += step) {
    if (!mask[row]) continue;
    for (int e = 0; e < width; ++e) {
      const int v = pinot::read_id(ids, elem, row * width + e);
      if (v >= 0 && v < limit) {
        atomicAdd(table + v, 1);
        ++local;
      }
    }
  }
  if (use_smem) {
    __syncthreads();
    for (int b = threadIdx.x; b < card_pad; b += blockDim.x)
      if (bins[b] != 0) atomicAdd(out + b, bins[b]);
  }
  if (total != nullptr) {
    const int n = pinot::block_sum(local, scratch);
    if (threadIdx.x == 0 && n != 0) atomicAdd(total, n);
  }
}

int launch(const void* mask, const void* ids, int elem, long long padded,
           int width, int limit, int card_pad, int n_members, void* out,
           void* total, void* stream) {
  if (card_pad < 1 || width < 1 || limit < 0 || limit > card_pad ||
      elem < pinot::kI8 || elem > pinot::kI32 || n_members < 1 ||
      n_members > 65535)
    return -1;
  const int use_smem = card_pad <= kMaxSmemBins ? 1 : 0;
  const size_t smem = use_smem ? static_cast<size_t>(card_pad) * sizeof(int) : 0;
  if (smem + sizeof(int) * 32 > 48 * 1024) {   // the static scratch counts too
    const cudaError_t rc = cudaFuncSetAttribute(
        masked_histogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int wave = pinot::grid_for(masked_histogram_kernel, padded, smem);
  const dim3 grid((wave + n_members - 1) / n_members, n_members);
  masked_histogram_kernel<<<grid, pinot::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), ids, elem, padded, width, limit,
      card_pad, use_smem, static_cast<int*>(out), static_cast<int*>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pinot_masked_histogram(const void* mask, const void* ids,
                                      int elem, long long padded, int width,
                                      int limit, int card_pad, void* out,
                                      void* total, void* stream) {
  return launch(mask, ids, elem, padded, width, limit, card_pad, 1, out,
                total, stream);
}

// mask uint8 [n_members][padded]; out int32 [n_members][card_pad] and
// total int32 [n_members] (or null), zeroed.
extern "C" int pinot_masked_histogram_batched(const void* mask, const void* ids,
                                              int elem, long long padded,
                                              int width, int limit, int card_pad,
                                              int n_members, void* out,
                                              void* total, void* stream) {
  return launch(mask, ids, elem, padded, width, limit, card_pad, n_members,
                out, total, stream);
}
