// K7 hll_registers: HyperLogLog registers of the dictIds a segment's
// matched rows hold, from their histogram.
//
// Replaces the "hll" branch of pinot_tpu/ops/kernels.py:_agg_outputs
// (:620-636): out[r] = max over d with hist[d] > 0 and idx[d] == r of
// rank[d], 0 where there is none, for r in [0, m). idx and rank are the
// per-dictId register index and rank tables the loader builds from the
// dictionary with the host sketch's own hashing (sketches.hll_tables), so
// the registers equal HyperLogLog.from_values(the present values) bit for
// bit. Padding dictIds carry rank 0, the max identity. Launched after K4,
// on the histogram K4 wrote.
//
// What bounds it: neither bytes nor operations: the work is O(card_pad)
// (997 ids for playerName, 16 for teamID), three int32 reads per id and
// 4 * m bytes written, so the launch itself is the cost.
//
// What the design does about it: one pass, few blocks. Each block keeps
// its own m registers in shared memory, folds its share of the ids into
// them with shared atomicMax, and merges the non-zero registers into the
// zeroed device registers with one atomicMax each. Integer max does not
// depend on the order, so the result is exact.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): the grid's
// y index is the member; block (x, b) reads member b's histogram row and
// the shared tables, and writes member b's registers.

#include "common.cuh"

namespace {

constexpr int kMaxRegisters = 8192;     // 32 KB of int32 in shared memory
constexpr int kMaxBlocks = 32;

__global__ void hll_registers_kernel(const int* __restrict__ hist,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ rank,
                                     int card_pad, int m,
                                     int* __restrict__ out) {
  extern __shared__ int regs[];
  hist += blockIdx.y * static_cast<long long>(card_pad);   // member blockIdx.y
  out += blockIdx.y * static_cast<long long>(m);
  for (int r = threadIdx.x; r < m; r += blockDim.x) regs[r] = 0;
  __syncthreads();
  const int step = gridDim.x * blockDim.x;
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < card_pad; d += step) {
    if (hist[d] <= 0) continue;
    const int r = idx[d], v = rank[d];
    if (r >= 0 && r < m && v > 0) atomicMax(regs + r, v);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += blockDim.x)
    if (regs[r] > 0) atomicMax(out + r, regs[r]);
}

int launch(const void* hist, const void* idx, const void* rank, int card_pad,
           int m, int n_members, void* out, void* stream) {
  if (card_pad < 1 || m < 1 || m > kMaxRegisters || n_members < 1 ||
      n_members > 65535)
    return -1;
  long long blocks = (card_pad + pinot::kThreads - 1) / pinot::kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hll_registers_kernel<<<dim3(static_cast<unsigned>(blocks), n_members), pinot::kThreads,
                         static_cast<size_t>(m) * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(hist), static_cast<const int*>(idx),
      static_cast<const int*>(rank), card_pad, m, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pinot_hll_registers(const void* hist, const void* idx,
                                   const void* rank, int card_pad, int m,
                                   void* out, void* stream) {
  return launch(hist, idx, rank, card_pad, m, 1, out, stream);
}

// hist int32 [n_members][card_pad]; out int32 [n_members][m], zeroed.
extern "C" int pinot_hll_registers_batched(const void* hist, const void* idx,
                                           const void* rank, int card_pad, int m,
                                           int n_members, void* out, void* stream) {
  return launch(hist, idx, rank, card_pad, m, n_members, out, stream);
}
