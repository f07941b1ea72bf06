// K11 ivf_recenter: the recentering half of one Lloyd step.
//
// Replaces the one-hot recentering of pinot_tpu/ops/ivf_kernels.py:
// build_ivf_train_kernel (:51-69), which K10's assignments feed (the train
// step is K10 then K11):
//   counts[c] = #{r < n_rows : assign[r] == c}
//   new[c]    = sum_{r < n_rows, assign[r] == c} data[r] / counts[c],
//               or the prior centroid where counts[c] == 0.
// The JAX kernel sums with a one-hot matmul (oh.T @ data) whose order is
// XLA's; here each centroid's sum runs over its rows in ascending row
// order, one f32 add at a time, with no atomics: the same rows and prior
// give the same codebook bits on every run, which is what makes a sealed
// codebook reproducible (pinot_tpu/index/ivf.py:train). Cross-backend the
// sums differ in the last bits, as the JAX module says training may.
//
// What bounds it: bytes, at the sizes training uses (a sample of at most
// trainSampleSize rows): every row of data is read once by the block of
// its centroid, and every block reads the n assignments (4 bytes each),
// so C_pad * n * 4 bytes of assignment reads (256 x 65,536 rows: 64 MB,
// from L2). What the design does about it: one block per centroid; the
// block scans the assignments 256 at a time, compacts the rows that are
// its own into shared memory in row order (warp ballots and a prefix over
// the warps), and its threads, one per dim, add those rows' elements:
// coalesced row reads, a fixed order, and no cross-block reduction.

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

__global__ void __launch_bounds__(pinot::kThreads)
    recenter_kernel(const float* __restrict__ data, const int* __restrict__ assign,
                    long long n_rows, int dim_pad, const float* __restrict__ prior,
                    float* __restrict__ out, int* __restrict__ counts) {
  constexpr int kWarps = pinot::kThreads / 32;
  __shared__ int rows[pinot::kThreads];
  __shared__ int warp_n[kWarps];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kDimsPerThread = pinot::kMaxVecDim / pinot::kThreads;
  float sum[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) sum[j] = 0.f;
  long long count = 0;
  for (long long base = 0; base < n_rows; base += pinot::kThreads) {
    const long long r = base + threadIdx.x;
    const bool mine = r < n_rows && assign[r] == c;
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (mine) rows[before + __popc(ballot & ((1u << lane) - 1u))] = static_cast<int>(r);
    __syncthreads();
    // rows[0, total) ascend: add them in that order
    for (int i = 0; i < total; ++i) {
      const float* p = data + static_cast<long long>(rows[i]) * dim_pad;
#pragma unroll
      for (int j = 0; j < kDimsPerThread; ++j) {
        const int d = threadIdx.x + j * pinot::kThreads;
        if (d < dim_pad) sum[j] = __fadd_rn(sum[j], p[d]);
      }
    }
    count += total;
    __syncthreads();            // rows / warp_n are rewritten next pass
  }
  const float fc = static_cast<float>(count);
#pragma unroll
  for (int j = 0; j < kDimsPerThread; ++j) {
    const int d = threadIdx.x + j * pinot::kThreads;
    if (d < dim_pad) {
      const long long at = static_cast<long long>(c) * dim_pad + d;
      out[at] = count > 0 ? __fdiv_rn(sum[j], fc) : prior[at];
    }
  }
  if (threadIdx.x == 0) counts[c] = static_cast<int>(count);
}

}  // namespace

// data f32 [n][dim_pad], assign int32 [n] (K10's), prior f32
// [c_pad][dim_pad]; out f32 [c_pad][dim_pad], counts int32 [c_pad]. Rows
// r >= n_rows are padding and count nowhere.
extern "C" int pinot_ivf_recenter(const void* data, const void* assign, long long n_rows,
                                  int dim_pad, const void* prior, int c_pad, void* out,
                                  void* counts, void* stream) {
  if (n_rows < 0 || n_rows > 0x7fffffffLL || dim_pad < 1 || dim_pad > pinot::kMaxVecDim ||
      c_pad < 1)
    return -1;
  recenter_kernel<<<c_pad, pinot::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(assign), n_rows, dim_pad,
      static_cast<const float*>(prior), static_cast<float*>(out), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
