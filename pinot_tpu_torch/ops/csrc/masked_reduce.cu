// K5 masked_reduce: one lane and the row mask in one pass: the match
// count, min and max, and the float64 sum of each 8192-row block.
//
// Replaces pinot_tpu/ops/kernels.py:_chunked_float_sum (:281) and the
// id, MV and raw min/max branches of _agg_outputs (:579-682):
//   id lane (int8 / int16 / int32 dictIds): min = min(where(mask, ids,
//     card_pad)), max = max(where(mask, ids, -1)), as int32 (:661-667);
//   MV id lane [P, W]: the same over the entries of matched rows that are
//     not padding (id < cardinality, the JAX entry mask, :653-660);
//   raw lane (int32 / int64 / float32 / float64): min = min(where(mask,
//     vals, +inf)), max = max(where(mask, vals, -inf)) (:668-682). JAX
//     promotes an integer lane to float64 there, and keeps a float lane's
//     dtype; this kernel compares every raw value as a float64 (exact for
//     float32, and rounding is monotonic, so the min of the rounded values
//     is the rounded min) and writes the result in the JAX dtype. A
//     matched NaN makes both NaN, as XLA's min and max propagate it;
//   sums[b] = sum over matched rows of block b of double(vals[row]), one
//     partial per 8192-row block (the JAX output, summed on the host).
//
// What bounds it: bytes: one mask byte and one lane element (a [W] row
// for MV) per row; the outputs are P / 8192 doubles and a few scalars.
//
// What the design does about it: one thread block per 8192-row block, so
// each partial is written by exactly one block with no atomics, and the
// sum inside a block runs in a fixed order (each thread's 8 rows in
// sequence, then a fixed shuffle tree, then the warps in order): the
// partials are the same on every run. Threads read neighbouring rows, so
// loads coalesce, and each thread issues its 8 mask loads together. Min
// and max are folded per block, then into one device word each with an
// integer atomicMax on an order-preserving 64-bit encoding of the value
// (min as the complement); min and max do not depend on the order, so
// they equal JAX bit for bit. The last block to finish
// (a counter after a fence) decodes the words into the typed outputs and
// the int32 count, so the result needs no second launch.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): the grid's
// y index is the member. Block (x, b) reads row block x of member b's
// mask and of the shared lane, with member b's state words and outputs;
// its sum runs in the single launch's order, so every member's partials
// are bit for bit those of its own launch.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRows = 8192;        // the JAX package's BLOCK
constexpr int kThreadsR = 1024;
constexpr int kPerThread = kRows / kThreadsR;   // 8 rows per thread

// state words (64-bit, zeroed by the wrapper): [0] max of ~enc(v), so 0
// means "none yet", [1] max of enc(v), [2] match count, [3] NaN seen,
// [4] blocks done

// order-preserving map of a double onto uint64
__device__ __forceinline__ unsigned long long enc(double v) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double dec(unsigned long long e) {
  const unsigned long long b = (e >> 63) ? (e & 0x7fffffffffffffffull) : ~e;
  return __longlong_as_double(static_cast<long long>(b));
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_max_u(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void masked_reduce_kernel(const uint8_t* __restrict__ mask,
                                     const void* __restrict__ lane, int elem,
                                     int width, int limit, int is_ids,
                                     int card_pad, int want_sum,
                                     unsigned long long* __restrict__ state,
                                     double* __restrict__ sums,
                                     void* __restrict__ out_min,
                                     void* __restrict__ out_max,
                                     int* __restrict__ out_count) {
  // member blockIdx.y: its mask row, state words and outputs
  const long long member = blockIdx.y;
  const long long padded = static_cast<long long>(gridDim.x) * kRows;
  const int out_bytes = is_ids || elem == pinot::kF32 ? 4 : 8;
  mask += member * padded;
  state += member * 5;
  if (want_sum) sums += member * gridDim.x;
  out_min = static_cast<char*>(out_min) + member * out_bytes;
  out_max = static_cast<char*>(out_max) + member * out_bytes;
  out_count += member;
  __shared__ double s_sum[kThreadsR / 32];
  __shared__ unsigned long long s_lo[kThreadsR / 32], s_hi[kThreadsR / 32];
  __shared__ int s_cnt[kThreadsR / 32], s_nan[kThreadsR / 32];
  __shared__ bool s_last;

  const long long base = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  double sum = 0.0;
  unsigned long long lo = 0ull, hi = 0ull;   // max of ~enc, max of enc
  int cnt = 0, nan = 0;
  uint8_t m[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) m[k] = mask[base + k * kThreadsR];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (!m[k]) continue;
    ++cnt;
    const long long row = base + k * kThreadsR;
    for (int w = 0; w < width; ++w) {
      const double v = pinot::read_value(lane, elem, row * width + w);
      if (is_ids && v >= limit) continue;      // an MV padding entry
      sum += v;
      if (isnan(v)) {
        nan = 1;
      } else {
        const unsigned long long e = enc(v);
        lo = ~e > lo ? ~e : lo;
        hi = e > hi ? e : hi;
      }
    }
  }
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  sum = warp_sum_d(sum);
  lo = warp_max_u(lo);
  hi = warp_max_u(hi);
  cnt = pinot::warp_sum(cnt);
  nan = __any_sync(0xffffffffu, nan);
  if (lane_id == 0) {
    s_sum[warp] = sum;
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_cnt[warp] = cnt;
    s_nan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double bs = 0.0;
    unsigned long long blo = 0ull, bhi = 0ull;
    int bc = 0, bn = 0;
    for (int w = 0; w < kThreadsR / 32; ++w) {   // fixed order
      bs += s_sum[w];
      blo = s_lo[w] > blo ? s_lo[w] : blo;
      bhi = s_hi[w] > bhi ? s_hi[w] : bhi;
      bc += s_cnt[w];
      bn |= s_nan[w];
    }
    if (want_sum) sums[blockIdx.x] = bs;
    if (bc != 0) {
      if (blo) atomicMax(state + 0, blo);
      if (bhi) atomicMax(state + 1, bhi);
      atomicAdd(state + 2, static_cast<unsigned long long>(bc));
      if (bn) atomicOr(state + 3, 1ull);
    }
    __threadfence();
    s_last = atomicAdd(state + 4, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  // the last block: decode the words into the typed outputs
  __threadfence();
  const unsigned long long w_lo = atomicAdd(state + 0, 0ull);
  const unsigned long long w_hi = atomicAdd(state + 1, 0ull);
  const bool any_nan = atomicAdd(state + 3, 0ull) != 0ull;
  out_count[0] = static_cast<int>(atomicAdd(state + 2, 0ull));
  if (is_ids) {
    // no NaN in an id lane; the JAX sentinels bound the result, and stay
    // when nothing matched
    static_cast<int*>(out_min)[0] = w_lo ? min(static_cast<int>(dec(~w_lo)), card_pad) : card_pad;
    static_cast<int*>(out_max)[0] = w_hi ? max(static_cast<int>(dec(w_hi)), -1) : -1;
    return;
  }
  double mn = w_lo ? dec(~w_lo) : INFINITY;
  double mx = w_hi ? dec(w_hi) : -INFINITY;
  if (any_nan) mn = mx = NAN;
  if (elem == pinot::kF32) {
    static_cast<float*>(out_min)[0] = static_cast<float>(mn);
    static_cast<float*>(out_max)[0] = static_cast<float>(mx);
  } else {
    static_cast<double*>(out_min)[0] = mn;
    static_cast<double*>(out_max)[0] = mx;
  }
}

int launch(const void* mask, const void* lane, int elem, int width, int limit,
           int is_ids, int card_pad, int want_sum, long long padded, int n_members,
           void* state, void* sums, void* out_min, void* out_max, void* out_count,
           void* stream) {
  if (padded <= 0 || padded % kRows != 0 || elem < pinot::kI8 || elem > pinot::kF64 ||
      width < 1 || (width > 1 && (!is_ids || want_sum)) || n_members < 1 ||
      n_members > 65535)
    return -1;
  const long long blocks = padded / kRows;
  masked_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), n_members), kThreadsR, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), lane, elem, width, limit, is_ids, card_pad,
      want_sum,
      static_cast<unsigned long long*>(state), static_cast<double*>(sums), out_min,
      out_max, static_cast<int*>(out_count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pinot_masked_reduce(const void* mask, const void* lane, int elem,
                                   int width, int limit, int is_ids, int card_pad,
                                   int want_sum, long long padded, void* state,
                                   void* sums, void* out_min, void* out_max,
                                   void* out_count, void* stream) {
  return launch(mask, lane, elem, width, limit, is_ids, card_pad, want_sum, padded, 1,
                state, sums, out_min, out_max, out_count, stream);
}

// mask uint8 [n_members][padded]; state int64 [n_members][5], zeroed;
// sums float64 [n_members][padded / 8192]; out_min / out_max / out_count
// [n_members] each.
extern "C" int pinot_masked_reduce_batched(const void* mask, const void* lane, int elem,
                                           int width, int limit, int is_ids,
                                           int card_pad, int want_sum, long long padded,
                                           int n_members, void* state, void* sums,
                                           void* out_min, void* out_max, void* out_count,
                                           void* stream) {
  return launch(mask, lane, elem, width, limit, is_ids, card_pad, want_sum, padded,
                n_members, state, sums, out_min, out_max, out_count, stream);
}
