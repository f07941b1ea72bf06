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
// Any nonzero mask byte is a match.
//
// What bounds it: bytes: one mask byte and one lane element (a [W] row
// for MV) a row; the outputs are P / 8192 doubles and a few scalars.
//
// What the design does about it: 256 threads take an 8192-row block,
// each thread 32 rows as two 16-byte mask words (neighbouring threads on
// neighbouring words), and a grid of one wave walks the blocks, each CTA
// loading its next block's words while it folds this one's. The kernel
// is compiled for each lane type and shape (SV ids, SV raw, MV ids), so a
// value is read at its own width with no type switch. An id lane of 1-2
// bytes a row is read as 16-byte words beside the mask words; a 4- or
// 8-byte lane only in the 16-byte words whose rows hold a match; an MV
// lane's [16, W] rows only where the mask word holds a match. The block
// sum runs in a fixed order: each thread's matched rows in row order, a
// fixed shuffle tree in each warp, then a fixed shuffle tree over the 8
// warps; so a partial is the same on every run, in a stacked launch and
// in each segment's own, and for a batch member and its own launch. Min
// and max fold in registers (ids as int32, raw values as order-preserving
// 64-bit keys), then into one device word each with an integer atomicMax
// on the keys (min as the complement); min and max do not depend on the
// order, so they equal JAX bit for bit. The last CTA to finish (a counter
// after a fence) decodes the words into the typed outputs and the int32
// count, so the result needs no second launch.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): grid y is
// the member. A wave of CTAs is split over the members, each walking its
// member's blocks with its own mask, registers, state words and outputs,
// in the single launch's order. The members' CTAs read the shared lane at
// about the same time, so the L2 serves most of its reads after the
// first; CTAs that served 8 members each over the same rows were slower
// (their registers left one CTA an SM).
//
// Routes: "vector" reads every operand as aligned 16-byte words;
// "bytes" (an operand off a 16-byte boundary) assembles the same words
// from byte loads. The wrapper picks by the operands' addresses.

#include <math.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 8192;                         // the JAX package's BLOCK
constexpr int kWordRows = 16;                       // rows a 16-byte mask word
constexpr int kHalf = kRows / 2;                    // a thread's two words lie kHalf apart
constexpr int kWarps = pinot::kThreads / 32;
constexpr int kMvWords = 4;                         // MV lane words in flight a step

enum Shape : int { kSvIds = 0, kSvRaw = 1, kMvIds = 2 };

// state words a member (64-bit, zeroed by the wrapper): [0] max of ~key,
// so 0 means "none yet", [1] max of key, [2] match count, [3] NaN seen,
// [4] CTAs done
constexpr int kStateWords = 5;

struct Args {
  const uint8_t* mask;       // [n_members][padded]
  long long padded;
  const void* lane;          // [padded] or [padded][width]
  int width;
  int limit;                 // MV: entries with an id >= limit are padding
  int card_pad;
  int want_sum;
  int vec;                   // route "vector": every operand aligned
  int n_members;
  unsigned long long* state; // [n_members][kStateWords]
  double* sums;              // [n_members][padded / kRows] or null
  void* out_min;             // [n_members] each
  void* out_max;
  int* out_count;
};

// order-preserving map of a double onto uint64
__device__ __forceinline__ unsigned long long enc(double v) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double dec(unsigned long long e) {
  const unsigned long long b = (e >> 63) ? (e & 0x7fffffffffffffffull) : ~e;
  return __longlong_as_double(static_cast<long long>(b));
}

// an id's key: bit 32 set, so neither the key nor its complement is 0
__device__ __forceinline__ unsigned long long id_key(int v) {
  return (1ull << 32) | (static_cast<unsigned>(v) ^ 0x80000000u);
}

__device__ __forceinline__ int id_of(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
}

__device__ __forceinline__ uint32_t comp(const uint4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

// element i of consecutive words w (i a constant once unrolled)
template <typename T>
__device__ __forceinline__ T elem(const uint4* w, int i) {
  constexpr int kSize = sizeof(T);
  const int byte = i * kSize;
  const uint4& q = w[byte >> 4];
  const int c = (byte >> 2) & 3;
  if constexpr (kSize == 1) {
    return static_cast<T>(static_cast<int8_t>(comp(q, c) >> (8 * (byte & 3))));
  } else if constexpr (kSize == 2) {
    return static_cast<T>(static_cast<int16_t>(comp(q, c) >> (8 * (byte & 3))));
  } else if constexpr (kSize == 4) {
    const uint32_t bits = comp(q, c);
    T v;
    memcpy(&v, &bits, 4);
    return v;
  } else {
    const unsigned long long bits =
        comp(q, c) | (static_cast<unsigned long long>(comp(q, c + 1)) << 32);
    T v;
    memcpy(&v, &bits, 8);
    return v;
  }
}

// a thread's registers: its block's sum (reset each block), its min and
// max (ids as int32, raw values as keys: max of ~enc, max of enc; 0 none)
template <int kShape>
struct Acc {
  double sum = 0.0;
  int cnt = 0, nan = 0;
  int mn = 0x7fffffff, mx = -0x7fffffff - 1;      // ids
  unsigned long long lo = 0ull, hi = 0ull;        // raw values
};

template <typename T, int kShape>
__device__ __forceinline__ void fold(Acc<kShape>& r, T v, const Args& a, bool want_sum) {
  if constexpr (kShape == kMvIds) {
    if (static_cast<int>(v) >= a.limit) return;   // an MV padding entry
  }
  if constexpr (kShape != kMvIds) {
    if (want_sum) r.sum += static_cast<double>(v);
  }
  if constexpr (kShape == kSvRaw) {
    const double d = static_cast<double>(v);
    if constexpr (std::is_floating_point<T>::value) {
      if (isnan(d)) {
        r.nan = 1;
        return;
      }
    }
    const unsigned long long k = enc(d);
    r.lo = ~k > r.lo ? ~k : r.lo;
    r.hi = k > r.hi ? k : r.hi;
  } else {
    r.mn = min(r.mn, static_cast<int>(v));
    r.mx = max(r.mx, static_cast<int>(v));
  }
}

// The kernel for one lane type and shape. A CTA serves one member (grid y)
// and walks the 8192-row blocks blockIdx.x, + gridDim.x, ...
template <typename T, int kShape>
__global__ void __launch_bounds__(pinot::kThreads) masked_reduce_kernel(const Args a) {
  constexpr int kSize = sizeof(T);
  constexpr int kEpw = 16 / kSize;                  // elements a 16-byte word
  // SV lane words a mask word; dense where a row takes 1-2 bytes
  constexpr int kLaneWords = kShape == kMvIds ? 1 : kSize;
  constexpr bool kDense = kShape == kSvIds && kSize <= 2;
  constexpr int kDenseWords = kDense ? kLaneWords : 1;
  __shared__ double s_sum[2][kWarps];
  __shared__ unsigned long long s_lo[kWarps], s_hi[kWarps];
  __shared__ int s_cnt[kWarps], s_nan[kWarps];
  __shared__ bool s_last;

  const long long n_blocks = a.padded / kRows;
  const int member = blockIdx.y;
  const uint8_t* mask = a.mask + member * a.padded;
  const bool want_sum = a.want_sum != 0;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* lane = static_cast<const T*>(a.lane);
  Acc<kShape> r;

  // a block's mask words (and dense lane words): the next block's load
  // while this one folds, so the CTA's loads stay in flight
  uint4 mw[2], dw[2][kDenseWords];
  auto load_words = [&](long long blk) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long row = blk * kRows + j * kHalf + static_cast<long long>(threadIdx.x) * kWordRows;
      mw[j] = pinot::load16(mask + row, a.vec);
      if constexpr (kDense) {
#pragma unroll
        for (int k = 0; k < kLaneWords; ++k) dw[j][k] = pinot::load16(lane + row + k * kEpw, a.vec);
      }
    }
  };

  int parity = 0;
  long long blk = blockIdx.x;
  load_words(blk);
  for (; blk < n_blocks; blk += gridDim.x, parity ^= 1) {
    long long row[2];
    unsigned bits[2];
    uint4 dcur[2][kDenseWords];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      row[j] = blk * kRows + j * kHalf + static_cast<long long>(threadIdx.x) * kWordRows;
      bits[j] = pinot::match_bits(mw[j]);
      r.cnt += __popc(bits[j]);
#pragma unroll
      for (int k = 0; k < kDenseWords; ++k) dcur[j][k] = dw[j][k];
    }
    if (blk + gridDim.x < n_blocks) load_words(blk + gridDim.x);
    if constexpr (kShape != kMvIds) {
      uint4 w[2][kLaneWords];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < kLaneWords; ++k) {
          const unsigned rows_of_k = ((1u << kEpw) - 1u) << (k * kEpw);
          if constexpr (kDense)
            w[j][k] = dcur[j][k < kDenseWords ? k : 0];
          else if (bits[j] & rows_of_k)
            w[j][k] = pinot::load16(lane + row[j] + k * kEpw, a.vec);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < kWordRows; ++i)
          if ((bits[j] >> i) & 1u) fold<T, kShape>(r, elem<T>(w[j], i), a, want_sum);
    } else {
      // an MV lane: the [16, W] entries of a word's rows, kMvWords 16-byte
      // words at a time, entry (row, e) in row-major order
      const int words = a.width * kSize;            // 16 rows x W x kSize / 16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!bits[j]) continue;
        const T* chunk = lane + row[j] * a.width;
        int rw = 0, e = 0;                          // the next entry's row, index
        for (int k0 = 0; k0 < words; k0 += kMvWords) {
          uint4 w[kMvWords];
#pragma unroll
          for (int k = 0; k < kMvWords; ++k)
            if (k0 + k < words) w[k] = pinot::load16(chunk + (k0 + k) * kEpw, a.vec);
#pragma unroll
          for (int k = 0; k < kMvWords; ++k) {
            if (k0 + k >= words) break;
#pragma unroll
            for (int i = 0; i < kEpw; ++i) {
              if ((bits[j] >> rw) & 1u) fold<T, kShape>(r, elem<T>(w + k, i), a, false);
              if (++e == a.width) {
                e = 0;
                ++rw;
              }
            }
          }
        }
      }
    }
    if (want_sum) {
      // the block's sum: a fixed tree in each warp, then over the warps
      double v = r.sum;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane_id == 0) s_sum[parity][warp] = v;
      r.sum = 0.0;
      __syncthreads();
      if (warp == 0) {
        v = lane_id < kWarps ? s_sum[parity][lane_id] : 0.0;
#pragma unroll
        for (int off = kWarps / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane_id == 0) a.sums[member * n_blocks + blk] = v;
      }
    }
  }

  // min / max as keys (ids: bit 32 set, so neither key nor complement is
  // 0), folded over the CTA, then into the member's state words
  unsigned long long lo = r.lo, hi = r.hi;
  if constexpr (kShape != kSvRaw) {
    if (r.mn <= r.mx) {
      lo = ~id_key(r.mn);
      hi = id_key(r.mx);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long l2 = __shfl_xor_sync(0xffffffffu, lo, off);
    const unsigned long long h2 = __shfl_xor_sync(0xffffffffu, hi, off);
    lo = l2 > lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  const int cnt = __reduce_add_sync(0xffffffffu, r.cnt);
  const int nan = __any_sync(0xffffffffu, r.nan);
  if (lane_id == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
    s_cnt[warp] = cnt;
    s_nan[warp] = nan;
  }
  __syncthreads();
  unsigned long long* st = a.state + member * kStateWords;
  if (threadIdx.x == 0) {
    unsigned long long b_lo = 0ull, b_hi = 0ull;
    int b_cnt = 0, b_nan = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      b_lo = s_lo[w] > b_lo ? s_lo[w] : b_lo;
      b_hi = s_hi[w] > b_hi ? s_hi[w] : b_hi;
      b_cnt += s_cnt[w];
      b_nan |= s_nan[w];
    }
    if (b_lo) atomicMax(st + 0, b_lo);
    if (b_hi) atomicMax(st + 1, b_hi);
    if (b_cnt) atomicAdd(st + 2, static_cast<unsigned long long>(b_cnt));
    if (b_nan) atomicOr(st + 3, 1ull);
    __threadfence();
    s_last = atomicAdd(st + 4, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;

  // the member's last CTA: decode its words into the typed outputs
  __threadfence();
  const unsigned long long w_lo = atomicAdd(st + 0, 0ull);
  const unsigned long long w_hi = atomicAdd(st + 1, 0ull);
  const bool any_nan = atomicAdd(st + 3, 0ull) != 0ull;
  a.out_count[member] = static_cast<int>(atomicAdd(st + 2, 0ull));
  if constexpr (kShape != kSvRaw) {
    // no NaN in an id lane; the JAX sentinels bound the result, and stay
    // when nothing matched
    static_cast<int*>(a.out_min)[member] = w_lo ? min(id_of(~w_lo), a.card_pad) : a.card_pad;
    static_cast<int*>(a.out_max)[member] = w_hi ? max(id_of(w_hi), -1) : -1;
  } else {
    double mn = w_lo ? dec(~w_lo) : INFINITY;
    double mx = w_hi ? dec(w_hi) : -INFINITY;
    if (any_nan) mn = mx = NAN;
    if constexpr (std::is_same<T, float>::value) {
      static_cast<float*>(a.out_min)[member] = static_cast<float>(mn);
      static_cast<float*>(a.out_max)[member] = static_cast<float>(mx);
    } else {
      static_cast<double*>(a.out_min)[member] = mn;
      static_cast<double*>(a.out_max)[member] = mx;
    }
  }
}

// one wave of CTAs split over the members, each walking its member's blocks
template <typename T, int kShape>
int launch_members(const Args& a, cudaStream_t stream) {
  const auto kernel = masked_reduce_kernel<T, kShape>;
  const long long n_blocks = a.padded / kRows;
  // a wave, or every block of every member where they are fewer
  const long long wave = pinot::grid_for(kernel, n_blocks * a.n_members * pinot::kThreads, 0);
  const long long grid = (wave + a.n_members - 1) / a.n_members;
  kernel<<<dim3(static_cast<unsigned>(grid), a.n_members), pinot::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kShape>
int launch_ids(const Args& a, int elem, cudaStream_t stream) {
  switch (elem) {
    case pinot::kI8: return launch_members<int8_t, kShape>(a, stream);
    case pinot::kI16: return launch_members<int16_t, kShape>(a, stream);
    case pinot::kI32: return launch_members<int32_t, kShape>(a, stream);
    default: return -1;
  }
}

int launch(const void* mask, const void* lane, int elem, int width, int limit, int is_ids,
           int card_pad, int want_sum, long long padded, int n_members, int vec, void* state,
           void* sums, void* out_min, void* out_max, void* out_count, void* stream) {
  if (padded <= 0 || padded % kRows != 0 || width < 1 ||
      (width > 1 && (!is_ids || want_sum)) || n_members < 1 || n_members > 65535)
    return -1;
  const Args a{static_cast<const uint8_t*>(mask), padded, lane, width, limit, card_pad,
               want_sum, vec, n_members, static_cast<unsigned long long*>(state),
               static_cast<double*>(sums), out_min, out_max, static_cast<int*>(out_count)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // an MV lane ([P, W], W >= 1) comes with its cardinality as `limit`, an
  // SV lane with INT32_MAX
  if (is_ids) return limit < 0x7fffffff ? launch_ids<kMvIds>(a, elem, s)
                                        : launch_ids<kSvIds>(a, elem, s);
  switch (elem) {
    case pinot::kI32: return launch_members<int32_t, kSvRaw>(a, s);
    case pinot::kI64: return launch_members<long long, kSvRaw>(a, s);
    case pinot::kF32: return launch_members<float, kSvRaw>(a, s);
    case pinot::kF64: return launch_members<double, kSvRaw>(a, s);
    default: return -1;
  }
}

}  // namespace

// state int64 [5], zeroed; sums float64 [padded / 8192] (want_sum);
// out_min / out_max / out_count one element each. vec: 1 where the mask
// and the lane are 16-byte aligned (route "vector").
extern "C" int pinot_masked_reduce(const void* mask, const void* lane, int elem, int width,
                                   int limit, int is_ids, int card_pad, int want_sum,
                                   long long padded, int vec, void* state, void* sums,
                                   void* out_min, void* out_max, void* out_count,
                                   void* stream) {
  return launch(mask, lane, elem, width, limit, is_ids, card_pad, want_sum, padded, 1, vec,
                state, sums, out_min, out_max, out_count, stream);
}

// mask uint8 [n_members][padded]; state int64 [n_members][5], zeroed;
// sums float64 [n_members][padded / 8192]; out_min / out_max / out_count
// [n_members] each.
extern "C" int pinot_masked_reduce_batched(const void* mask, const void* lane, int elem,
                                           int width, int limit, int is_ids, int card_pad,
                                           int want_sum, long long padded, int n_members,
                                           int vec, void* state, void* sums, void* out_min,
                                           void* out_max, void* out_count, void* stream) {
  return launch(mask, lane, elem, width, limit, is_ids, card_pad, want_sum, padded, n_members,
                vec, state, sums, out_min, out_max, out_count, stream);
}
