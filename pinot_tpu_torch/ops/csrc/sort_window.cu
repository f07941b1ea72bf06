// K12 radix_sort and K13 window_scan: the sort and the scans of the
// multi-stage plane's window functions, and the sort of a join's dim side.
//
// K12 replaces the lax.sort calls of pinot_tpu/ops/kernels.py: the
// window kernel's one sort of (invalid, part, orders..., iota) with its
// value lanes carried (build_window_kernel, :1584), and the on-device
// hash build of a raw-key join, the sort of the dim keys (_eval_pred kind
// join_raw, :127) and of the (key, code) pairs (_group_key kind jraw,
// :760). K13 replaces the rest of build_window_kernel (:1588-1600): the
// partition starts as a running max, the 1-based row numbers and the int32
// running sums rebased at each partition start.
//
// K12: a stable least-significant-digit radix sort of key lanes (int32 or
// int64, most significant lane first) over n rows, with int32 payload
// lanes carried. Every key is read with its sign bit flipped, so negative
// values (the window's DESC order keys are ~code) order before positive
// ones. The sort moves a permutation: each pass reads the digit of row
// perm[i] from its key lane, and the last step gathers the keys and
// payloads through the final permutation, which is also the window's
// `perm` (the sorted iota). Passes run from the least significant byte of
// the last key lane to the most significant byte of the first; rows at or
// past `valid_rows` then move behind all others in one more pass of a
// one-bit digit (the JAX kernel's `invalid` key). Stability supplies the
// iota tie-break of the JAX sort.
//
// One pass: a per-block histogram of 256 digits over a chunk of 4,096 rows
// (shared atomics: counts do not depend on order), one block scanning the
// counts digit-major, block-minor (so a block's rows of digit d land after
// every earlier block's), and a stable scatter. Stability inside a block:
// the block walks its chunk in tiles of 256 rows in order; inside a tile,
// __match_any_sync groups a warp's lanes by digit, a lane's rank is the
// number of its peers in lower lanes, and each warp's per-digit counts in
// shared memory give the rows of earlier warps. An atomicAdd on a bin
// counter would not be stable, and the window's answers would then differ
// from the numpy twin's np.lexsort.
//
// Skipped passes: a first launch ORs and ANDs every key lane's flipped
// bits; a pass whose byte is the same in every row is a permutation copy
// (its histogram and scan return at once). Window partition codes are
// below 2^16, their upper bytes never vary; a join's int32 keys below
// 2^24 skip the top byte.
//
// K13: one block of 1,024 threads; thread t owns a contiguous run of
// ceil(n / 1024) rows. The starts are a max-scan of (new ? i : 0) and the
// running sums a segmented scan (a start resets the sum), each as a scan
// of the threads' run aggregates, then one walk of the run. The sums are
// uint32: the JAX kernel takes a cumsum over the whole array in int32
// (cs - (cs[start] - v[start])), whose global prefix may pass 2^31 while
// every partition's sum fits (the host guard bounds each partition only).
// The difference is the same modulo 2^32 as the partition's own running
// sum, and unsigned wraparound is defined where signed overflow is not.
//
// What bounds them: n <= 65,536 rows (the window cap and the dim cap), so
// a lane is 256 KB and stays in the 50 MB L2; launch latency and the
// passes' synchronisation bound K12, not bytes (a pass reads the digit
// through the permutation, a gather). K13 is one block: its 4 B a row per
// lane would take a few µs at the memory rate, so it is latency, not
// bandwidth, that a bigger grid would buy back. Simple first: the
// speed of both is later work.

#include "common.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kChunk = 4096;          // rows of one block's histogram / scatter
constexpr int kTile = 256;            // rows the scatter block ranks at once
constexpr int kTileWarps = kTile / 32;
constexpr int kMaxKeys = 8;
constexpr int kMaxPayloads = 8;
constexpr int kScanThreads = 1024;
constexpr int kMaxScanLanes = 8;

struct KeyLanes {
  const void* ptr[kMaxKeys];
  int wide[kMaxKeys];                 // 1: int64, 0: int32
};

struct PayLanes {
  const int* in[kMaxPayloads];
  int* out[kMaxPayloads];
};

// a key's bits with the sign flipped: unsigned order == signed order
__device__ __forceinline__ unsigned long long key_bits(const KeyLanes& k, int lane,
                                                       long long row) {
  if (k.wide[lane])
    return static_cast<unsigned long long>(static_cast<const long long*>(k.ptr[lane])[row]) ^
           0x8000000000000000ULL;
  return static_cast<unsigned long long>(
      static_cast<unsigned>(static_cast<const int*>(k.ptr[lane])[row]) ^ 0x80000000u);
}

// OR and AND of every key lane's flipped bits: varying[2k] |= bits,
// varying[2k + 1] &= bits (initialised to 0 and to all ones)
__global__ void key_bits_kernel(KeyLanes keys, int n_keys, long long n,
                                unsigned long long* __restrict__ varying) {
  for (int k = 0; k < n_keys; ++k) {
    unsigned long long o = 0ULL, a = ~0ULL;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      const unsigned long long b = key_bits(keys, k, i);
      o |= b;
      a &= b;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      o |= __shfl_down_sync(0xffffffffu, o, off);
      a &= __shfl_down_sync(0xffffffffu, a, off);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(varying + 2 * k, o);
      atomicAnd(varying + 2 * k + 1, a);
    }
  }
}

// the digit of row perm[i] in this pass: byte `shift / 8` of key `lane`,
// or (lane < 0) the one-bit "at or past valid_rows" digit
__device__ __forceinline__ int digit_of(const KeyLanes& keys, int lane, int shift,
                                        long long valid_rows, int p) {
  if (lane < 0) return p >= valid_rows ? 1 : 0;
  return static_cast<int>((key_bits(keys, lane, p) >> shift) & 0xFFULL);
}

// false when every row has the same digit in this pass
__device__ __forceinline__ bool pass_varies(const unsigned long long* varying, int lane,
                                            int shift) {
  if (lane < 0) return true;
  return (((varying[2 * lane] ^ varying[2 * lane + 1]) >> shift) & 0xFFULL) != 0ULL;
}

__global__ void histogram_kernel(KeyLanes keys, int lane, int shift, long long valid_rows,
                                 const unsigned long long* __restrict__ varying,
                                 const int* __restrict__ perm, long long n,
                                 int* __restrict__ counts) {
  if (!pass_varies(varying, lane, shift)) return;
  __shared__ int hist[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(start + kChunk, n);
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(hist + digit_of(keys, lane, shift, valid_rows, perm[i]), 1);
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x)
    counts[static_cast<long long>(d) * gridDim.x + blockIdx.x] = hist[d];
}

// exclusive scan of counts [kRadix][n_blocks], digit-major: thread d sums
// its digit's blocks, the block scans the 256 totals, thread d writes its
// blocks' offsets
__global__ void scan_kernel(int lane, int shift, const unsigned long long* __restrict__ varying,
                            const int* __restrict__ counts, int n_blocks,
                            int* __restrict__ offsets) {
  if (!pass_varies(varying, lane, shift)) return;
  __shared__ int totals[kRadix];
  const int d = threadIdx.x;
  int total = 0;
  for (int b = 0; b < n_blocks; ++b) total += counts[d * n_blocks + b];
  totals[d] = total;
  __syncthreads();
  if (d == 0) {
    int run = 0;
    for (int i = 0; i < kRadix; ++i) {
      const int t = totals[i];
      totals[i] = run;
      run += t;
    }
  }
  __syncthreads();
  int run = totals[d];
  for (int b = 0; b < n_blocks; ++b) {
    offsets[d * n_blocks + b] = run;
    run += counts[d * n_blocks + b];
  }
}

__global__ void scatter_kernel(KeyLanes keys, int lane, int shift, long long valid_rows,
                               const unsigned long long* __restrict__ varying,
                               const int* __restrict__ perm_in, long long n,
                               const int* __restrict__ offsets, int* __restrict__ perm_out) {
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(start + kChunk, n);
  if (!pass_varies(varying, lane, shift)) {     // the same digit everywhere
    for (long long i = start + threadIdx.x; i < end; i += blockDim.x) perm_out[i] = perm_in[i];
    return;
  }
  __shared__ int base[kRadix];
  __shared__ int warp_hist[kTileWarps][kRadix];
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const unsigned lt = (1u << lane_id) - 1u;
  base[threadIdx.x] = offsets[static_cast<long long>(threadIdx.x) * gridDim.x + blockIdx.x];
  for (long long tile = start; tile < end; tile += kTile) {
    for (int w = 0; w < kTileWarps; ++w) warp_hist[w][threadIdx.x] = 0;
    __syncthreads();
    const long long i = tile + threadIdx.x;
    const bool live = i < end;
    const int p = live ? perm_in[i] : 0;
    const int d = live ? digit_of(keys, lane, shift, valid_rows, p) : kRadix;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (live && lane_id == __ffs(peers) - 1) warp_hist[warp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int pos = base[d] + __popc(peers & lt);
      for (int w = 0; w < warp; ++w) pos += warp_hist[w][d];
      perm_out[pos] = p;
    }
    __syncthreads();
    int add = 0;
    for (int w = 0; w < kTileWarps; ++w) add += warp_hist[w][threadIdx.x];
    base[threadIdx.x] += add;
    __syncthreads();
  }
}

__global__ void iota_kernel(int* __restrict__ perm, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    perm[i] = static_cast<int>(i);
}

struct KeyOuts {
  void* ptr[kMaxKeys];
};

__global__ void gather_keys_kernel(KeyLanes keys, int n_keys, KeyOuts outs, PayLanes pay,
                                   int n_pay, const int* __restrict__ perm, long long n,
                                   int* __restrict__ perm_out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = perm[i];
    perm_out[i] = p;
    for (int k = 0; k < n_keys; ++k) {
      if (keys.wide[k])
        static_cast<long long*>(outs.ptr[k])[i] = static_cast<const long long*>(keys.ptr[k])[p];
      else
        static_cast<int*>(outs.ptr[k])[i] = static_cast<const int*>(keys.ptr[k])[p];
    }
    for (int j = 0; j < n_pay; ++j) pay.out[j][i] = pay.in[j][p];
  }
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

// a run's segmented-sum aggregate: whether a partition starts in it, and
// its sum since its last start (or over all of it)
struct Seg {
  unsigned flag;
  unsigned sum;
};

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
  return Seg{a.flag | b.flag, b.flag ? b.sum : a.sum + b.sum};
}

// exclusive block scan of one Seg per thread (blockDim.x == 1024) under
// the associative `op`, with `identity`; `scratch` holds 32 values. Every
// thread calls it.
template <typename Op>
__device__ __forceinline__ Seg block_exclusive_scan(Seg v, Seg identity, Op op, Seg* scratch) {
  using T = Seg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T up;
    up.flag = __shfl_up_sync(0xffffffffu, inc.flag, off);
    up.sum = __shfl_up_sync(0xffffffffu, inc.sum, off);
    if (lane >= off) inc = op(up, inc);
  }
  __syncthreads();                    // scratch may still be read
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = scratch[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      T up;
      up.flag = __shfl_up_sync(0xffffffffu, w.flag, off);
      up.sum = __shfl_up_sync(0xffffffffu, w.sum, off);
      if (lane >= off) w = op(up, w);
    }
    scratch[lane] = w;                // inclusive over warps
  }
  __syncthreads();
  T exc;
  exc.flag = __shfl_up_sync(0xffffffffu, inc.flag, 1);
  exc.sum = __shfl_up_sync(0xffffffffu, inc.sum, 1);
  if (lane == 0) exc = identity;
  if (warp > 0) exc = lane == 0 ? scratch[warp - 1] : op(scratch[warp - 1], exc);
  return exc;
}

struct ScanLanes {
  const int* in[kMaxScanLanes];
  int* out[kMaxScanLanes];
};

__global__ void window_scan_kernel(const int* __restrict__ sp, ScanLanes lanes, int n_lanes,
                                   long long n, int* __restrict__ rn) {
  __shared__ Seg scratch[32];
  const long long per = (n + kScanThreads - 1) / kScanThreads;
  const long long lo = min(static_cast<long long>(threadIdx.x) * per, n);
  const long long hi = min(lo + per, n);
  auto is_new = [&](long long i) { return i == 0 || sp[i] != sp[i - 1]; };
  // the starts: the last start of this run (flag set), carried by a scan
  // whose operator keeps the later start (Seg.sum holds the row index)
  Seg agg{0u, 0u};
  for (long long i = lo; i < hi; ++i)
    if (is_new(i)) agg = Seg{1u, static_cast<unsigned>(i)};
  auto later = [](Seg a, Seg b) { return b.flag ? b : a; };
  Seg carry = block_exclusive_scan(agg, Seg{0u, 0u}, later, scratch);
  unsigned start = carry.sum;
  for (long long i = lo; i < hi; ++i) {
    if (is_new(i)) start = static_cast<unsigned>(i);
    rn[i] = static_cast<int>(static_cast<unsigned>(i) - start + 1u);
  }
  for (int j = 0; j < n_lanes; ++j) {
    const int* v = lanes.in[j];
    Seg run{0u, 0u};
    for (long long i = lo; i < hi; ++i) {
      if (is_new(i)) run = Seg{1u, 0u};
      run.sum += static_cast<unsigned>(v[i]);
    }
    const Seg in = block_exclusive_scan(run, Seg{0u, 0u}, seg_combine, scratch);
    unsigned s = in.sum;
    int* out = lanes.out[j];
    for (long long i = lo; i < hi; ++i) {
      if (is_new(i)) s = 0u;
      s += static_cast<unsigned>(v[i]);
      out[i] = static_cast<int>(s);
    }
  }
}

}  // namespace

// Words of int32 scratch pinot_radix_sort takes for n rows and n_keys key
// lanes: the OR / AND words of each key, two permutations, the counts and
// the offsets.
extern "C" long long pinot_radix_sort_scratch_words(long long n, int n_keys) {
  const long long blocks = (n + kChunk - 1) / kChunk;
  return 4LL * n_keys + 2 * n + 2LL * kRadix * blocks;
}

// keys: n_keys lanes of n rows, most significant first, elem pinot::kI32
// or kI64; payloads: n_pay int32 lanes. Rows at or past valid_rows sort
// after every other row. Writes perm_out int32 [n] (the sorted input row
// indices), key_outs (each in its key's type) and pay_outs. scratch:
// pinot_radix_sort_scratch_words int32 words, 8-byte aligned.
extern "C" int pinot_radix_sort(const void* const* key_ptrs, const int* key_elems, int n_keys,
                                const int* const* pay_ptrs, int n_pay, long long n,
                                long long valid_rows, void* const* key_outs,
                                int* const* pay_outs, int* perm_out, int* scratch,
                                void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || n_pay < 0 || n_pay > kMaxPayloads || n < 1 ||
      n > (1LL << 30) || reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeyLanes keys{};
  for (int k = 0; k < n_keys; ++k) {
    if (key_elems[k] != pinot::kI32 && key_elems[k] != pinot::kI64) return -1;
    keys.ptr[k] = key_ptrs[k];
    keys.wide[k] = key_elems[k] == pinot::kI64 ? 1 : 0;
  }
  const int blocks = static_cast<int>((n + kChunk - 1) / kChunk);
  unsigned long long* varying = reinterpret_cast<unsigned long long*>(scratch);
  int* pa = scratch + 4 * n_keys;
  int* pb = pa + n;
  int* counts = pb + n;
  int* offsets = counts + kRadix * blocks;
  for (int k = 0; k < n_keys; ++k) {
    cudaMemsetAsync(varying + 2 * k, 0, sizeof(unsigned long long), s);
    cudaMemsetAsync(varying + 2 * k + 1, 0xFF, sizeof(unsigned long long), s);
  }
  const int grid = pinot::grid_for(n);
  key_bits_kernel<<<grid, pinot::kThreads, 0, s>>>(keys, n_keys, n, varying);
  iota_kernel<<<grid, pinot::kThreads, 0, s>>>(pa, n);
  auto pass = [&](int lane, int shift) {
    histogram_kernel<<<blocks, kRadix, 0, s>>>(keys, lane, shift, valid_rows, varying, pa, n,
                                               counts);
    scan_kernel<<<1, kRadix, 0, s>>>(lane, shift, varying, counts, blocks, offsets);
    scatter_kernel<<<blocks, kTile, 0, s>>>(keys, lane, shift, valid_rows, varying, pa, n,
                                            offsets, pb);
    int* t = pa;
    pa = pb;
    pb = t;
  };
  for (int k = n_keys - 1; k >= 0; --k)
    for (int shift = 0; shift < (keys.wide[k] ? 64 : 32); shift += 8) pass(k, shift);
  if (valid_rows < n) pass(-1, 0);
  PayLanes pay{};
  for (int j = 0; j < n_pay; ++j) {
    pay.in[j] = pay_ptrs[j];
    pay.out[j] = pay_outs[j];
  }
  KeyOuts outs{};
  for (int k = 0; k < n_keys; ++k) outs.ptr[k] = key_outs[k];
  gather_keys_kernel<<<grid, pinot::kThreads, 0, s>>>(keys, n_keys, outs, pay, n_pay, pa, n,
                                                      perm_out);
  return static_cast<int>(cudaGetLastError());
}

// sp: the sorted partition lane, int32 [n]; values: n_vals int32 lanes in
// the same order. Writes rn int32 [n] (1-based row number within the
// partition) and outs (each lane's running sum within its partition, in
// int32 with wraparound).
extern "C" int pinot_window_scan(const int* sp, const int* const* values, int n_vals,
                                 long long n, int* rn, int* const* outs, void* stream) {
  if (n < 1 || n > (1LL << 30) || n_vals < 0 || n_vals > kMaxScanLanes) return -1;
  ScanLanes lanes{};
  for (int j = 0; j < n_vals; ++j) {
    lanes.in[j] = values[j];
    lanes.out[j] = outs[j];
  }
  window_scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(sp, lanes,
                                                                                n_vals, n, rn);
  return static_cast<int>(cudaGetLastError());
}
