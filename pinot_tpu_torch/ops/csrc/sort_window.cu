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
// the last key lane to the most significant byte of the first, skipping a
// byte that has one value in every row (window partition codes are below
// 2^16, a join's int32 keys below 2^24); rows at or past `valid_rows` then
// move behind all others in one more pass of a one-bit digit (the JAX
// kernel's `invalid` key). Stability supplies the iota tie-break of the
// JAX sort. What bounds K12 is the chain of dependent passes, not bytes: at
// most 65,536 rows on every path that sorts in a query (the window cap, the
// dim cap, K14's slots of one segment), 256 KB a lane, all in L2.
//
// Two routes, chosen by the caller (ops/kernels.py:radix_sort):
// - "cluster", n <= 65,536: the whole sort in one launch of one
//   thread-block cluster of up to 8 CTAs (cluster_sort.cuh), the final
//   gather of the permutation, keys and payloads in the same launch; no
//   global scratch, no memset.
// - "passes", any n up to 2^30 (a stack of S segments' K16 slots can pass
//   65,536): one launch ORs and ANDs every key lane, then each pass is a
//   per-block histogram of 256 digits over a chunk of 4,096 rows (shared
//   atomics: counts do not depend on order), one block scanning the counts
//   digit-major, block-minor (a block's rows of digit d land after every
//   earlier block's), and a stable scatter; a pass whose byte does not
//   vary is a permutation copy. Stability inside a scatter block: the block
//   walks its chunk in tiles of 256 rows in order; inside a tile,
//   __match_any_sync groups a warp's lanes by digit, a lane's rank is the
//   number of its peers in lower lanes, and each warp's per-digit counts in
//   shared memory give the rows of earlier warps. An atomicAdd on a bin
//   counter would not be stable, and the window's answers would then differ
//   from the numpy twin's np.lexsort.
//
// K13: a single-pass scan over tiles of 2,048 rows with decoupled
// look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016), one block of 256 threads a tile, every
// quantity of the launch in one pass. The quantities are the row numbers
// (a segmented count: 1 a row, reset at each partition start, which is
// i - start(i) + 1) and up to 8 value lanes' running sums, all under the
// segmented operator Seg / seg_combine. A thread loads 8 consecutive rows
// of each lane as two 16-byte vectors, works out its rows' start flags once
// (sp[i] != sp[i - 1]; the first row of a warp takes sp[i - 1] from its
// neighbour lane or, at lane 0, from memory), reduces its rows, and the
// block scans the 256 thread aggregates with warp shuffles. The tile then
// publishes its aggregate, one 64-bit descriptor a quantity: bits 0-31
// the value, bit 32 "a partition starts in this tile", bits 33-34 the
// status (empty, aggregate, inclusive), so a reader never sees a status and
// a value from different writes. A tile whose aggregate holds a start, and
// tile 0, publish it as inclusive at once: the operator resets there, so
// nothing before them changes their prefix. One warp a quantity then looks
// back 32 predecessors at a time, waits (with __nanosleep) until those up
// to the nearest one that is inclusive or holds a start have published,
// folds them in order, and publishes the tile's inclusive prefix.
// Descriptors are stored with st.release and read with ld.acquire at
// device scope. Tile ids come from an atomic counter, not blockIdx, so a
// tile only waits on tiles whose blocks already run. The wrapper zeroes the descriptors and the
// counters (one memset launch, a few KB at W1's size): an epoch tag in the
// status bits would need scratch that outlives a call, which the server's
// concurrent workers would share. More than 8 value lanes run as further
// launches of up to 9 lanes inside the same C call, the row numbers in the
// first only. The sums are uint32: the JAX kernel takes a cumsum over the
// whole array in int32 (cs - (cs[start] - v[start])), whose global prefix
// may pass 2^31 while every partition's sum fits (the host guard bounds
// each partition only). The difference is the same modulo 2^32 as the
// partition's own running sum, and unsigned wraparound is defined where
// signed overflow is not.
//
// What bounds K13: it reads each input once and writes each output once
// with 16-byte accesses: at W1's 32 tiles it is bound by launch latency and
// one tile's look-back, at 2^24 rows by bytes.

#include "cluster_sort.cuh"
#include "common.cuh"

namespace {

constexpr int kRadix = 256;
constexpr int kChunk = 4096;          // rows of one block's histogram / scatter
constexpr int kTile = 256;            // rows the scatter block ranks at once
constexpr int kTileWarps = kTile / 32;
constexpr int kMaxKeys = 8;
constexpr int kMaxPayloads = 8;
constexpr int kScanThreads = 256;     // K13: threads of a tile's block
constexpr int kScanItems = 8;         // consecutive rows a thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxScanQ = 9;          // quantities a launch: rn and 8 lanes

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

// K12's key lanes as cluster_sort reads them (the descriptors in shared
// memory: indexing the parameter struct by a lane number would copy it to
// local memory in every thread)
struct LaneKeys {
  const KeyLanes* k;
  int n;
  __device__ __forceinline__ int lanes() const { return n; }
  __device__ __forceinline__ bool wide(int l) const { return k->wide[l] != 0; }
  __device__ __forceinline__ unsigned long long bits(int l, unsigned row) const {
    return key_bits(*k, l, row);
  }
};

// The cluster route: one cluster sorts all n <= 65,536 rows, then each
// CTA writes its positions' permutation entries, keys and payloads.
__global__ void __launch_bounds__(pinot::kSortThreads, 1)
    radix_cluster_kernel(KeyLanes keys_p, int n_keys, PayLanes pay_p, int n_pay, KeyOuts outs_p,
                         int n, int valid_rows, int* __restrict__ perm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  pinot::SortSmem& sm = *reinterpret_cast<pinot::SortSmem*>(smem);
  __shared__ KeyLanes keys;
  __shared__ PayLanes pay;
  __shared__ KeyOuts outs;
  if (threadIdx.x == 0) {
    keys = keys_p;
    pay = pay_p;
    outs = outs_p;
  }
  __syncthreads();
  const pinot::SortRange r = pinot::cluster_sort(sm, LaneKeys{&keys, n_keys}, n, valid_rows);
  // a thread's 8 positions at once, so each lane's 8 gathers are in flight
  // together; packed keys are rebuilt from shared memory, not gathered
  unsigned p[pinot::kSortItems];
#pragma unroll
  for (int s = 0; s < pinot::kSortItems; ++s) {
    const int i = r.lo + threadIdx.x + s * pinot::kSortThreads;
    p[s] = i < r.hi ? r.row(i) : 0u;
    if (i < r.hi) perm_out[i] = static_cast<int>(p[s]);
  }
  for (int k = 0; k < n_keys; ++k) {
#pragma unroll
    for (int s = 0; s < pinot::kSortItems; ++s) {
      const int i = r.lo + threadIdx.x + s * pinot::kSortThreads;
      if (i >= r.hi) continue;
      if (keys.wide[k])
        static_cast<long long*>(outs.ptr[k])[i] =
            r.packed ? static_cast<long long>(r.bits(k, i) ^ 0x8000000000000000ULL)
                     : __ldg(static_cast<const long long*>(keys.ptr[k]) + p[s]);
      else
        static_cast<int*>(outs.ptr[k])[i] =
            r.packed ? static_cast<int>(static_cast<unsigned>(r.bits(k, i)) ^ 0x80000000u)
                     : __ldg(static_cast<const int*>(keys.ptr[k]) + p[s]);
    }
  }
  for (int j = 0; j < n_pay; ++j) {
#pragma unroll
    for (int s = 0; s < pinot::kSortItems; ++s) {
      const int i = r.lo + threadIdx.x + s * pinot::kSortThreads;
      if (i < r.hi) pay.out[j][i] = __ldg(pay.in[j] + p[s]);
    }
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

__device__ __forceinline__ Seg shfl_up_seg(Seg v, int off) {
  return Seg{__shfl_up_sync(0xffffffffu, v.flag, off), __shfl_up_sync(0xffffffffu, v.sum, off)};
}

__device__ __forceinline__ Seg shfl_down_seg(Seg v, int off) {
  return Seg{__shfl_down_sync(0xffffffffu, v.flag, off),
             __shfl_down_sync(0xffffffffu, v.sum, off)};
}

// the quantities of one launch: in[q] == nullptr is the row numbers (1 a row)
struct ScanQ {
  const int* in[kMaxScanQ];
  int* out[kMaxScanQ];
};

// a descriptor: value in bits 0-31, start flag in bit 32, status above
constexpr int kStatusShift = 33;
constexpr unsigned long long kEmpty = 0ULL, kAggregate = 1ULL, kInclusive = 2ULL;

__device__ __forceinline__ unsigned long long pack_desc(Seg s, unsigned long long status) {
  return (status << kStatusShift) | (static_cast<unsigned long long>(s.flag & 1u) << 32) | s.sum;
}

__device__ __forceinline__ Seg unpack_desc(unsigned long long w) {
  return Seg{static_cast<unsigned>(w >> 32) & 1u, static_cast<unsigned>(w)};
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// rows [row, row + 8) of p, 0 past n: two 16-byte loads where all 8 lie
// inside and the lanes are 16-byte aligned (row is a multiple of 8)
__device__ __forceinline__ void load_items(const int* __restrict__ p, long long row, long long n,
                                           bool vec, unsigned (&x)[kScanItems]) {
  if (vec && row + kScanItems <= n) {
    const int4 a = *reinterpret_cast<const int4*>(p + row);
    const int4 b = *reinterpret_cast<const int4*>(p + row + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      x[k] = row + k < n ? static_cast<unsigned>(p[row + k]) : 0u;
  }
}

__device__ __forceinline__ void store_items(int* __restrict__ p, long long row, long long n,
                                            bool vec, const unsigned (&x)[kScanItems]) {
  if (vec && row + kScanItems <= n) {
    *reinterpret_cast<int4*>(p + row) = make_int4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<int4*>(p + row + 4) = make_int4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (row + k < n) p[row + k] = static_cast<int>(x[k]);
  }
}

// The exclusive prefix of tile `tile` for one quantity: the fold, oldest
// first, of its predecessors' descriptors back to the nearest that is
// inclusive or holds a start. Every lane of the warp calls it; lane 0's
// result is the prefix.
__device__ __forceinline__ Seg look_back(const unsigned long long* desc, long long tile, int nq,
                                         int q) {
  const int lane = threadIdx.x & 31;
  Seg run{0u, 0u};                    // the fold of the tiles after `pred`
  for (long long pred = tile - 1;; pred -= 32) {
    const long long t = pred - lane;
    const unsigned long long* at = desc + (t >= 0 ? t * nq + q : 0);
    unsigned long long w = t >= 0 ? load_acquire(at) : (kInclusive << kStatusShift);
    // wait until every lane up to the nearest stop has published
    unsigned stops;
    for (int spins = 0;; ++spins) {
      const unsigned long long status = w >> kStatusShift;
      const unsigned empty = __ballot_sync(0xffffffffu, status == kEmpty);
      stops = __ballot_sync(0xffffffffu,
                            status == kInclusive || (status == kAggregate && ((w >> 32) & 1ULL)));
      if (!empty || (stops && __ffs(stops) < __ffs(empty))) break;
      __nanosleep(spins < 4 ? 32 << spins : 512);
      if (status == kEmpty) w = load_acquire(at);
    }
    const int first = stops ? __ffs(stops) - 1 : 32;   // nearest stopping lane
    Seg x = lane <= first ? unpack_desc(w) : Seg{0u, 0u};
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Seg older = shfl_down_seg(x, off);
      if (lane + off < 32) x = seg_combine(older, x);
    }
    run = seg_combine(x, run);        // lane 0's x: the window, oldest first
    if (stops) return run;
  }
}

template <int NQ>
__global__ void __launch_bounds__(kScanThreads)
    window_scan_kernel(const int* __restrict__ sp, ScanQ q, long long n, int vec,
                       unsigned long long* __restrict__ desc, unsigned* __restrict__ next_tile) {
  __shared__ unsigned tile_id;
  __shared__ Seg warp_total[kScanWarps][NQ];
  __shared__ Seg tile_prefix[NQ];
  if (threadIdx.x == 0) tile_id = atomicAdd(next_tile, 1u);
  __syncthreads();
  const long long tile = tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = tile * kScanTile + static_cast<long long>(threadIdx.x) * kScanItems;

  // the start flags of this thread's rows, bit k for row0 + k
  unsigned s[kScanItems];
  load_items(sp, row0, n, vec, s);
  unsigned prev = __shfl_up_sync(0xffffffffu, s[kScanItems - 1], 1);
  if (lane == 0 && row0 > 0 && row0 < n) prev = static_cast<unsigned>(sp[row0 - 1]);
  unsigned flags = 0u;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const long long i = row0 + k;
    const unsigned before = k ? s[k - 1] : prev;
    if (i < n && (i == 0 || s[k] != before)) flags |= 1u << k;
  }

  // each quantity's values and this thread's aggregate, then the warp scan
  unsigned v[NQ][kScanItems];
  Seg inc[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (q.in[j]) {
      load_items(q.in[j], row0, n, vec, v[j]);
    } else {
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) v[j][k] = 1u;
    }
    Seg a{0u, 0u};
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      a = (flags >> k) & 1u ? Seg{1u, v[j][k]} : Seg{a.flag, a.sum + v[j][k]};
    Seg x = a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Seg up = shfl_up_seg(x, off);
      if (lane >= off) x = seg_combine(up, x);
    }
    if (lane == 31) warp_total[warp][j] = x;
    // this thread's exclusive prefix inside its warp
    const Seg left = shfl_up_seg(x, 1);
    inc[j] = lane ? left : Seg{0u, 0u};
  }
  __syncthreads();

  // the tile's aggregates; thread j publishes quantity j's
  Seg thread_prefix[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    Seg before{0u, 0u}, all{0u, 0u};
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      if (w == warp) before = all;
      all = seg_combine(all, warp_total[w][j]);
    }
    thread_prefix[j] = seg_combine(before, inc[j]);
    if (threadIdx.x == j)
      store_release(desc + tile * NQ + j,
                    pack_desc(all, tile == 0 || all.flag ? kInclusive : kAggregate));
  }

  // the look-back, warp w for quantities w, w + 8
  for (int j = warp; j < NQ; j += kScanWarps) {
    Seg all{0u, 0u};
    for (int w = 0; w < kScanWarps; ++w) all = seg_combine(all, warp_total[w][j]);
    Seg pre{0u, 0u};
    if (tile > 0) {
      pre = look_back(desc, tile, NQ, j);
      if (lane == 0 && !all.flag)
        store_release(desc + tile * NQ + j, pack_desc(seg_combine(pre, all), kInclusive));
    }
    if (lane == 0) tile_prefix[j] = pre;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    Seg run = seg_combine(tile_prefix[j], thread_prefix[j]);
    unsigned out[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      run = (flags >> k) & 1u ? Seg{1u, v[j][k]} : Seg{run.flag, run.sum + v[j][k]};
      out[k] = run.sum;
    }
    store_items(q.out[j], row0, n, vec, out);
  }
}

template <int NQ>
void launch_scan(const int* sp, const ScanQ& q, long long n, int vec, unsigned long long* desc,
                 unsigned* next_tile, int tiles, cudaStream_t s) {
  window_scan_kernel<NQ><<<tiles, kScanThreads, 0, s>>>(sp, q, n, vec, desc, next_tile);
}

}  // namespace

// Words of int32 scratch pinot_radix_sort's "passes" route takes for n
// rows and n_keys key lanes: the OR / AND words of each key, two
// permutations, the counts and the offsets. The "cluster" route takes
// none.
extern "C" long long pinot_radix_sort_scratch_words(long long n, int n_keys) {
  const long long blocks = (n + kChunk - 1) / kChunk;
  return 4LL * n_keys + 2 * n + 2LL * kRadix * blocks;
}

// The most rows the "cluster" route sorts.
extern "C" long long pinot_radix_sort_cluster_rows() { return pinot::kSortMaxRows; }

// keys: n_keys lanes of n rows, most significant first, elem pinot::kI32
// or kI64; payloads: n_pay int32 lanes. Rows at or past valid_rows sort
// after every other row. Writes perm_out int32 [n] (the sorted input row
// indices), key_outs (each in its key's type) and pay_outs. route 1
// ("cluster", n <= pinot_radix_sort_cluster_rows()): one launch, scratch
// unused; route 0 ("passes"): scratch holds
// pinot_radix_sort_scratch_words int32 words, 8-byte aligned.
extern "C" int pinot_radix_sort(const void* const* key_ptrs, const int* key_elems, int n_keys,
                                const int* const* pay_ptrs, int n_pay, long long n,
                                long long valid_rows, void* const* key_outs,
                                int* const* pay_outs, int* perm_out, int* scratch, int route,
                                void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || n_pay < 0 || n_pay > kMaxPayloads || n < 1 ||
      n > (1LL << 30) || (route != 0 && route != 1) ||
      (route == 1 && n > pinot::kSortMaxRows) ||
      (route == 0 && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 8 != 0)))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeyLanes keys{};
  for (int k = 0; k < n_keys; ++k) {
    if (key_elems[k] != pinot::kI32 && key_elems[k] != pinot::kI64) return -1;
    keys.ptr[k] = key_ptrs[k];
    keys.wide[k] = key_elems[k] == pinot::kI64 ? 1 : 0;
  }
  PayLanes pay{};
  for (int j = 0; j < n_pay; ++j) {
    pay.in[j] = pay_ptrs[j];
    pay.out[j] = pay_outs[j];
  }
  KeyOuts outs{};
  for (int k = 0; k < n_keys; ++k) outs.ptr[k] = key_outs[k];
  if (route == 1) {
    const int valid = static_cast<int>(valid_rows < 0 ? 0 : valid_rows < n ? valid_rows : n);
    const size_t smem = sizeof(pinot::SortSmem);
    cudaError_t rc = cudaFuncSetAttribute(
        radix_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const int ctas = pinot::sort_ctas(n);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(pinot::kSortThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, radix_cluster_kernel, keys, n_keys, pay, n_pay, outs,
                            static_cast<int>(n), valid, perm_out);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
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
  gather_keys_kernel<<<grid, pinot::kThreads, 0, s>>>(keys, n_keys, outs, pay, n_pay, pa, n,
                                                      perm_out);
  return static_cast<int>(cudaGetLastError());
}

// Words (64-bit) of zeroed scratch pinot_window_scan takes for n rows and
// n_vals value lanes: per launch of up to 9 quantities, a tile counter and
// a descriptor a tile and quantity.
extern "C" long long pinot_window_scan_scratch_words(long long n, int n_vals) {
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  long long words = 0;
  for (int lo = 0; lo < n_vals + 1; lo += kMaxScanQ) {
    const int nq = n_vals + 1 - lo < kMaxScanQ ? n_vals + 1 - lo : kMaxScanQ;
    words += 1 + tiles * nq;
  }
  return words;
}

// sp: the sorted partition lane, int32 [n]; values: n_vals int32 lanes in
// the same order. Writes rn int32 [n] (1-based row number within the
// partition) and outs (each lane's running sum within its partition, in
// int32 with wraparound). scratch: pinot_window_scan_scratch_words 64-bit
// words, all zero.
extern "C" int pinot_window_scan(const int* sp, const int* const* values, int n_vals,
                                 long long n, int* rn, int* const* outs,
                                 unsigned long long* scratch, void* stream) {
  if (n < 1 || n > (1LL << 30) || n_vals < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kScanTile - 1) / kScanTile;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool vec = aligned(sp) && aligned(rn);
  for (int j = 0; j < n_vals; ++j) vec = vec && aligned(values[j]) && aligned(outs[j]);
  unsigned long long* at = scratch;
  for (int lo = 0; lo < n_vals + 1; lo += kMaxScanQ) {
    const int nq = n_vals + 1 - lo < kMaxScanQ ? n_vals + 1 - lo : kMaxScanQ;
    ScanQ q{};
    for (int j = 0; j < nq; ++j) {
      const int g = lo + j;           // 0: the row numbers, g: value lane g - 1
      q.in[j] = g ? values[g - 1] : nullptr;
      q.out[j] = g ? outs[g - 1] : rn;
    }
    unsigned* next_tile = reinterpret_cast<unsigned*>(at);
    unsigned long long* desc = at + 1;
    const int t = static_cast<int>(tiles), v = vec ? 1 : 0;
    switch (nq) {
      case 1: launch_scan<1>(sp, q, n, v, desc, next_tile, t, s); break;
      case 2: launch_scan<2>(sp, q, n, v, desc, next_tile, t, s); break;
      case 3: launch_scan<3>(sp, q, n, v, desc, next_tile, t, s); break;
      case 4: launch_scan<4>(sp, q, n, v, desc, next_tile, t, s); break;
      case 5: launch_scan<5>(sp, q, n, v, desc, next_tile, t, s); break;
      case 6: launch_scan<6>(sp, q, n, v, desc, next_tile, t, s); break;
      case 7: launch_scan<7>(sp, q, n, v, desc, next_tile, t, s); break;
      case 8: launch_scan<8>(sp, q, n, v, desc, next_tile, t, s); break;
      default: launch_scan<9>(sp, q, n, v, desc, next_tile, t, s); break;
    }
    at += 1 + tiles * nq;
  }
  return static_cast<int>(cudaGetLastError());
}
