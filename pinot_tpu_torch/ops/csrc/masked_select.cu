// K6 masked_select: one segment's selection (SELECT ... [ORDER BY ...]
// LIMIT k): the k first matched rows by (key words..., docid), the match
// count, and the selected columns gathered at those rows.
//
// Replaces pinot_tpu/ops/kernels.py:_selection_outputs (:1479) with
// _monotone_int32_keys (:1448), kinds "limit" (jnp.nonzero, size k),
// "order" (dictIds packed mixed-radix into one int32, lax.top_k),
// "ordertk" (one raw int32 / float32 lane through the monotone map,
// clamped below INT32_MAX, lax.top_k) and "ordermk" (per-column int32 key
// lanes, lax.sort with an iota key). All four are one total order here:
// ascending (w_0, ..., w_{n-1}, docid) over the matched rows, where the
// w are the int32 words the JAX function builds for the kind (none for
// "limit"). lax.top_k breaks ties toward the lower index and the iota key
// makes lax.sort do the same, so the docid word reproduces both. Outputs:
// docids int32 [k], -1 after the valid rows; the match count; each gather
// lane (dictIds, raw values or MV id rows, any element width) at
// max(docid, 0), as the JAX function gathers at `safe`, or zeros after
// the valid rows for a gather the caller flags (`zero_invalid`).
//
// The "vector" kind (replaces the vector branch of _selection_outputs,
// :1482-1503) is the "ordertk" order over K8's f32 score lane, descending:
// the word ~monotone(score) clamped below INT32_MAX is
// ~max(monotone(score), -INT32_MAX), the JAX key, reversed; the scores
// ride as a flagged gather (0 after the valid rows, as JAX writes them).
//
// What bounds it: bytes. One mask byte per row, the key lanes of the
// matched rows, the k docids and gathered rows written; k <= 65,536 rows
// of output are small next to the 2.5M-row scan.
//
// Two routes, chosen by the caller (ops/kernels.py:_masked_select) from
// the key word count.
//
// "select", at most one key word ("order", "ordertk", the vector kind, a
// one-word "ordermk", and "limit" with none): the selected set is the
// first k matched rows by (word, docid), and since the docid is unique it
// is exact to pick it before sorting anything (after AIR top-k: Zhang et
// al., "Parallel Top-K Algorithms on GPU", SC'23). Per segment:
// 1. Threshold by radix select on the word, in up to three passes of 11,
//    11 and 10 bits. Blocks of 256 threads take 4,096-row tiles, a thread
//    16 consecutive rows (one 16-byte mask load); a block histograms the
//    digit of the matched rows still in the chosen bucket in shared memory
//    (a warp's lanes grouped by digit, one add a group) and adds it to the
//    segment's histogram in device memory. The last block to finish (an
//    atomic ticket) finds the bucket that holds the k-th row and writes the
//    prefix, the rows still wanted and `below` (matched rows of a smaller
//    word) for the next pass, then zeroes the histogram and the ticket, so
//    no scan launch runs and the host never waits. The selection ends as
//    "word < lt_bound, plus the first need_eq rows by docid whose word is
//    T": every matched row when the match count is <= k; a whole bucket
//    when the k-th row closes it (later passes return at once); else T,
//    the k-th smallest word, after the third pass. "limit" has no word:
//    the first min(k, matched) matched rows by docid.
// 2. Compaction. A count pass writes each tile's rows of word T (only when
//    ties straddle the k-th row, which dictionary "order" keys often do)
//    and its last block turns them into an exclusive prefix over the
//    tiles; a write pass puts the rows below lt_bound anywhere in the
//    first `below` candidate slots (a warp-aggregated atomic) and the tied
//    rows at below + their rank by docid (the tile's prefix plus a block
//    scan of the threads' counts), keeping those under need_eq.
// 3. One sort launch: above k = 256 the <= k candidates by (word, docid)
//    in one cluster of up to 8 CTAs a segment (cluster_sort.cuh, K12's
//    sort); up to 256 by counting ranks in one block of 256 threads (the
//    cluster's 200 KB of shared memory a CTA cost 2-3 µs more a launch);
//    "limit" is in docid order already. The same launch writes the docids
//    (-1 after the selected rows) and every gather column.
// Six launches and one memset at any row count (four and one for
// "limit"); the passes after the first mostly hit the L2.
//
// "tile", two or more key words ("ordermk" over several columns or an
// 8-byte lane): a word-wise threshold would need a pass per word, so this
// route keeps the first design:
// 1. Tile pass, one block per `tile` rows (4096, or fewer when the keys
//    are wide, so a tile's keys take at most 64 KB of shared memory). Each
//    warp compacts its matched rows into shared memory (ballot, one shared
//    atomic per warp), each row as its key words (order-preserving
//    unsigned: int32 ^ 0x80000000) and its docid. The block bitonic-sorts
//    only the next power of two above its match count, and writes its
//    first min(k, tile) entries, padded with an all-ones sentinel that
//    sorts after every row (a docid never reaches 2^32 - 1).
// 2. Merge passes: lists of equal length merge in pairs, each keeping its
//    first min(k, 2 * len) entries, until one list is left. Each thread
//    finds its own output element by a binary search over the two inputs
//    (the co-rank), so no merge needs shared memory, at any k.
// 3. Finish: the docids (sentinel -> -1) and every gather column.
//
// Stacked segments (the counterpart of the vmap in
// pinot_tpu/parallel/sharded.py:get_sharded_kernel, whose selection
// outputs are all-gathered per segment): the lanes hold n_segs segments
// of seg_rows rows each, back to back; every launch has a segment axis
// (grid y), docids count from each segment's first row, and the outputs
// are [n_segs][k] per-segment top-k (the host merges them). One segment
// is n_segs = 1.
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672) take the
// same segment axis: member b's mask row is segment b, and each key or
// gather lane has its own stride between segments, seg_rows for a stack,
// 0 for a lane the members share (the segment's columns), padded for a
// lane that is the member's own (K8's scores of the vector kind). Ties go
// to the lower docid per member, as in the single launch.
// Every launch runs on the caller's stream; the host function returns the
// first non-zero cudaGetLastError. The tile size and the scratch size are
// decided here only: the wrapper asks pinot_masked_select_scratch_words
// how many int32 words of scratch to allocate.

#include "cluster_sort.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxTerms = 8;
constexpr int kMaxWords = 8;
constexpr int kMaxGathers = 32;
constexpr int kTileThreads = 1024;
constexpr uint32_t kSentinel = 0xffffffffu;
constexpr int kTileRows = 4096;          // rows per tile, at most
constexpr int kTileBytes = 64 << 10;     // a tile's keys in shared memory

// key-term modes (ops/kernels.py: _PACK, _ID, _MONO, _MONO_CLAMP)
enum Mode : int { kPack = 0, kId = 1, kMono = 2, kMonoClamp = 3 };

struct Terms {
  const void* lane[kMaxTerms];
  long long stride[kMaxTerms];   // rows between one segment's lane and the next
  int elem[kMaxTerms];
  int mode[kMaxTerms];
  int card_pad[kMaxTerms];
  int asc[kMaxTerms];
};

struct Gathers {
  const unsigned char* lane[kMaxGathers];
  long long stride[kMaxGathers];
  unsigned char* out[kMaxGathers];
  int row_bytes[kMaxGathers];
  unsigned zero_invalid;     // bit g: gather g writes zeros after the valid rows
};

// Document doc of segment seg: its key words as the JAX function computes
// them, most significant first, mapped to unsigned order.
__device__ __forceinline__ void key_words(const Terms& t, int n_terms, long long seg,
                                          long long doc, uint32_t* out) {
  int32_t w[kMaxWords];
  int n = 0;
  for (int i = 0; i < n_terms; ++i) {
    const int mode = t.mode[i];
    const long long row = seg * t.stride[i] + doc;
    if (mode == kPack) {
      // key = key * card_pad + (asc ? id : card_pad - 1 - id), int32 wrap
      const int id = pinot::read_id(t.lane[i], t.elem[i], row);
      const int term = t.asc[i] ? id : t.card_pad[i] - 1 - id;
      const uint32_t prev = n ? static_cast<uint32_t>(w[0]) : 0u;
      w[0] = static_cast<int32_t>(prev * static_cast<uint32_t>(t.card_pad[i]) +
                                  static_cast<uint32_t>(term));
      n = 1;
    } else if (mode == kId) {
      const int id = pinot::read_id(t.lane[i], t.elem[i], row);
      w[n++] = t.asc[i] ? id : ~id;
    } else {
      int32_t m[2];
      const int nm = pinot::monotone_words(t.lane[i], t.elem[i], row, m);
      for (int j = 0; j < nm; ++j) w[n++] = t.asc[i] ? m[j] : ~m[j];
      // INT32_MAX is the JAX masked-row sentinel: valid keys stop below
      if (mode == kMonoClamp && w[n - 1] > 0x7ffffffe) w[n - 1] = 0x7ffffffe;
    }
  }
  for (int j = 0; j < n; ++j) out[j] = static_cast<uint32_t>(w[j]) ^ 0x80000000u;
}

// Entries i and j of the word-major shared tile: is i < j?
__device__ __forceinline__ bool tile_less(const uint32_t* keys, int tile, int width, int i,
                                          int j) {
  for (int w = 0; w < width; ++w) {
    const uint32_t a = keys[w * tile + i], b = keys[w * tile + j];
    if (a != b) return a < b;
  }
  return false;
}

__global__ void __launch_bounds__(kTileThreads)
    select_tile_kernel(const uint8_t* __restrict__ mask, Terms terms_p, int n_terms,
                       int n_words, long long seg_rows, int tile, int keep,
                       uint32_t* __restrict__ lists, int* __restrict__ count) {
  extern __shared__ uint32_t keys[];  // [width][tile], word-major
  // the term descriptors in shared memory: indexing the parameter struct
  // by a loop counter makes every thread copy it to local memory
  __shared__ Terms terms;
  __shared__ int n_matched;
  const int width = n_words + 1;
  if (threadIdx.x == 0) {
    terms = terms_p;
    n_matched = 0;
  }
  __syncthreads();
  const long long seg_lo = static_cast<long long>(blockIdx.y) * seg_rows;
  const long long base = static_cast<long long>(blockIdx.x) * tile;  // in the segment
  const int lane = threadIdx.x & 31;
  // tile is a multiple of blockDim.x: every warp runs every iteration
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long doc = base + i;
    const long long row = seg_lo + doc;
    const bool hit = doc < seg_rows && mask[row] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    int first = 0;
    if (lane == 0 && ballot) first = atomicAdd(&n_matched, __popc(ballot));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (hit) {
      const int pos = first + __popc(ballot & ((1u << lane) - 1u));
      uint32_t w[kMaxWords];
      key_words(terms, n_terms, blockIdx.y, doc, w);
      for (int j = 0; j < n_words; ++j) keys[j * tile + pos] = w[j];
      keys[n_words * tile + pos] = static_cast<uint32_t>(doc);
    }
  }
  __syncthreads();
  const int c = n_matched;
  if (threadIdx.x == 0 && c) atomicAdd(count + blockIdx.y, c);
  int size = c ? 1 : 0;  // sort the matched rows only, padded to a power of 2
  while (size < c) size <<= 1;
  for (int i = c + threadIdx.x; i < size; i += blockDim.x)
    for (int w = 0; w < width; ++w) keys[w * tile + i] = kSentinel;
  for (int span = 2; span <= size; span <<= 1) {
    for (int stride = span >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < (size >> 1); t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & span) == 0;
        if (tile_less(keys, tile, width, hi, lo) == up) {
          for (int w = 0; w < width; ++w) {
            const uint32_t x = keys[w * tile + lo];
            keys[w * tile + lo] = keys[w * tile + hi];
            keys[w * tile + hi] = x;
          }
        }
      }
    }
  }
  __syncthreads();
  uint32_t* dst = lists + (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) *
                              keep * width;
  for (int i = threadIdx.x; i < keep; i += blockDim.x)
    for (int w = 0; w < width; ++w)
      dst[static_cast<long long>(i) * width + w] = i < c ? keys[w * tile + i] : kSentinel;
}

// Entry-major lists: is a <= b?
__device__ __forceinline__ bool entry_le(const uint32_t* a, const uint32_t* b, int width) {
  for (int w = 0; w < width; ++w)
    if (a[w] != b[w]) return a[w] < b[w];
  return true;
}

// Each segment's lists 2p and 2p+1 (len_in entries each; the last list of
// an odd count merges with nothing) -> its list p, the first len_out
// entries. n_lists lists per segment, segment-major.
__global__ void select_merge_kernel(const uint32_t* __restrict__ in, int n_segs, int n_lists,
                                    int len_in, int len_out, int width,
                                    uint32_t* __restrict__ out) {
  const long long half = (n_lists + 1) / 2;
  const long long total = n_segs * half * len_out;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += step) {
    const long long seg = g / (half * len_out);
    const int p = static_cast<int>(g / len_out % half);
    const int i = static_cast<int>(g % len_out);
    const uint32_t* A = in + (seg * n_lists + 2 * p) * len_in * width;
    const uint32_t* B = A + static_cast<long long>(len_in) * width;
    const int len_a = len_in, len_b = 2 * p + 1 < n_lists ? len_in : 0;
    uint32_t* dst = out + g * width;
    if (i >= len_a + len_b) {
      for (int w = 0; w < width; ++w) dst[w] = kSentinel;
      continue;
    }
    // co-rank: a of the first i merged entries come from A (ties from A)
    int lo = i > len_b ? i - len_b : 0, hi = i < len_a ? i : len_a;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (entry_le(A + static_cast<long long>(mid) * width,
                   B + static_cast<long long>(i - mid - 1) * width, width))
        lo = mid + 1;
      else
        hi = mid;
    }
    const int a = lo, b = i - lo;
    const uint32_t* src =
        b >= len_b || (a < len_a && entry_le(A + static_cast<long long>(a) * width,
                                              B + static_cast<long long>(b) * width, width))
            ? A + static_cast<long long>(a) * width
            : B + static_cast<long long>(b) * width;
    for (int w = 0; w < width; ++w) dst[w] = src[w];
  }
}

// Each segment's one list (len entries) -> its k docids and gathered rows.
__global__ void select_finish_kernel(const uint32_t* __restrict__ lists, int n_segs,
                                     long long seg_rows, int len, int width, int k,
                                     Gathers gathers_p, int n_gathers,
                                     int* __restrict__ docids) {
  __shared__ Gathers gathers;
  if (threadIdx.x == 0) gathers = gathers_p;
  __syncthreads();
  const long long total = static_cast<long long>(n_segs) * k;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += step) {
    const long long seg = o / k;
    const int i = static_cast<int>(o % k);
    const uint32_t* list = lists + seg * len * width;
    const uint32_t d = i < len ? list[static_cast<long long>(i) * width + width - 1] : kSentinel;
    const int doc = d == kSentinel ? -1 : static_cast<int>(d);
    docids[o] = doc;
    const long long safe = doc < 0 ? 0 : doc;
    for (int g = 0; g < n_gathers; ++g) {
      const int rb = gathers.row_bytes[g];
      const unsigned char* src = gathers.lane[g] + (seg * gathers.stride[g] + safe) * rb;
      unsigned char* dst = gathers.out[g] + o * rb;
      const bool zero = doc < 0 && ((gathers.zero_invalid >> g) & 1u);
      for (int b = 0; b < rb; ++b) dst[b] = zero ? 0 : src[b];
    }
  }
}

// Rows per tile: a power of two whose entries (width words of 4 bytes)
// fit kTileBytes, and never fewer than one sorting block's threads.
int select_tile_rows(int width) {
  int t = kTileRows;
  while (t > kTileThreads && static_cast<long long>(t) * width * 4 > kTileBytes) t /= 2;
  return t;
}

// Words of the largest list set any pass writes: the tile pass's
// n_tiles * keep entries, or a merge's ceil(n / 2) * min(k, 2 * len).
long long select_list_words(long long padded, int k, int tile, int width) {
  long long n = (padded + tile - 1) / tile, len = k < tile ? k : tile;
  long long most = n * len;
  while (n > 1) {
    len = 2 * len < k ? 2 * len : k;
    n = (n + 1) / 2;
    if (n * len > most) most = n * len;
  }
  return most * width;
}


// ---------------------------------------------------------------------------
// The "select" route
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 256;
constexpr int kSelItems = 16;                       // consecutive rows a thread
constexpr int kSelTile = kSelThreads * kSelItems;   // 4,096 rows a block
constexpr int kBins = 2048;                         // 11-bit digits
constexpr int kDigitPasses = 3;                     // 11 + 11 + 10 bits
constexpr int kStateWords = 16;
constexpr int kSegWords = kStateWords + kBins;      // zeroed per segment
constexpr int kRankSortRows = kSelThreads;          // counting ranks up to here

__host__ __device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 21 : pass == 1 ? 10 : 0;
}
__host__ __device__ __forceinline__ int digit_bits(int pass) { return pass == 2 ? 10 : 11; }

// One segment's selection state, at the head of its zeroed scratch words.
// The selection ends as: every matched row whose word is below lt_bound,
// and the first need_eq by docid of those whose word is t_eq.
struct SelState {
  unsigned long long lt_bound;
  unsigned matched;    // the match count (pass 0)
  unsigned ticket;     // blocks done with the current launch
  unsigned done;       // lt_bound / t_eq / need_eq are final
  unsigned prefix;     // the digits of T chosen so far
  unsigned want;       // rows still wanted from the prefix's bucket (1-based)
  unsigned below;      // matched rows of a smaller word than the bucket
  unsigned t_eq;
  unsigned need_eq;
  unsigned lt_next;    // candidate slots taken by rows below lt_bound
};
static_assert(sizeof(SelState) <= kStateWords * 4, "selection state");

struct SelScratch {
  unsigned* base;
  int n_segs;
  long long n_tiles;
  int k;
  __device__ __forceinline__ SelState* state(long long seg) const {
    return reinterpret_cast<SelState*>(base + seg * kSegWords);
  }
  __device__ __forceinline__ unsigned* bins(long long seg) const {
    return base + seg * kSegWords + kStateWords;
  }
  __device__ __forceinline__ unsigned* tiles(long long seg) const {
    return base + n_segs * static_cast<long long>(kSegWords) + seg * n_tiles;
  }
  __device__ __forceinline__ unsigned* cand_word(long long seg) const {
    return base + n_segs * (static_cast<long long>(kSegWords) + n_tiles) + seg * k;
  }
  __device__ __forceinline__ unsigned* cand_doc(long long seg) const {
    return cand_word(n_segs) + seg * k;
  }
};

long long select_route_words(long long seg_rows, int k, int n_segs) {
  const long long n_tiles = (seg_rows + kSelTile - 1) / kSelTile;
  return static_cast<long long>(n_segs) * (kSegWords + n_tiles + 2LL * k);
}

// The one key word of document doc of segment seg (key_words' first word
// when the terms make one word).
__device__ __forceinline__ uint32_t one_word(const Terms& t, int n_terms, long long seg,
                                             long long doc) {
  uint32_t w = 0u;
  for (int i = 0; i < n_terms; ++i) {
    const int mode = t.mode[i];
    const long long row = seg * t.stride[i] + doc;
    if (mode == kPack) {
      const int id = pinot::read_id(t.lane[i], t.elem[i], row);
      const int term = t.asc[i] ? id : t.card_pad[i] - 1 - id;
      w = w * static_cast<uint32_t>(t.card_pad[i]) + static_cast<uint32_t>(term);
    } else if (mode == kId) {
      const int id = pinot::read_id(t.lane[i], t.elem[i], row);
      w = static_cast<uint32_t>(t.asc[i] ? id : ~id);
    } else {
      int32_t m[2];
      pinot::monotone_words(t.lane[i], t.elem[i], row, m);
      int32_t v = t.asc[i] ? m[0] : ~m[0];
      if (mode == kMonoClamp && v > 0x7ffffffe) v = 0x7ffffffe;
      w = static_cast<uint32_t>(v);
    }
  }
  return w ^ 0x80000000u;
}

// The word of a one-term key from the term's element (an id sign-extended
// from 8 or 16 bits, an int32, or a float32's bits): one_word's first term.
__device__ __forceinline__ uint32_t word_of(const Terms& t, int32_t raw) {
  const int mode = t.mode[0];
  int32_t v;
  if (mode == kPack) {
    v = t.asc[0] ? raw : t.card_pad[0] - 1 - raw;
  } else if (mode == kId) {
    v = t.asc[0] ? raw : ~raw;
  } else {
    const int32_t m = t.elem[0] == pinot::kF32 ? raw ^ ((raw >> 31) & 0x7fffffff) : raw;
    v = t.asc[0] ? m : ~m;
    if (mode == kMonoClamp && v > 0x7ffffffe) v = 0x7ffffffe;
  }
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

// The words of a thread's 16 rows r0 .. r0 + 15 of segment seg (0 where
// the row is not matched). `fast`: one term of 1, 2 or 4 bytes, its rows
// 16-byte aligned, so the 16 elements are one to four 16-byte loads,
// issued whatever the mask (the callers do not wait for it): streaming
// every row's element beat reading the matched rows' own even under the
// 4% mask of the stacked SSB selection (793 against 1,259 µs on an H100).
__device__ __forceinline__ void tile_words(const Terms& t, int n_terms, int fast, long long seg,
                                           long long r0, long long left, unsigned hits,
                                           uint32_t (&w)[kSelItems]) {
  if (fast && left >= kSelItems) {
    const int elem = t.elem[0];
    const long long row = seg * t.stride[0] + r0;
    int32_t raw[kSelItems];
    if (elem == pinot::kI8) {
      const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(t.lane[0]) + row);
      const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < kSelItems; ++j)
        raw[j] = static_cast<int8_t>((x[j >> 2] >> ((j & 3) * 8)) & 0xFFu);
    } else if (elem == pinot::kI16) {
      const uint4* src = reinterpret_cast<const uint4*>(static_cast<const int16_t*>(t.lane[0]) + row);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 v = src[q];
        const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          raw[q * 8 + j] = static_cast<int16_t>((x[j >> 1] >> ((j & 1) * 16)) & 0xFFFFu);
      }
    } else {
      const int4* src = reinterpret_cast<const int4*>(static_cast<const int32_t*>(t.lane[0]) + row);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = src[q];
        raw[q * 4] = v.x;
        raw[q * 4 + 1] = v.y;
        raw[q * 4 + 2] = v.z;
        raw[q * 4 + 3] = v.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kSelItems; ++j) w[j] = (hits >> j) & 1u ? word_of(t, raw[j]) : 0u;
  } else {
#pragma unroll
    for (int j = 0; j < kSelItems; ++j)
      w[j] = (hits >> j) & 1u ? one_word(t, n_terms, seg, r0 + j) : 0u;
  }
}

// Bit j: row row0 + j of the segment is matched (rows past the segment
// are not); one 16-byte load where all 16 rows lie inside and the mask is
// 16-byte aligned.
__device__ __forceinline__ unsigned hit_bits(const uint8_t* __restrict__ m, long long left,
                                             bool vec) {
  unsigned bits = 0u;
  if (vec && left >= kSelItems) {
    const uint4 v = *reinterpret_cast<const uint4*>(m);
    const unsigned x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < kSelItems; ++j)
      if ((x[j >> 2] >> ((j & 3) * 8)) & 0xFFu) bits |= 1u << j;
  } else {
    for (int j = 0; j < kSelItems && j < left; ++j)
      if (m[j]) bits |= 1u << j;
  }
  return bits;
}

// Block-wide exclusive scan of one int a thread; `total` gets the sum.
// `sums` holds one int a warp. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += up;
  }
  __syncthreads();                    // sums may still be read
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  int pre = 0, all = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int s = sums[w];
    if (w < warp) pre += s;
    all += s;
  }
  total = all;
  return pre + x - v;
}

// After this block's device-memory updates: is it the last block of its
// segment to finish this launch? The last one then sees every block's
// updates.
__device__ __forceinline__ bool last_block(unsigned* ticket, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// Digit pass `pass` of the threshold: grid (tiles, segments). Pass 0 also
// counts the matched rows (and writes count[seg]); a segment whose
// threshold is final returns at once.
__global__ void __launch_bounds__(kSelThreads)
    select_hist_kernel(const uint8_t* __restrict__ mask, Terms terms_p, int n_terms, int n_words,
                       long long seg_rows, int k, int pass, int vec, int fast, SelScratch sc,
                       int* __restrict__ count) {
  __shared__ Terms terms;
  __shared__ int hist[kBins];
  __shared__ int sums[kSelThreads / 32];
  __shared__ bool is_last;
  const long long seg = blockIdx.y;
  SelState* st = sc.state(seg);
  if (pass > 0 && __ldcg(&st->done)) return;
  if (threadIdx.x == 0) terms = terms_p;
  for (int b = threadIdx.x; b < kBins; b += kSelThreads) hist[b] = 0;
  __syncthreads();
  const int shift = digit_shift(pass), bits = digit_bits(pass);
  const unsigned prefix = pass ? __ldcg(&st->prefix) : 0u;
  const long long r0 = static_cast<long long>(blockIdx.x) * kSelTile +
                       static_cast<long long>(threadIdx.x) * kSelItems;
  const unsigned hits = hit_bits(mask + seg * seg_rows + r0, seg_rows - r0, vec);
  if (n_words && (fast || hits)) {
    uint32_t w[kSelItems];
    tile_words(terms, n_terms, fast, seg, r0, seg_rows - r0, hits, w);
#pragma unroll
    for (int j = 0; j < kSelItems; ++j)
      if (((hits >> j) & 1u) && (shift + bits == 32 || (w[j] >> (shift + bits)) == prefix))
        atomicAdd(&hist[(w[j] >> shift) & ((1u << bits) - 1u)], 1);
  }
  if (pass == 0) {
    const int matched = pinot::block_sum(__popc(hits), sums);
    if (threadIdx.x == 0 && matched) atomicAdd(&st->matched, static_cast<unsigned>(matched));
  }
  __syncthreads();
  unsigned* gbins = sc.bins(seg);
  if (n_words)
    for (int b = threadIdx.x; b < kBins; b += kSelThreads)
      if (hist[b]) atomicAdd(&gbins[b], static_cast<unsigned>(hist[b]));
  if (!last_block(&st->ticket, &is_last)) return;

  // the segment's last block: the bucket that holds the k-th row
  unsigned want = static_cast<unsigned>(k), below = 0u, pre = 0u;
  if (pass == 0) {
    const unsigned m = __ldcg(&st->matched);
    if (threadIdx.x == 0) count[seg] = static_cast<int>(m);
    if (n_words == 0 || m <= static_cast<unsigned>(k)) {
      if (threadIdx.x == 0) {
        // limit: the first min(k, m) rows by docid; else every matched row
        st->lt_bound = n_words ? (1ULL << 32) : 0ULL;
        st->below = n_words ? m : 0u;
        st->t_eq = 0u;
        st->need_eq = n_words ? 0u : min(m, static_cast<unsigned>(k));
        st->done = 1u;
        st->ticket = 0u;
      }
      return;
    }
  } else {
    want = __ldcg(&st->want);
    below = __ldcg(&st->below);
    pre = prefix;
  }
  // thread t owns bins [8t, 8t + 8)
  constexpr int kPer = kBins / kSelThreads;
  unsigned h[kPer];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    h[i] = __ldcg(&gbins[threadIdx.x * kPer + i]);
    mine += static_cast<int>(h[i]);
  }
  int total;
  const unsigned before = static_cast<unsigned>(block_exclusive_scan(mine, sums, total));
  if (before < want && want <= before + static_cast<unsigned>(mine)) {
    unsigned cum = before;
    int b = 0;
    for (int i = 0; i < kPer; ++i) {
      if (want <= cum + h[i]) {
        b = threadIdx.x * kPer + i;
        break;
      }
      cum += h[i];
    }
    const unsigned hb = h[b - threadIdx.x * kPer];
    below += cum;
    want -= cum;
    const unsigned np = (pre << bits) | static_cast<unsigned>(b);
    if (hb == want) {                 // the k-th row closes the bucket
      st->lt_bound = (static_cast<unsigned long long>(np) + 1ULL) << shift;
      st->below = below + want;
      st->need_eq = 0u;
      st->done = 1u;
    } else if (shift == 0) {          // T: ties straddle the k-th row
      st->lt_bound = np;
      st->t_eq = np;
      st->below = below;
      st->need_eq = want;
      st->done = 1u;
    } else {
      st->prefix = np;
      st->want = want;
      st->below = below;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) gbins[threadIdx.x * kPer + i] = 0u;
  if (threadIdx.x == 0) st->ticket = 0u;
}

// The count pass: each tile's matched rows of word t_eq, then (the last
// block) their exclusive prefix over the segment's tiles, in place. Runs
// only where some but not all rows of word t_eq are taken, or for "limit".
__global__ void __launch_bounds__(kSelThreads)
    select_count_kernel(const uint8_t* __restrict__ mask, Terms terms_p, int n_terms,
                        int n_words, long long seg_rows, int vec, int fast, SelScratch sc) {
  __shared__ Terms terms;
  __shared__ int sums[kSelThreads / 32];
  __shared__ bool is_last;
  const long long seg = blockIdx.y;
  SelState* st = sc.state(seg);
  const unsigned need_eq = __ldcg(&st->need_eq);
  if (need_eq == 0u) return;
  if (threadIdx.x == 0) terms = terms_p;
  __syncthreads();
  const unsigned t_eq = __ldcg(&st->t_eq);
  const long long r0 = static_cast<long long>(blockIdx.x) * kSelTile +
                       static_cast<long long>(threadIdx.x) * kSelItems;
  const unsigned hits = hit_bits(mask + seg * seg_rows + r0, seg_rows - r0, vec);
  int eq = 0;
  if (n_words && (fast || hits)) {
    uint32_t w[kSelItems];
    tile_words(terms, n_terms, fast, seg, r0, seg_rows - r0, hits, w);
#pragma unroll
    for (int j = 0; j < kSelItems; ++j) eq += ((hits >> j) & 1u) && w[j] == t_eq;
  } else if (!n_words) {
    eq = __popc(hits);
  }
  const int c = pinot::block_sum(eq, sums);
  unsigned* tiles = sc.tiles(seg);
  if (threadIdx.x == 0) tiles[blockIdx.x] = static_cast<unsigned>(c);
  if (!last_block(&st->ticket, &is_last)) return;
  int carry = 0;
  for (long long t0 = 0; t0 < sc.n_tiles; t0 += kSelThreads) {
    const long long t = t0 + threadIdx.x;
    const int v = t < sc.n_tiles ? static_cast<int>(__ldcg(&tiles[t])) : 0;
    int total;
    const int ex = block_exclusive_scan(v, sums, total);
    if (t < sc.n_tiles) tiles[t] = static_cast<unsigned>(carry + ex);
    carry += total;
  }
  if (threadIdx.x == 0) st->ticket = 0u;
}

// The write pass: rows below lt_bound into the first `below` candidate
// slots in any order, the first need_eq rows of word t_eq by docid at
// below + their rank.
__global__ void __launch_bounds__(kSelThreads)
    select_write_kernel(const uint8_t* __restrict__ mask, Terms terms_p, int n_terms,
                        int n_words, long long seg_rows, int vec, int fast, SelScratch sc) {
  __shared__ Terms terms;
  __shared__ int sums[kSelThreads / 32];
  const long long seg = blockIdx.y;
  SelState* st = sc.state(seg);
  const unsigned long long lt_bound = __ldcg(&st->lt_bound);
  const unsigned need_eq = __ldcg(&st->need_eq);
  if (lt_bound == 0ULL && need_eq == 0u) return;
  const unsigned eq_base = need_eq ? __ldcg(&sc.tiles(seg)[blockIdx.x]) : 0u;
  if (lt_bound == 0ULL && eq_base >= need_eq) return;
  if (threadIdx.x == 0) terms = terms_p;
  __syncthreads();
  const unsigned t_eq = __ldcg(&st->t_eq), below = __ldcg(&st->below);
  const int lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * kSelTile +
                       static_cast<long long>(threadIdx.x) * kSelItems;
  const unsigned hits = hit_bits(mask + seg * seg_rows + r0, seg_rows - r0, vec);
  uint32_t w[kSelItems];
  if (n_words && (fast || hits)) {
    tile_words(terms, n_terms, fast, seg, r0, seg_rows - r0, hits, w);
  } else {
#pragma unroll
    for (int j = 0; j < kSelItems; ++j) w[j] = 0u;
  }
  unsigned lt = 0u, eq = 0u;
#pragma unroll
  for (int j = 0; j < kSelItems; ++j) {
    if ((hits >> j) & 1u) {
      if (w[j] < lt_bound)
        lt |= 1u << j;
      else if (need_eq && w[j] == t_eq)
        eq |= 1u << j;
    }
  }
  unsigned* cw = sc.cand_word(seg);
  unsigned* cd = sc.cand_doc(seg);
  // rows below lt_bound: one atomic a warp
  const int n_lt = __popc(lt);
  int x = n_lt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += up;
  }
  unsigned at = 0u;
  if (lane == 31 && x) at = atomicAdd(&st->lt_next, static_cast<unsigned>(x));
  at = __shfl_sync(0xffffffffu, at, 31) + static_cast<unsigned>(x - n_lt);
#pragma unroll
  for (int j = 0; j < kSelItems; ++j)
    if ((lt >> j) & 1u) {
      cw[at] = w[j];
      cd[at] = static_cast<unsigned>(r0 + j);
      ++at;
    }
  // rows of word t_eq: their rank by docid
  if (need_eq) {
    int total;
    unsigned rank = eq_base + static_cast<unsigned>(block_exclusive_scan(__popc(eq), sums, total));
#pragma unroll
    for (int j = 0; j < kSelItems; ++j)
      if ((eq >> j) & 1u) {
        if (rank < need_eq) {
          cw[below + rank] = w[j];
          cd[below + rank] = static_cast<unsigned>(r0 + j);
        }
        ++rank;
      }
  }
}

// Position i of segment seg's output: its docid (-1 past the selected
// rows) and every gather column's row.
__device__ __forceinline__ void finish_row(const Gathers& g, int n_gathers, long long seg,
                                           int k, int i, int doc, int* __restrict__ docids) {
  const long long o = seg * k + i;
  docids[o] = doc;
  const long long safe = doc < 0 ? 0 : doc;
  for (int j = 0; j < n_gathers; ++j) {
    const int rb = g.row_bytes[j];
    const unsigned char* src = g.lane[j] + (seg * g.stride[j] + safe) * rb;
    unsigned char* dst = g.out[j] + o * rb;
    const bool zero = doc < 0 && ((g.zero_invalid >> j) & 1u);
    for (int b = 0; b < rb; ++b) dst[b] = zero ? 0 : src[b];
  }
}

// The candidates as cluster_sort reads them: (word, docid), 32 bits each,
// already in unsigned order.
struct CandKeys {
  const unsigned* word;
  const unsigned* doc;
  __device__ __forceinline__ int lanes() const { return 2; }
  __device__ __forceinline__ bool wide(int) const { return false; }
  __device__ __forceinline__ unsigned long long bits(int l, unsigned row) const {
    return l == 0 ? __ldcg(&word[row]) : __ldcg(&doc[row]);
  }
};

// The finish where no cluster sort is needed, grid (ceil(k / 256), seg):
// "limit", whose candidates are in docid order already, and at most 256
// candidates (k <= kRankSortRows), ordered by counting ranks in block 0
// (a candidate's rank is the number of (word, docid) keys below its own).
__global__ void __launch_bounds__(kSelThreads)
    select_rank_kernel(SelScratch sc, int k, int n_words, Gathers gathers_p, int n_gathers,
                       int* __restrict__ docids) {
  __shared__ Gathers gathers;
  __shared__ unsigned long long key[kRankSortRows];
  if (threadIdx.x == 0) gathers = gathers_p;
  __syncthreads();
  const long long seg = blockIdx.y;
  const unsigned m = __ldcg(&sc.state(seg)->matched);
  const int c = static_cast<int>(min(m, static_cast<unsigned>(k)));
  const unsigned* cw = sc.cand_word(seg);
  const unsigned* cd = sc.cand_doc(seg);
  const int i = blockIdx.x * kSelThreads + threadIdx.x;
  if (n_words == 0) {
    if (i < k) finish_row(gathers, n_gathers, seg, k, i, i < c ? static_cast<int>(__ldcg(&cd[i])) : -1,
                          docids);
    return;
  }
  if (threadIdx.x < c)
    key[threadIdx.x] = (static_cast<unsigned long long>(__ldcg(&cw[threadIdx.x])) << 32) |
                       __ldcg(&cd[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x < c) {
    const unsigned long long mine = key[threadIdx.x];
    int rank = 0;
    for (int j = 0; j < c; ++j) rank += key[j] < mine;
    finish_row(gathers, n_gathers, seg, k, rank, static_cast<int>(mine & 0xffffffffULL), docids);
  } else if (threadIdx.x < k) {
    finish_row(gathers, n_gathers, seg, k, threadIdx.x, -1, docids);
  }
}

// The sort and the finish above 256 candidates: cluster (., seg) of
// gridDim.x CTAs orders segment seg's min(k, matched) candidates by (word,
// docid) and writes its k output rows. Two 32-bit lanes: at most 64
// varying bits, so the keys are packed and the docid is rebuilt from
// shared memory.
__global__ void __launch_bounds__(pinot::kSortThreads, 1)
    select_sort_kernel(SelScratch sc, int k, Gathers gathers_p, int n_gathers,
                       int* __restrict__ docids) {
  extern __shared__ __align__(16) unsigned char smem[];
  pinot::SortSmem& sm = *reinterpret_cast<pinot::SortSmem*>(smem);
  __shared__ Gathers gathers;
  if (threadIdx.x == 0) gathers = gathers_p;
  __syncthreads();
  const long long seg = blockIdx.y;
  const int me = blockIdx.x, n_ctas = gridDim.x;
  const unsigned m = __ldcg(&sc.state(seg)->matched);
  const int c = static_cast<int>(min(m, static_cast<unsigned>(k)));
  const pinot::SortRange r = pinot::cluster_sort(sm, CandKeys{sc.cand_word(seg), sc.cand_doc(seg)},
                                                 c, c);
  for (int i = r.lo + threadIdx.x; i < r.hi; i += blockDim.x)
    finish_row(gathers, n_gathers, seg, k, i, static_cast<int>(r.bits(1, i)), docids);
  for (int i = c + me * blockDim.x + threadIdx.x; i < k; i += n_ctas * blockDim.x)
    finish_row(gathers, n_gathers, seg, k, i, -1, docids);
}

int launch_select(const uint8_t* mask, long long seg_rows, int n_segs, int k, const Terms& terms,
                  int n_terms, int n_words, const Gathers& gathers, int n_gathers,
                  unsigned* scratch, int* docids, int* count, cudaStream_t s) {
  SelScratch sc{scratch, n_segs, (seg_rows + kSelTile - 1) / kSelTile, k};
  if (sc.n_tiles > 0x7fffffffLL) return -1;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, static_cast<size_t>(n_segs) * kSegWords * 4, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0 && seg_rows % 16 == 0;
  // one term of a 1-, 2- or 4-byte element whose rows start 16-byte aligned
  const int esz = n_terms == 1 ? (terms.elem[0] == pinot::kI8 ? 1 : terms.elem[0] == pinot::kI16 ? 2
                                  : terms.elem[0] == pinot::kI32 || terms.elem[0] == pinot::kF32 ? 4
                                                                                                 : 0)
                               : 0;
  const int fast = vec && esz && reinterpret_cast<uintptr_t>(terms.lane[0]) % 16 == 0 &&
                   (terms.stride[0] * esz) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(sc.n_tiles), static_cast<unsigned>(n_segs));
  for (int pass = 0; pass < (n_words ? kDigitPasses : 1); ++pass) {
    select_hist_kernel<<<grid, kSelThreads, 0, s>>>(mask, terms, n_terms, n_words, seg_rows, k,
                                                    pass, vec, fast, sc, count);
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  select_count_kernel<<<grid, kSelThreads, 0, s>>>(mask, terms, n_terms, n_words, seg_rows, vec,
                                                   fast, sc);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  select_write_kernel<<<grid, kSelThreads, 0, s>>>(mask, terms, n_terms, n_words, seg_rows, vec,
                                                   fast, sc);
  if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  if (n_words == 0 || k <= kRankSortRows) {
    select_rank_kernel<<<dim3((k + kSelThreads - 1) / kSelThreads, n_segs), kSelThreads, 0, s>>>(
        sc, k, n_words, gathers, n_gathers, docids);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(pinot::SortSmem);
  rc = cudaFuncSetAttribute(select_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int ctas = pinot::sort_ctas(k);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, n_segs);
  cfg.blockDim = dim3(pinot::kSortThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, select_sort_kernel, sc, k, gathers, n_gathers, docids);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

}  // namespace

// Routes (ops/kernels.py: SELECT_ROUTES): 0 "tile", 1 "select" (at most
// one key word).
constexpr int kRouteTile = 0, kRouteSelect = 1;

// int32 words of scratch pinot_masked_select needs on `route`. "tile":
// two list sets, each n_segs segments' lists; "select": each segment's
// state and histogram (zeroed by the launch), its tiles' tie counts and
// its k candidates' words and docids.
extern "C" long long pinot_masked_select_scratch_words(long long seg_rows, int k, int n_words,
                                                       int n_segs, int route) {
  if (route == kRouteSelect) return select_route_words(seg_rows, k, n_segs);
  const int width = n_words + 1;
  return 2LL * n_segs * select_list_words(seg_rows, k, select_tile_rows(width), width);
}

// Rows per tile of the "tile" route for n_words key words (exported for
// the tests).
extern "C" int pinot_masked_select_tile_rows(int n_words) {
  return select_tile_rows(n_words + 1);
}

namespace {

int launch(const void* mask, long long seg_rows, int n_segs, int k, const void** term_lanes,
           const long long* term_strides, const int* term_elems, const int* term_modes,
           const int* term_card_pads, const int* term_asc, int n_terms, int n_words,
           const void** gather_lanes, const long long* gather_strides,
           const int* gather_row_bytes, void** gather_outs, int n_gathers, int zero_invalid,
           void* scratch, long long scratch_words, void* docids, void* count, int route,
           void* stream) {
  if (n_terms < 0 || n_terms > kMaxTerms || n_words < 0 || n_words > kMaxWords ||
      n_gathers < 0 || n_gathers > kMaxGathers || k < 1 || k > seg_rows || n_segs < 1 ||
      n_segs > 65535 || (route != kRouteTile && route != kRouteSelect) ||
      (route == kRouteSelect && (n_words > 1 || k > pinot::kSortMaxRows)) ||
      scratch_words < pinot_masked_select_scratch_words(seg_rows, k, n_words, n_segs, route))
    return -1;
  Terms terms = {};
  for (int i = 0; i < n_terms; ++i) {
    terms.lane[i] = term_lanes[i];
    terms.stride[i] = term_strides ? term_strides[i] : seg_rows;
    terms.elem[i] = term_elems[i];
    terms.mode[i] = term_modes[i];
    terms.card_pad[i] = term_card_pads[i];
    terms.asc[i] = term_asc[i];
  }
  Gathers gathers = {};
  gathers.zero_invalid = static_cast<unsigned>(zero_invalid);
  for (int g = 0; g < n_gathers; ++g) {
    gathers.lane[g] = static_cast<const unsigned char*>(gather_lanes[g]);
    gathers.stride[g] = gather_strides ? gather_strides[g] : seg_rows;
    gathers.out[g] = static_cast<unsigned char*>(gather_outs[g]);
    gathers.row_bytes[g] = gather_row_bytes[g];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteSelect)
    return launch_select(static_cast<const uint8_t*>(mask), seg_rows, n_segs, k, terms, n_terms,
                         n_words, gathers, n_gathers, static_cast<unsigned*>(scratch),
                         static_cast<int*>(docids), static_cast<int*>(count), s);
  const int width = n_words + 1;
  const int tile = select_tile_rows(width);
  const long long n_tiles = (seg_rows + tile - 1) / tile;
  const int keep = k < tile ? k : tile;
  const long long list_words = n_segs * select_list_words(seg_rows, k, tile, width);
  if (n_tiles > 0x7fffffffLL) return -1;
  cudaError_t rc = cudaMemsetAsync(count, 0, static_cast<size_t>(n_segs) * sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // the dynamic tile plus the static descriptors may pass the default 48 KB
  const size_t smem = static_cast<size_t>(tile) * width * sizeof(uint32_t);
  rc = pinot::allow_dynamic_smem(select_tile_kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  uint32_t* src = static_cast<uint32_t*>(scratch);
  uint32_t* dst = src + list_words;
  select_tile_kernel<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_segs)),
                       kTileThreads, smem, s>>>(static_cast<const uint8_t*>(mask), terms,
                                                n_terms, n_words, seg_rows, tile, keep, src,
                                                static_cast<int*>(count));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int n_lists = static_cast<int>(n_tiles), len = keep;
  while (n_lists > 1) {
    const int len_out = 2LL * len < k ? 2 * len : k;
    const long long outs = static_cast<long long>(n_segs) * ((n_lists + 1) / 2) * len_out;
    select_merge_kernel<<<pinot::grid_for(outs), pinot::kThreads, 0, s>>>(
        src, n_segs, n_lists, len, len_out, width, dst);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    uint32_t* t = src;
    src = dst;
    dst = t;
    n_lists = (n_lists + 1) / 2;
    len = len_out;
  }
  select_finish_kernel<<<pinot::grid_for(static_cast<long long>(n_segs) * k), pinot::kThreads,
                         0, s>>>(src, n_segs, seg_rows, len, width, k, gathers, n_gathers,
                                 static_cast<int*>(docids));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lanes hold n_segs segments of seg_rows rows; docids int32
// [n_segs][k], count int32 [n_segs], gather outputs [n_segs][k] rows;
// route as pinot_masked_select_scratch_words takes it.
extern "C" int pinot_masked_select(
    const void* mask, long long seg_rows, int n_segs, int k, const void** term_lanes,
    const int* term_elems, const int* term_modes, const int* term_card_pads,
    const int* term_asc, int n_terms, int n_words, const void** gather_lanes,
    const int* gather_row_bytes, void** gather_outs, int n_gathers, int zero_invalid,
    void* scratch, long long scratch_words, void* docids, void* count, int route,
    void* stream) {
  return launch(mask, seg_rows, n_segs, k, term_lanes, nullptr, term_elems, term_modes,
                term_card_pads, term_asc, n_terms, n_words, gather_lanes, nullptr,
                gather_row_bytes, gather_outs, n_gathers, zero_invalid, scratch,
                scratch_words, docids, count, route, stream);
}

// n_members members of one segment of `padded` rows: mask uint8
// [n_members][padded]; each key and gather lane with its stride between
// members (0: shared, padded: the member's own rows); docids int32
// [n_members][k], count int32 [n_members], gather outputs [n_members][k]
// rows.
extern "C" int pinot_masked_select_batched(
    const void* mask, long long padded, int n_members, int k, const void** term_lanes,
    const long long* term_strides, const int* term_elems, const int* term_modes,
    const int* term_card_pads, const int* term_asc, int n_terms, int n_words,
    const void** gather_lanes, const long long* gather_strides, const int* gather_row_bytes,
    void** gather_outs, int n_gathers, int zero_invalid, void* scratch,
    long long scratch_words, void* docids, void* count, int route, void* stream) {
  return launch(mask, padded, n_members, k, term_lanes, term_strides, term_elems, term_modes,
                term_card_pads, term_asc, n_terms, n_words, gather_lanes, gather_strides,
                gather_row_bytes, gather_outs, n_gathers, zero_invalid, scratch,
                scratch_words, docids, count, route, stream);
}
