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
// Design, simple first (a radix select and fewer passes are later work):
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
// Stacked segments (the counterpart of the vmap in
// pinot_tpu/parallel/sharded.py:get_sharded_kernel, whose selection
// outputs are all-gathered per segment): the lanes hold n_segs segments
// of seg_rows rows each, back to back; every pass has a segment axis
// (the tile pass's grid y, a leading index of the merges and of the
// finish), docids count from each segment's first row, and the outputs
// are [n_segs][k] per-segment top-k (the host merges them). One segment
// is n_segs = 1.
// Every launch runs on the caller's stream; the host function returns the
// first non-zero cudaGetLastError. The tile size and the scratch size are
// decided here only: the wrapper asks pinot_masked_select_scratch_words
// how many int32 words of scratch to allocate.

#include "common.cuh"

namespace {

constexpr int kMaxTerms = 8;
constexpr int kMaxWords = 8;
constexpr int kMaxGathers = 32;
constexpr int kSortThreads = 1024;
constexpr uint32_t kSentinel = 0xffffffffu;
constexpr int kTileRows = 4096;          // rows per tile, at most
constexpr int kTileBytes = 64 << 10;     // a tile's keys in shared memory

// key-term modes (ops/kernels.py: _PACK, _ID, _MONO, _MONO_CLAMP)
enum Mode : int { kPack = 0, kId = 1, kMono = 2, kMonoClamp = 3 };

struct Terms {
  const void* lane[kMaxTerms];
  int elem[kMaxTerms];
  int mode[kMaxTerms];
  int card_pad[kMaxTerms];
  int asc[kMaxTerms];
};

struct Gathers {
  const unsigned char* lane[kMaxGathers];
  unsigned char* out[kMaxGathers];
  int row_bytes[kMaxGathers];
  unsigned zero_invalid;     // bit g: gather g writes zeros after the valid rows
};

// The row's key words as the JAX function computes them, most significant
// first, mapped to unsigned order.
__device__ __forceinline__ void key_words(const Terms& t, int n_terms, long long row,
                                          uint32_t* out) {
  int32_t w[kMaxWords];
  int n = 0;
  for (int i = 0; i < n_terms; ++i) {
    const int mode = t.mode[i];
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

__global__ void __launch_bounds__(kSortThreads)
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
      key_words(terms, n_terms, row, w);
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
    const long long safe = seg * seg_rows + (doc < 0 ? 0 : doc);
    for (int g = 0; g < n_gathers; ++g) {
      const int rb = gathers.row_bytes[g];
      const unsigned char* src = gathers.lane[g] + safe * rb;
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
  while (t > kSortThreads && static_cast<long long>(t) * width * 4 > kTileBytes) t /= 2;
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

}  // namespace

// int32 words of scratch pinot_masked_select needs: two list sets, each
// n_segs segments' lists.
extern "C" long long pinot_masked_select_scratch_words(long long seg_rows, int k, int n_words,
                                                       int n_segs) {
  const int width = n_words + 1;
  return 2LL * n_segs * select_list_words(seg_rows, k, select_tile_rows(width), width);
}

// Rows per tile for n_words key words (exported for the tests).
extern "C" int pinot_masked_select_tile_rows(int n_words) {
  return select_tile_rows(n_words + 1);
}

// The lanes hold n_segs segments of seg_rows rows; docids int32
// [n_segs][k], count int32 [n_segs] (zeroed), gather outputs [n_segs][k]
// rows.
extern "C" int pinot_masked_select(
    const void* mask, long long seg_rows, int n_segs, int k, const void** term_lanes,
    const int* term_elems, const int* term_modes, const int* term_card_pads,
    const int* term_asc, int n_terms, int n_words, const void** gather_lanes,
    const int* gather_row_bytes, void** gather_outs, int n_gathers, int zero_invalid,
    void* scratch,
    long long scratch_words, void* docids, void* count, void* stream) {
  if (n_terms < 0 || n_terms > kMaxTerms || n_words < 0 || n_words > kMaxWords ||
      n_gathers < 0 || n_gathers > kMaxGathers || k < 1 || k > seg_rows || n_segs < 1 ||
      n_segs > 65535)
    return -1;
  const int width = n_words + 1;
  const int tile = select_tile_rows(width);
  const long long n_tiles = (seg_rows + tile - 1) / tile;
  const int keep = k < tile ? k : tile;
  const long long list_words = n_segs * select_list_words(seg_rows, k, tile, width);
  if (n_tiles > 0x7fffffffLL || scratch_words < 2 * list_words) return -1;
  Terms terms = {};
  for (int i = 0; i < n_terms; ++i) {
    terms.lane[i] = term_lanes[i];
    terms.elem[i] = term_elems[i];
    terms.mode[i] = term_modes[i];
    terms.card_pad[i] = term_card_pads[i];
    terms.asc[i] = term_asc[i];
  }
  Gathers gathers = {};
  gathers.zero_invalid = static_cast<unsigned>(zero_invalid);
  for (int g = 0; g < n_gathers; ++g) {
    gathers.lane[g] = static_cast<const unsigned char*>(gather_lanes[g]);
    gathers.out[g] = static_cast<unsigned char*>(gather_outs[g]);
    gathers.row_bytes[g] = gather_row_bytes[g];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the dynamic tile plus the static descriptors may pass the default 48 KB
  const size_t smem = static_cast<size_t>(tile) * width * sizeof(uint32_t);
  cudaError_t rc = cudaFuncSetAttribute(
      select_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  uint32_t* src = static_cast<uint32_t*>(scratch);
  uint32_t* dst = src + list_words;
  select_tile_kernel<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_segs)),
                       kSortThreads, smem, s>>>(static_cast<const uint8_t*>(mask), terms,
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
