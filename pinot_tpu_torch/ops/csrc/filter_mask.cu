// K1 filter_mask: the per-row filter of a segment plan as a uint8 mask.
//
// Replaces pinot_tpu/ops/kernels.py:_eval_filter (:175) and _eval_pred
// (:82) for the dictId predicate kinds eq_id, neq_id, range_ids, in_ids,
// notin_ids and member over single-value ([P]) and multi-value ([P, W])
// id lanes, and the raw kinds eq_raw, neq_raw, in_raw, notin_raw and
// range_raw over int32 / int64 / float32 / float64 value lanes, and
// ivf_probe (_eval_ivf_probe, :161: the row's IVF cell is in the probe
// list K9 selected for its segment), vdoc (:112, the upsert
// validDocIds leaf: the row's byte of the uint8 liveness lane) and
// join_raw (:118-130, the probe of a raw-key inner join: the row's key is
// one of the dim side's keys), under and/or nodes of any arity.
//
// Semantics kept from the JAX function:
// - an MV leaf matches a row when ANY of its W entries matches, padding
//   entries (id == cardinality) included, exactly as `m.any(-1)` does;
// - a raw leaf compares in the lane's own dtype against constants the
//   planner already cast to that dtype (plan.py `cv`): a float32 lane is
//   never widened to double, which would flip rows at the boundary; NaN
//   follows the IEEE compares of C++, as XLA's do.
//
// What bounds it: bytes. Each row reads one element per distinct leaf lane
// (1 to 8 bytes, W of them for an MV lane) and writes one mask byte, a
// handful of compares per row; at 3.35 TB/s the reads and the write are
// the whole cost.
//
// What the design does about it (the row route; the wide route below):
// the host flattens the filter tree into a postfix program plus its
// parameters (one small int32 buffer, one copy to the card per dispatch).
// Each block stages that buffer in shared memory, so in-lists and member
// bitsets are read from shared memory, never from device memory per row.
// One thread evaluates one row at a time over a
// grid-stride loop: neighbouring threads read neighbouring elements of
// each lane (coalesced), and the program runs on a bit stack in one
// register. A leaf's lane is read only when that leaf is evaluated. The
// kernel has two instantiations: one for programs whose leaves are all
// dictId leaves over SV lanes (the SSB filters), one for programs with raw
// or MV leaves. The general one needs more registers, so fewer blocks fit
// on an SM; the host picks by the program, and the grid is one full wave
// of whichever it launches.
//
// Stacked segments (the counterpart of the vmap in
// pinot_tpu/parallel/sharded.py:get_sharded_kernel): the lanes hold S
// segments of seg_rows rows each, back to back, and row r is live iff
// r % seg_rows < seg_docs[r / seg_rows]. seg_matched[s] counts the
// matched rows of segment s (the JAX `stats.seg_matched`). A block's rows
// in one pass of the grid-stride loop never straddle two segments
// (seg_rows is a multiple of the block), so the block sums its count and
// adds it with one atomic when its rows move to the next segment. One
// segment (seg_docs null: row r is live iff r < num_docs) runs an
// instantiation without that bookkeeping, which cost the single-segment
// filter 13% on the H100 (PERF.md).
//
// Program node: 6 int32 {op, lane, param offset, arg, elem, width}.
// AND/OR pop `arg` bits (arg <= 31) and push one; leaves push one. `elem`
// is the lane's element type (pinot::Elem in common.cuh), `width` its
// values per row (1 for an SV or raw lane, W for an MV lane). Raw
// constants take one int32 word (int32, float32) or two (int64, float64:
// low word first) in the parameter area; a range_raw's `arg` holds
// lo_inclusive | hi_inclusive << 1.
// An ivf_probe node reads the row's assignment lane and two more entries
// of the lane table, the probe ids and ok flags, whose indices are its two
// parameter words. A vdoc node takes no parameters: it reads one byte of
// its uint8 lane (1 = live, 0 = superseded or padding) and pushes it. Both
// instantiations take it, so an upsert-masked dictId filter keeps the
// narrow one; it costs one more byte read per row. In the stacked form the
// lane is the stack's [S][P] liveness, indexed by the same flat row; in
// the batched form the one lane of the segment serves every member, read
// once per row.
// A join_raw node reads the row's int32 / int64 key and one more entry of
// the lane table, the dim keys sorted ascending in the same type (K12
// sorted them once for the query, where the JAX kernel sorts inside every
// launch), whose index is its one parameter word; arg is their count Dp
// (a power of two <= 65,536, padded by repeating the largest key). It
// pushes sk[pos] == key at the key's lower-bound position pos clipped to
// Dp - 1 (searchsorted): at most 17 probes of the keys, which stay in L2.
// It is a raw leaf, so only the general instantiation takes it (the
// narrow one keeps its registers), in the single and the batched form.
// Where the dim keys span at most 2^26 values (JOIN_BITMAP_MAX_SPAN) the
// single and stacked forms take a join_bitmap node in its place: its
// lane is the uint32 words of a bitmap over [base, base + span), bit
// (k - base) & 31 of word (k - base) >> 5 set iff k is a dim key (the
// host builds it once a query and device from the keys: 8 MB at most,
// in L2); a second lane holds its coarse level, a bit for each 2^shift
// keys, at most kJoinSmemBytes. Its parameter words are the two lanes'
// indices, shift and base in the lane's type; arg is the span. A row
// costs one bit test where the probe costs up to 17 dependent loads,
// whose addresses spread a warp over 32 cache lines past the first
// levels, so the probe waits on L2 latency and not on bytes.
// A program that is one join_bitmap node over one segment (J2.1's
// raw-key fact side) runs join_bitmap_kernel instead of the interpreter:
// a thread reads four keys as 16 bytes (two int64 keys a load), the next
// four in flight while it tests these, and stores their four mask bytes
// as one word. The bitmap's coarse level is staged in each block's
// shared memory, two blocks of 1,024 threads an SM, and a row reads the
// bitmap in L2 only where its coarse bit is set (at shift 0 the coarse
// level is the bitmap and nothing is read from L2): a warp's 128 random
// bit tests from L2 cost an L2 sector each, 240 MB of L2 reads over
// J2.1's 7.5M rows, where its part keys (5.6M values of span, shift 3)
// leave about 4% of the rows a coarse bit. The probe stays in the
// interpreter: the same four-rows-a-thread shape with its four
// lower-bound searches in step took 234.3 us at J2.1's shape against
// the interpreter's 234.2 (PERF.md), waiting on L2 either way.
// The host checks that the stack never holds more than 32 bits.
//
// The wide route (filter_wide_kernel), which the host takes where every
// leaf lane is 16-byte aligned, the rows are a multiple of 16, the
// program's distinct leaf lanes take at most kWideRowBytes bytes a row,
// its stack at most kWideDepth levels and the program fits shared memory
// (ops/kernels.py:filter_route); else the row route, the kernel above.
// The row kernel has one load of one byte outstanding a thread (a leaf
// reads its id when the interpreter reaches it and uses it at once),
// about 2 KB in flight an SM where HBM wants ~18 KB, and it interprets
// the program once a row: it ran at ~9x its bound. On the wide route:
// - each block step takes 8,192 rows, and the block copies the next
//   step's rows of every leaf lane into shared memory with 16-byte
//   cp.async copies (neighbouring threads on neighbouring chunks) while
//   it evaluates this one: 8,192 x the lanes' bytes a row in flight a
//   block;
// - a thread evaluates 32 rows (16 of each half of the step), and the
//   node loop runs once for them. A leaf's result is a level, one bit a
//   row, row r at bit 8 (r % 4) + r / 4; the stack is kWideDepth levels
//   in registers, and AND / OR fold levels, so a node costs a few
//   instructions for 32 rows;
// - a dictId leaf over an int8 lane (SSB's) compares four ids a word:
//   eq / neq / in / notin find the bytes equal to a constant without a
//   carry crossing bytes, range tests (id - lo) mod 256 < hi - lo on ids
//   biased to unsigned; the flags of word w (bit 7 of each byte) land in
//   the level with one shift, and word w of the mask is
//   (level >> w) & 0x01010101, the 32 mask bytes two 16-byte stores;
// - other leaves (int16 / int32 ids, raw, MV, ivf_probe, join) evaluate
//   row by row from the staged rows with the evaluators above;
// - a program that is an AND tree of int8 dictId and vdoc leaves (SSB
//   Q1's, WideArgs::and_tree, found on the host) skips the stack: the
//   leaves' byte flags are ANDed and packed into a level once
//   (and_tree_level), three packs and the stack's selects fewer on Q1.1;
//   it took 7% off the single Q1.1 and 14% off the batch at 8 members
//   (PERF.md, tools/ssb_kernel_bench.py);
// - a program of at most kInlineWords words comes in the launch's
//   parameters (a __grid_constant__ struct), not as a copy to the card;
// - the stacked form keeps the per-block seg_matched flush: a step's rows
//   never straddle two segments (seg_rows is a multiple of 8,192).
// What bounds it is still bytes: the row kernel's program copy and its
// interpretation once a row are gone (PERF.md has the times).
//
// Batched members (the counterpart of the vmap over a query axis in
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): up to 8
// queries of one compiled plan share the program's nodes and differ only
// in their parameters; member b's parameter block follows member b - 1's.
// The outputs are one mask row per member, [B][padded], and the members'
// match counts. What bounds a batch: bytes, the lanes read once and B mask
// rows written (SSB Q1.1 at 8 members: 82.5 MB, 24.6 us). Two routes, the
// single form's two (ops/kernels.py:filter_batched_route picks on the
// host, by shape):
// - wide (filter_wide_kernel<.., kBatched>), where the single form's wide
//   route takes the program's lanes and the program holds no ivf_probe,
//   join, raw or MV leaf (raw and MV leaves evaluate row by row here, once
//   a member, and at 8 members the row kernel, which reads a row once for
//   all of them, was the faster on both; a forced wide route runs them):
//   each block step stages the step's rows of every leaf lane
//   in shared memory once (the single route's cp.async staging, double
//   buffered), then evaluates the program over them once per member with
//   that member's parameter block, 32 rows a thread as levels, and stores
//   member b's 32 mask bytes as two 16-byte words at out + b * padded. The
//   lanes leave device memory once for all members and a thread holds one
//   member's stack at a time, the single route's register budget; the
//   batch adds B evaluations from shared memory, a few instructions a row
//   and member. Counts go per warp (__reduce_add_sync) into a shared
//   counter a member, added to matched once a block. The nodes and every
//   member's block ride in the launch's parameters up to kInlineWords
//   words (no copy to the card). Member-outer and not member-inner (one
//   pass over the nodes with B stacks of levels): member-inner would keep
//   B x kWideDepth levels live, 64 registers at 8 members, for no fewer
//   compares, since each member's constants differ;
// - rows (filter_mask_batched_kernel), the first design and the only one for
//   ivf_probe and join members: one thread evaluates one row for every
//   member: each leaf reads its lane element once and compares it with
//   each member's constants, and each member keeps its own bit stack in a
//   register. One byte load is outstanding a thread and the program is
//   interpreted once a row, which held it at 16x its bound on Q1.1.
// An ivf_probe leaf reads member b's probe ids and ok flags at row b of the
// [B][nprobe] lanes that the batched K9 wrote (the member takes the place
// of the segment of the stacked form). A join_raw leaf reads the row's key
// once and tests it against each member's own dim keys (members of one
// plan share Dp, not their keys) by one of two routes, which the host
// picks for the batch. Where the members' keys span at most 2^23 values
// (JOIN_MAP_MAX_SPAN) the node is a join_bits one: its lane is a byte
// for each key of the batch's range, bit b set where the key is among
// member b's, so a row costs one byte load for all members (8 MB at
// most, in L2). Otherwise it stays a join_raw node over the [B][Dp] lane
// of the members' sorted keys (K12 sorted each member's once for its
// query), and each member runs the single form's lower-bound probe: up to
// 17 dependent loads a member, whose keys stay in L2. A probe's loads
// touch as many cache lines as a warp has threads past the first levels,
// so 8 members' probes cost no less than 8 single launches; the member
// map is what makes the batch pay. Bit b of the member's stack takes
// whether the key is among its keys. Both replace the vmap of
// _eval_pred's join_raw branch (pinot_tpu/ops/kernels.py:118-130), which
// sorts each member's keys inside the launch.

#include "common.cuh"

namespace {

constexpr int kMaxLanes = 16;
constexpr int kMaxSmemWords = 12 * 1024;   // 48 KB: no opt-in needed
constexpr int kNodeWords = 6;
constexpr int kMaxMembers = 8;      // members of a batched launch

enum Op : int {
  kTrue = 0, kFalse = 1, kEq = 2, kNeq = 3, kRange = 4, kIn = 5,
  kNotIn = 6, kMember = 7, kAnd = 8, kOr = 9,
  kEqRaw = 10, kNeqRaw = 11, kRangeRaw = 12, kInRaw = 13, kNotInRaw = 14,
  kIvfProbe = 15, kVdoc = 16, kJoinRaw = 17, kJoinBits = 18, kJoinBitmap = 19,
};

// join_bitmap_kernel's blocks, two an SM: each stages a bitmap's coarse
// level of at most kJoinSmemBytes in shared memory (2 x (110 + 1) KB of
// the SM's 228)
constexpr int kJoinThreads = 1024;
constexpr int kJoinSmemBytes = 110 * 1024;

using pinot::kF32;
using pinot::kI32;
using pinot::kI64;
using pinot::read_id;

struct Lanes {
  const void* ptr[kMaxLanes];
};

__device__ __forceinline__ unsigned eval_id(int op, int v, const int* p, int arg) {
  switch (op) {
    case kEq: return v == p[0];
    case kNeq: return v != p[0];
    case kRange: return v >= p[0] && v < p[1];
    case kIn:
    case kNotIn: {
      unsigned hit = 0u;
      for (int i = 0; i < arg; ++i) hit |= (v == p[i]);
      return op == kIn ? hit : (hit ^ 1u);
    }
    default: {  // kMember: bitset over [0, card_pad), index clipped
      const int idx = min(max(v, 0), arg - 1);
      return (static_cast<unsigned>(p[idx >> 5]) >> (idx & 31)) & 1u;
    }
  }
}

// A raw constant from the parameter words; 8-byte values are assembled
// from two 4-byte words, since the parameter area is only 4-byte aligned.
template <typename T>
__device__ __forceinline__ T param(const int* p);
template <> __device__ __forceinline__ int32_t param<int32_t>(const int* p) { return p[0]; }
template <> __device__ __forceinline__ float param<float>(const int* p) {
  return __int_as_float(p[0]);
}
template <> __device__ __forceinline__ long long param<long long>(const int* p) {
  return static_cast<long long>(static_cast<unsigned long long>(static_cast<unsigned>(p[0])) |
                                (static_cast<unsigned long long>(static_cast<unsigned>(p[1])) << 32));
}
template <> __device__ __forceinline__ double param<double>(const int* p) {
  return __longlong_as_double(param<long long>(p));
}

template <typename T>
__device__ __forceinline__ unsigned eval_raw(int op, T v, const int* p, int arg) {
  constexpr int w = sizeof(T) / sizeof(int);     // words per constant
  switch (op) {
    case kEqRaw: return v == param<T>(p);
    case kNeqRaw: return v != param<T>(p);
    case kRangeRaw: {
      const T lo = param<T>(p), hi = param<T>(p + w);
      const bool ml = (arg & 1) ? v >= lo : v > lo;
      const bool mh = (arg & 2) ? v <= hi : v < hi;
      return ml && mh;
    }
    default: {  // kInRaw / kNotInRaw
      unsigned hit = 0u;
      for (int i = 0; i < arg; ++i) hit |= (v == param<T>(p + i * w));
      return op == kInRaw ? hit : (hit ^ 1u);
    }
  }
}

// ivf_probe: the row's coarse cell (its IVF assignment, a narrow id) is in
// its segment's probe list and that slot is ok, the in_ids compare form of
// _eval_ivf_probe (:161). p[0] and p[1] index the lane table: K9's probe
// ids int32 [S][nprobe] and ok flags uint8 [S][nprobe]; arg = nprobe.
__device__ __forceinline__ unsigned eval_probe(const void* const* lanes, const void* lane,
                                               int elem, long long row, long long seg,
                                               const int* p, int arg) {
  const int a = read_id(lane, elem, row);
  const int* ids = static_cast<const int*>(lanes[p[0]]) + seg * arg;
  const uint8_t* ok = static_cast<const uint8_t*>(lanes[p[1]]) + seg * arg;
  unsigned hit = 0u;
  for (int i = 0; i < arg; ++i) hit |= static_cast<unsigned>(a == ids[i] && ok[i] != 0);
  return hit;
}

// join_raw: the row's key is among the dim side's sorted keys, the lane
// p[0] of the lane table, arg of them
__device__ __forceinline__ unsigned eval_join(const void* const* lanes, const void* lane,
                                              int elem, long long row, const int* p, int arg) {
  if (elem == kI64) {
    const long long* sk = static_cast<const long long*>(lanes[p[0]]);
    const long long v = static_cast<const long long*>(lane)[row];
    return sk[pinot::probe_position(sk, arg, v)] == v;
  }
  const int32_t* sk = static_cast<const int32_t*>(lanes[p[0]]);
  const int32_t v = static_cast<const int32_t*>(lane)[row];
  return sk[pinot::probe_position(sk, arg, v)] == v;
}

// join_bitmap: key v is in the bitmap `bits` over [base, base + span)
template <typename T>
__device__ __forceinline__ unsigned bitmap_hit(const unsigned* bits, T base, long long span, T v) {
  const unsigned long long off =
      static_cast<unsigned long long>(v) - static_cast<unsigned long long>(base);
  return v >= base && off < static_cast<unsigned long long>(span)
             ? (bits[off >> 5] >> (off & 31)) & 1u
             : 0u;
}

// join_bitmap: p[0] indexes the lane table's bitmap words (p[1] its
// coarse level, p[2] the shift: join_bitmap_kernel's), p[3] (one or two
// words) holds base in the lane's type, arg is the span
__device__ __forceinline__ unsigned eval_join_bitmap(const void* const* lanes, const void* lane,
                                                     int elem, long long row, const int* p,
                                                     int arg) {
  const unsigned* bits = static_cast<const unsigned*>(lanes[p[0]]);
  if (elem == kI64)
    return bitmap_hit(bits, param<long long>(p + 3), arg,
                      static_cast<const long long*>(lane)[row]);
  return bitmap_hit(bits, param<int32_t>(p + 3), arg, static_cast<const int32_t*>(lane)[row]);
}

__device__ __forceinline__ unsigned eval_leaf(const void* lane, int op, int elem,
                                              int width, long long row,
                                              const int* p, int arg) {
  if (op < kEqRaw) {
    if (width == 1) return eval_id(op, read_id(lane, elem, row), p, arg);
    // dictId leaf over an MV lane: the row matches when any entry does
    const long long base = row * width;
    unsigned bit = 0u;
    for (int j = 0; j < width; ++j)
      bit |= eval_id(op, read_id(lane, elem, base + j), p, arg);
    return bit;
  }
  switch (elem) {
    case kI32: return eval_raw<int32_t>(op, static_cast<const int32_t*>(lane)[row], p, arg);
    case kI64: return eval_raw<long long>(op, static_cast<const long long*>(lane)[row], p, arg);
    case kF32: return eval_raw<float>(op, static_cast<const float*>(lane)[row], p, arg);
    default: return eval_raw<double>(op, static_cast<const double*>(lane)[row], p, arg);
  }
}

// kGeneral = false: every leaf is a dictId leaf over an SV lane, the
// common case, compiled without the raw and MV paths so that it keeps
// few registers (a full wave of 8 blocks per SM). kStacked: segments of
// seg_rows rows with seg_docs live rows each, matches counted into
// seg_matched.
template <bool kGeneral, bool kStacked>
__global__ void filter_mask_kernel(Lanes lanes, const int* __restrict__ prog,
                                   int n_nodes, int n_words, int staged,
                                   long long padded, long long seg_rows,
                                   const int* __restrict__ seg_docs,
                                   long long num_docs, uint8_t* __restrict__ out,
                                   int* __restrict__ seg_matched) {
  extern __shared__ int smem[];
  __shared__ int scratch[32];
  // lane pointers in shared memory: indexing the parameter struct by a
  // value read at run time makes every thread copy it to local memory
  __shared__ const void* s_lanes[kMaxLanes];
  if (threadIdx.x < kMaxLanes) {
#pragma unroll
    for (int i = 0; i < kMaxLanes; ++i)
      if (threadIdx.x == i) s_lanes[i] = lanes.ptr[i];
  }
  const int* buf = prog;
  if (staged) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) smem[i] = prog[i];
    buf = smem;
  }
  __syncthreads();
  const int* params = buf + kNodeWords * n_nodes;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the segment of this thread's row, its end and its live end; a division
  // only when the rows move to another segment
  long long seg = 0, seg_end = padded, live_end = num_docs;
  int count = 0;
  auto enter = [&]() {
    seg = row / seg_rows;
    seg_end = (seg + 1) * seg_rows;
    live_end = seg * seg_rows + seg_docs[seg];
  };
  // block-uniform: every thread of the block calls it at the same point
  auto flush = [&]() {
    const int c = pinot::block_sum(count, scratch);
    if (threadIdx.x == 0 && c != 0) atomicAdd(seg_matched + seg, c);
    count = 0;
  };
  if constexpr (kStacked) enter();
  for (; row < padded; row += step) {
    if constexpr (kStacked) {
      if (row >= seg_end) {
        flush();
        enter();
      }
    }
    unsigned stack = 0u;
    if (row < live_end) {
      for (int n = 0; n < n_nodes; ++n) {
        const int* node = buf + kNodeWords * n;
        const int op = node[0], arg = node[3];
        unsigned bit;
        if (op == kAnd || op == kOr) {
          const unsigned m = (1u << arg) - 1u;
          const unsigned kids = stack & m;
          stack >>= arg;
          bit = op == kAnd ? (kids == m) : (kids != 0u);
        } else if (op == kTrue) {
          bit = 1u;
        } else if (op == kFalse) {
          bit = 0u;
        } else if (op == kVdoc) {
          bit = static_cast<const uint8_t*>(s_lanes[node[1]])[row] != 0 ? 1u : 0u;
        } else {
          const void* lane = s_lanes[node[1]];
          if constexpr (kGeneral)
            bit = op == kIvfProbe
                      ? eval_probe(s_lanes, lane, node[4], row, seg, params + node[2], arg)
                  : op == kJoinRaw
                      ? eval_join(s_lanes, lane, node[4], row, params + node[2], arg)
                  : op == kJoinBitmap
                      ? eval_join_bitmap(s_lanes, lane, node[4], row, params + node[2], arg)
                      : eval_leaf(lane, op, node[4], node[5], row, params + node[2], arg);
          else
            bit = eval_id(op, read_id(lane, node[4], row), params + node[2], arg);
        }
        stack = (stack << 1) | bit;
      }
    }
    out[row] = static_cast<uint8_t>(stack & 1u);
    if constexpr (kStacked) count += static_cast<int>(stack & 1u);
  }
  if constexpr (kStacked) flush();
}

// -- the wide route ---------------------------------------------------------

constexpr int kWideRows = 32;                          // rows a thread
constexpr int kWideTile = kWideRows * pinot::kThreads;   // rows a block step
constexpr int kWideRowBytes = 8;      // leaf lanes' bytes a row, at most
constexpr int kWideDepth = 8;         // stack levels, at most
constexpr int kInlineWords = 256;     // program words in the parameter buffer
constexpr unsigned kHigh = 0x80808080u;  // bit 7 of each byte

// The wide route's launch parameters: the bytes a row of each leaf lane
// (lanes 0 .. n_row_lanes - 1 of the lane table; the rest are read by
// index, not by row) and, for a program of at most kInlineWords words,
// the program itself.
struct WideArgs {
  int n_row_lanes;
  int row_bytes[kMaxLanes];
  int n_inline;                       // words in `words`; 0: `prog` on the card
  int and_tree;                       // the program is an AND tree (and_tree_level)
  int words[kInlineWords];
};

// A level is one bit for each of a thread's 32 rows, row r at bit
// 8 (r % 4) + r / 4: the flags of the four rows of a 4-byte word w (bit 7
// of each byte) land at bits w, 8 + w, 16 + w, 24 + w with one shift, and
// word w of the mask is (level >> w) & 0x01010101.
__device__ __forceinline__ int level_bit(int r) { return 8 * (r & 3) + (r >> 2); }

// bit 7 of each byte of w that is nonzero (no carry crosses a byte)
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & kHigh;
}

// a thread's 32 staged bytes of a one-byte lane (rows 0-15 at lo, 16-31
// at hi) as 8 words
__device__ __forceinline__ void load_words(const uint8_t* lo, const uint8_t* hi,
                                           unsigned (&w)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(lo);
  const uint4 b = *reinterpret_cast<const uint4*>(hi);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ unsigned pack_flags(const unsigned (&f)[8]) {
  unsigned lvl = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) lvl |= f[k] >> (7 - k);
  return lvl;
}

// A dictId leaf over an int8 SV lane, four rows a word: eq / neq / in /
// notin compare bytes with a constant (a constant outside int8 matches no
// id); range [lo, hi) clips to the int8 domain, biases the bytes to
// unsigned and tests (u - lo) mod 256 < hi - lo byte by byte. As eval_id.
// i8_flags leaves each row's result in bit 7 of its byte of the 8 words
// (kHigh), i8_level packs them into a level.
__device__ __forceinline__ void i8_flags(int op, const unsigned (&w)[8], const int* p, int arg,
                                         unsigned (&f)[8]) {
  if (op == kRange) {
    const int lo = max(p[0], -128), hi = min(p[1], 128);
    const unsigned all = lo >= hi ? 0u : hi - lo == 256 ? kHigh : 1u;
    if (all != 1u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = all;
      return;
    }
    const unsigned l4 = static_cast<unsigned>(lo + 128) * 0x01010101u;
    const unsigned e4 = static_cast<unsigned>(256 - (hi - lo)) * 0x01010101u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned u = w[k] ^ kHigh;                // int8 -> biased uint8
      const unsigned d = ((u | kHigh) - (l4 & ~kHigh)) ^ ((u ^ ~l4) & kHigh);  // u - lo
      const unsigned s = (d & ~kHigh) + (e4 & ~kHigh);
      // d + (256 - (hi - lo)) carries out of a byte iff d >= hi - lo: the
      // carry out of bit 7 is the majority of d's, e4's and s's bit 7
      const unsigned ge = ((d & e4) | ((d | e4) & s)) & kHigh;
      f[k] = ge ^ kHigh;
    }
    return;
  }
  const int n = op == kEq || op == kNeq ? 1 : arg;
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = 0u;
  for (int i = 0; i < n; ++i) {
    const int c = p[i];
    if (c < -128 || c > 127) continue;
    const unsigned c4 = static_cast<unsigned>(c & 0xff) * 0x01010101u;
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] |= nonzero_bytes(w[k] ^ c4) ^ kHigh;
  }
  if (op == kNeq || op == kNotIn) {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] ^= kHigh;
  }
}

__device__ __forceinline__ unsigned i8_level(int op, const uint8_t* lo, const uint8_t* hi,
                                             const int* p, int arg) {
  unsigned w[8], f[8];
  load_words(lo, hi, w);
  i8_flags(op, w, p, arg, f);
  return pack_flags(f);
}

// the vdoc leaf: each row's liveness byte != 0
__device__ __forceinline__ unsigned live_level(const uint8_t* lo, const uint8_t* hi) {
  unsigned w[8], f[8];
  load_words(lo, hi, w);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = nonzero_bytes(w[k]);
  return pack_flags(f);
}

// fn(id) over a thread's 32 staged ids of type T (rows 0-15 at lo, 16-31
// at hi), as a level
template <typename T, typename F>
__device__ __forceinline__ unsigned ids_level(const uint8_t* lo, const uint8_t* hi, F fn) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // ids a 16-byte word
  unsigned lvl = 0u;
#pragma unroll
  for (int c = 0; c < kWideRows / kPer; ++c) {
    const int half = c / (16 / kPer);
    const uint4 q = reinterpret_cast<const uint4*>(half ? hi : lo)[c % (16 / kPer)];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const unsigned word = w[i * static_cast<int>(sizeof(T)) / 4];
      const int sh = (i * static_cast<int>(sizeof(T)) % 4) * 8;
      int v;
      if constexpr (sizeof(T) == 1)
        v = static_cast<int8_t>(word >> sh);
      else if constexpr (sizeof(T) == 2)
        v = static_cast<int16_t>(word >> sh);
      else
        v = static_cast<int>(word);
      lvl |= static_cast<unsigned>(fn(v)) << level_bit(c * kPer + i);
    }
  }
  return lvl;
}

// A dictId leaf over an SV lane of type T, row by row: eval_id's kinds,
// the compare of each kind outside the unrolled rows
template <typename T>
__device__ __forceinline__ unsigned id_level_t(int op, const uint8_t* lo, const uint8_t* hi,
                                               const int* p, int arg) {
  switch (op) {
    case kEq: {
      const int c = p[0];
      return ids_level<T>(lo, hi, [c](int v) { return v == c; });
    }
    case kNeq: {
      const int c = p[0];
      return ids_level<T>(lo, hi, [c](int v) { return v != c; });
    }
    case kRange: {
      const int a = p[0], b = p[1];
      return ids_level<T>(lo, hi, [a, b](int v) { return v >= a && v < b; });
    }
    case kIn:
    case kNotIn: {
      unsigned lvl = 0u;
      for (int i = 0; i < arg; ++i) {
        const int c = p[i];
        lvl |= ids_level<T>(lo, hi, [c](int v) { return v == c; });
      }
      return op == kIn ? lvl : ~lvl;
    }
    default:  // kMember: bitset over [0, card_pad), index clipped
      return ids_level<T>(lo, hi, [p, arg](int v) {
        const int idx = min(max(v, 0), arg - 1);
        return (static_cast<unsigned>(p[idx >> 5]) >> (idx & 31)) & 1u;
      });
  }
}

__device__ __forceinline__ unsigned id_level(int op, int elem, const uint8_t* lo,
                                             const uint8_t* hi, const int* p, int arg) {
  if (elem == pinot::kI8) {
    if (op != kMember) return i8_level(op, lo, hi, p, arg);
    return id_level_t<int8_t>(op, lo, hi, p, arg);
  }
  if (elem == pinot::kI16) return id_level_t<int16_t>(op, lo, hi, p, arg);
  return id_level_t<int32_t>(op, lo, hi, p, arg);
}

// The program over a thread's 32 staged rows of one block step, as a level
// (row r at level_bit(r)), with the parameters at `params`: the node loop
// of filter_wide_kernel. The stack is kWideDepth levels in registers, the
// top at `sp` (the same in every thread): a leaf writes level sp, an AND /
// OR of k children combines levels sp - k .. sp - 1 into level sp - k.
// `seg` indexes an ivf_probe node's [S][nprobe] lanes.
template <bool kGeneral>
__device__ __forceinline__ unsigned wide_level(const int* buf, int n_nodes,
                                               const int* params, const uint8_t* st,
                                               const int* s_off, const int* s_rb,
                                               const void* const* s_lanes, long long seg) {
  constexpr int kHalf = kWideTile / 2;
  unsigned lv[kWideDepth];
#pragma unroll
  for (int i = 0; i < kWideDepth; ++i) lv[i] = 0u;
  int sp = 0;
  for (int n = 0; n < n_nodes; ++n) {
    const int* node = buf + kNodeWords * n;
    const int op = node[0], arg = node[3];
    unsigned v;
    if (op == kAnd || op == kOr) {
      sp -= arg;
      v = op == kAnd ? ~0u : 0u;
#pragma unroll
      for (int i = 0; i < kWideDepth; ++i)
        if (i >= sp && i < sp + arg) v = op == kAnd ? v & lv[i] : v | lv[i];
    } else if (op == kTrue) {
      v = ~0u;
    } else if (op == kFalse) {
      v = 0u;
    } else {
      const int lane = node[1], elem = node[4], width = node[5], rb = s_rb[lane];
      const uint8_t* lo = st + s_off[lane] + threadIdx.x * 16 * rb;
      const uint8_t* hi = lo + kHalf * rb;
      const int* p = params + node[2];
      if (op == kVdoc) {
        v = live_level(lo, hi);
      } else if (!kGeneral || (op < kEqRaw && width == 1)) {
        v = id_level(op, elem, lo, hi, p, arg);
      } else {
        v = 0u;
#pragma unroll 4
        for (int r = 0; r < kWideRows; ++r) {
          const uint8_t* rows = r < 16 ? lo : hi;
          const int i = r & 15;
          unsigned bit;
          if (op == kIvfProbe)
            bit = eval_probe(s_lanes, rows, elem, i, seg, p, arg);
          else if (op == kJoinRaw)
            bit = eval_join(s_lanes, rows, elem, i, p, arg);
          else if (op == kJoinBitmap)
            bit = eval_join_bitmap(s_lanes, rows, elem, i, p, arg);
          else
            bit = eval_leaf(rows, op, elem, width, i, p, arg);
          v |= bit << level_bit(r);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWideDepth; ++i)
      if (i == sp) lv[i] = v;
    ++sp;
  }
  return lv[0];
}

// An AND tree of int8 dictId leaves (eq / neq / range / in / notin), vdoc
// leaves, true and false (WideArgs::and_tree, the SSB Q1 programs): the
// AND of every leaf's byte flags over a thread's 32 staged rows, packed
// into a level once, with no stack and no level a leaf.
__device__ __forceinline__ unsigned and_tree_level(const int* buf, int n_nodes,
                                                   const int* params, const uint8_t* st,
                                                   const int* s_off) {
  constexpr int kHalf = kWideTile / 2;
  unsigned f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = kHigh;
  for (int n = 0; n < n_nodes; ++n) {
    const int* node = buf + kNodeWords * n;
    const int op = node[0];
    if (op == kAnd || op == kTrue) continue;
    unsigned g[8];
    if (op == kFalse) {
#pragma unroll
      for (int k = 0; k < 8; ++k) g[k] = 0u;
    } else {
      const uint8_t* lo = st + s_off[node[1]] + threadIdx.x * 16;   // a byte a row
      unsigned w[8];
      load_words(lo, lo + kHalf, w);
      if (op == kVdoc) {
#pragma unroll
        for (int k = 0; k < 8; ++k) g[k] = nonzero_bytes(w[k]);
      } else {
        i8_flags(op, w, params + node[2], node[3], g);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] &= g[k];
  }
  return pack_flags(f);
}

// kGeneral and kStacked as filter_mask_kernel's; kBatched: nb members of
// one plan over one segment, member b's parameter block pw words after
// member b - 1's, its mask row at out + b * padded and its matches added
// into seg_matched[b]. Each block step takes kWideTile rows; thread t owns
// rows [16 t, 16 t + 16) of the step's first half and the same of its
// second (its rows 0-15 and 16-31), so that a warp's stores of its mask
// bytes, and its reads of an int8 lane from shared memory, cover
// contiguous bytes. The staging area holds two steps, lane l's rows at
// s_off[l] in row order (kWideTile x its bytes a row); the block copies a
// step's rows with 16-byte cp.async copies, neighbouring threads on
// neighbouring chunks, while it evaluates the step before (one
// __syncthreads a step). A batch evaluates the staged step once for each
// member (wide_level), so the lanes are read from device memory once for
// all of them and a thread holds one member's stack at a time.
template <bool kGeneral, bool kStacked, bool kBatched>
__global__ void __launch_bounds__(pinot::kThreads, 1)
    filter_wide_kernel(Lanes lanes, const __grid_constant__ WideArgs wa,
                       const int* __restrict__ prog, int n_nodes, int n_words, int nb, int pw,
                       long long padded, long long seg_rows,
                       const int* __restrict__ seg_docs, long long num_docs,
                       uint8_t* __restrict__ out, int* __restrict__ seg_matched) {
  extern __shared__ __align__(16) uint8_t wsmem[];
  __shared__ int scratch[32];
  __shared__ const void* s_lanes[kMaxLanes];
  __shared__ int s_off[kMaxLanes], s_rb[kMaxLanes], s_stage;
  __shared__ int s_count[kMaxMembers];    // a batch's matches, this block's
  if (threadIdx.x < kMaxLanes) {
#pragma unroll
    for (int i = 0; i < kMaxLanes; ++i)
      if (threadIdx.x == i) s_lanes[i] = lanes.ptr[i];
  }
  if (threadIdx.x < kMaxMembers) s_count[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    int off = 0;
    for (int l = 0; l < wa.n_row_lanes; ++l) {
      s_off[l] = off;
      s_rb[l] = wa.row_bytes[l];
      off += kWideTile * wa.row_bytes[l];
    }
    s_stage = off;
  }
  int* buf = reinterpret_cast<int*>(wsmem);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    buf[i] = wa.n_inline ? wa.words[i] : prog[i];
  __syncthreads();
  uint8_t* const stages = wsmem + ((n_words * 4 + 15) & ~15);
  const int stage_bytes = s_stage, n_row_lanes = wa.n_row_lanes;
  const int* params = buf + kNodeWords * n_nodes;
  const long long n_tiles = (padded + kWideTile - 1) / kWideTile;

  // the rows of block step `tile` of every leaf lane into stage s, as
  // one group: thread t copies 16-byte chunks t, t + 256, ... of each
  // lane's rows
  auto issue = [&](long long tile, int s) {
    if (tile < n_tiles) {
      const long long first = tile * kWideTile;
      const long long rows = min(static_cast<long long>(kWideTile), padded - first);
      uint8_t* st = stages + s * stage_bytes;
      for (int l = 0; l < n_row_lanes; ++l) {
        const int rb = s_rb[l];
        const uint8_t* src = static_cast<const uint8_t*>(s_lanes[l]) + first * rb;
        uint8_t* dst = st + s_off[l];
        const int chunks = static_cast<int>(rows * rb / 16);
        for (int c = threadIdx.x; c < chunks; c += pinot::kThreads)
          pinot::cp_async16(dst + 16 * c, src + 16 * c);
      }
    }
    pinot::cp_async_commit();
  };

  long long seg = kStacked ? -1 : 0, live_end = num_docs;
  int count = 0;
  // block-uniform: every thread of the block calls it at the same point
  auto flush = [&]() {
    const int c = pinot::block_sum(count, scratch);
    if (threadIdx.x == 0 && c != 0) atomicAdd(seg_matched + seg, c);
    count = 0;
  };

  int cur = 0;
  issue(blockIdx.x, cur);
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    pinot::cp_async_wait<0>();          // this thread's copies of `tile`
    // ... and every other thread's; every thread is done with the stage
    // the next copies overwrite
    __syncthreads();
    issue(tile + gridDim.x, cur ^ 1);
    if constexpr (kStacked) {
      const long long s = tile * kWideTile / seg_rows;
      if (s != seg) {
        if (seg >= 0) flush();
        seg = s;
        live_end = s * seg_rows + seg_docs[s];
      }
    }
    // this thread's two halves: rows row0 + [0, 16) and row0 + kHalf + [0, 16)
    constexpr int kHalf = kWideTile / 2;
    const long long row0 = tile * kWideTile + threadIdx.x * 16;
    const bool live = row0 < padded && row0 < live_end;
    unsigned keep = ~0u;                // the rows before live_end
    if (live && row0 + kHalf + 16 > live_end) {
      keep = 0u;
      for (int r = 0; r < kWideRows; ++r)
        if (row0 + (r < 16 ? r : kHalf + r - 16) < live_end) keep |= 1u << level_bit(r);
    }
    const uint8_t* st = stages + cur * stage_bytes;
    for (int b = 0; b < (kBatched ? nb : 1); ++b) {
      unsigned res = 0u;
      if (live) {
        if (wa.and_tree)
          res = and_tree_level(buf, n_nodes, params + b * pw, st, s_off) & keep;
        else
          res = wide_level<kGeneral>(buf, n_nodes, params + b * pw, st, s_off, s_rb, s_lanes,
                                     kBatched ? b : seg) &
                keep;
      }
      if (row0 < padded) {
        uint8_t* o = out + b * padded + row0;
        uint4 w;
        w.x = res & 0x01010101u;
        w.y = (res >> 1) & 0x01010101u;
        w.z = (res >> 2) & 0x01010101u;
        w.w = (res >> 3) & 0x01010101u;
        *reinterpret_cast<uint4*>(o) = w;
        if (row0 + kHalf < padded) {
          w.x = (res >> 4) & 0x01010101u;
          w.y = (res >> 5) & 0x01010101u;
          w.z = (res >> 6) & 0x01010101u;
          w.w = (res >> 7) & 0x01010101u;
          *reinterpret_cast<uint4*>(o + kHalf) = w;
        }
      }
      if constexpr (kStacked) count += __popc(res);
      if constexpr (kBatched) {
        // the warp's matches of member b, one shared atomic a warp
        const int c = static_cast<int>(__reduce_add_sync(0xffffffffu, __popc(res)));
        if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(s_count + b, c);
      }
    }
    cur ^= 1;
  }
  pinot::cp_async_wait<0>();
  if constexpr (kStacked) {
    if (seg >= 0) flush();
  }
  if constexpr (kBatched) {
    __syncthreads();
    if (threadIdx.x < nb && s_count[threadIdx.x] != 0)
      atomicAdd(seg_matched + threadIdx.x, s_count[threadIdx.x]);
  }
}

// The stack depth a program reaches (its nodes in host memory), as
// compile_filter counts it.
int program_depth(const int* prog, int n_nodes) {
  int depth = 0, most = 0;
  for (int n = 0; n < n_nodes; ++n) {
    const int op = prog[kNodeWords * n];
    depth += 1 - (op == kAnd || op == kOr ? prog[kNodeWords * n + 3] : 0);
    most = depth > most ? depth : most;
  }
  return most;
}

// The wide route's launch parameters for a program in host memory over the
// leaf lanes 0 .. n_row_lanes - 1, row_bytes each a row; false where the
// route cannot take it (lanes or out not 16-byte aligned, rows not a
// multiple of 16, more than kWideRowBytes a row, a stack deeper than
// kWideDepth, a program past shared memory or, with prog null, past
// kInlineWords words). A program of at most kInlineWords words rides in the
// parameters; and_tree says whether and_tree_level can evaluate it.
bool wide_args(const void* const* lane_ptrs, int n_lanes, const int* host_prog, int n_nodes,
               int n_words, const int* prog, const int* row_bytes, int n_row_lanes,
               long long padded, const void* out, WideArgs& wa) {
  if (n_row_lanes < 0 || n_row_lanes > n_lanes || padded % 16 != 0 || n_words > kMaxSmemWords ||
      host_prog == nullptr || program_depth(host_prog, n_nodes) > kWideDepth ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return false;
  wa.n_row_lanes = n_row_lanes;
  int total = 0;
  for (int l = 0; l < n_row_lanes; ++l) {
    if (row_bytes[l] < 1 || reinterpret_cast<uintptr_t>(lane_ptrs[l]) % 16 != 0) return false;
    wa.row_bytes[l] = row_bytes[l];
    total += row_bytes[l];
  }
  if (total > kWideRowBytes) return false;
  wa.and_tree = 1;
  for (int n = 0; n < n_nodes; ++n) {
    const int* node = host_prog + kNodeWords * n;
    const int op = node[0];
    const bool i8 = (op == kEq || op == kNeq || op == kRange || op == kIn || op == kNotIn) &&
                    node[4] == pinot::kI8 && node[5] == 1;
    if (!(i8 || op == kVdoc || op == kAnd || op == kTrue || op == kFalse)) wa.and_tree = 0;
  }
  if (n_words <= kInlineWords) {
    wa.n_inline = n_words;
    for (int i = 0; i < n_words; ++i) wa.words[i] = host_prog[i];
  } else if (prog == nullptr) {
    return false;
  }
  return true;
}

// Launches filter_wide_kernel: one full wave of blocks at the occupancy
// its registers and shared memory (the program and two staging steps)
// allow, at most the rows' block steps.
cudaError_t launch_wide(bool general, bool stacked, bool batched, const Lanes& lanes,
                        const WideArgs& wa, const int* prog, int n_nodes, int n_words, int nb,
                        int pw, long long padded, long long seg_rows, const int* seg_docs,
                        long long num_docs, uint8_t* out, int* seg_matched, cudaStream_t stream) {
  int row_bytes = 0;
  for (int l = 0; l < wa.n_row_lanes; ++l) row_bytes += wa.row_bytes[l];
  const size_t smem = static_cast<size_t>((n_words * 4 + 15) & ~15) +
                      2 * static_cast<size_t>(kWideTile) * row_bytes;
  const auto kernel =
      batched ? (general ? filter_wide_kernel<true, false, true>
                         : filter_wide_kernel<false, false, true>)
      : general ? (stacked ? filter_wide_kernel<true, true, false>
                           : filter_wide_kernel<true, false, false>)
                : (stacked ? filter_wide_kernel<false, true, false>
                           : filter_wide_kernel<false, false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t rc = pinot::allow_dynamic_smem(kernel, smem);
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<pinot::grid_for(kernel, (padded + kWideRows - 1) / kWideRows, smem), pinot::kThreads,
           smem, stream>>>(
      lanes, wa, prog, n_nodes, n_words, nb, pw, padded, seg_rows, seg_docs, num_docs, out,
      seg_matched);
  return cudaGetLastError();
}


// Four keys from row r (r % 4 == 0, the lane 16-byte aligned).
__device__ __forceinline__ void load_keys(const int32_t* lane, long long r, int32_t (&k)[4]) {
  const int4 v = *reinterpret_cast<const int4*>(lane + r);
  k[0] = v.x;
  k[1] = v.y;
  k[2] = v.z;
  k[3] = v.w;
}
__device__ __forceinline__ void load_keys(const long long* lane, long long r, long long (&k)[4]) {
  const longlong2 a = *reinterpret_cast<const longlong2*>(lane + r);
  const longlong2 b = *reinterpret_cast<const longlong2*>(lane + r + 2);
  k[0] = a.x;
  k[1] = a.y;
  k[2] = b.x;
  k[3] = b.y;
}

// A program of one join_bitmap node over one segment: mask bytes of four
// rows a thread and step, stored as one word. The node and its
// parameters are read from the program on the card (every thread the
// same words). The bitmap's coarse level is staged in shared memory
// while each thread's first keys load; a key whose coarse bit is set
// reads its bit of the bitmap (at shift 0 the coarse bit is the answer).
template <typename T>
__global__ void __launch_bounds__(kJoinThreads, 2)
    join_bitmap_kernel(Lanes lanes, const int* __restrict__ prog, long long padded,
                       long long num_docs, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned s_coarse[];
  const int* p = prog + kNodeWords;
  const T* keys = static_cast<const T*>(lanes.ptr[prog[1]]);
  const int span = prog[3];
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  T k[4] = {};
  if (r < padded) load_keys(keys, r, k);
  const unsigned* bits = static_cast<const unsigned*>(lanes.ptr[p[0]]);
  const uint4* coarse = static_cast<const uint4*>(lanes.ptr[p[1]]);
  const int shift = p[2];
  const T base = param<T>(p + 3);
  const int n4 = (((span - 1) >> shift) + 128) >> 7;   // padded to 4 words
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<uint4*>(s_coarse)[i] = coarse[i];
  __syncthreads();
  for (; r < padded; r += step) {
    T next[4] = {};
    if (r + step < padded) load_keys(keys, r + step, next);
    unsigned word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned long long off =
          static_cast<unsigned long long>(k[j]) - static_cast<unsigned long long>(base);
      const unsigned long long c = off >> shift;
      unsigned hit = k[j] >= base && off < static_cast<unsigned long long>(span)
                         ? (s_coarse[c >> 5] >> (c & 31)) & 1u
                         : 0u;
      if (hit && shift > 0) hit = (bits[off >> 5] >> (off & 31)) & 1u;
      if (r + j < num_docs) word |= hit << (8 * j);
    }
    *reinterpret_cast<unsigned*>(out + r) = word;
#pragma unroll
    for (int j = 0; j < 4; ++j) k[j] = next[j];
  }
}

// Launches join_bitmap_kernel<T>: one full wave of blocks, at most the
// rows' quads.
template <typename T>
cudaError_t launch_join_bitmap(const Lanes& lanes, const int* prog, long long padded,
                               long long num_docs, int smem_bytes, uint8_t* out,
                               cudaStream_t stream) {
  const auto kernel = join_bitmap_kernel<T>;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (smem > 48 * 1024) {
    const cudaError_t rc = pinot::allow_dynamic_smem(kernel, smem);
    if (rc != cudaSuccess) return rc;
  }
  int device = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kJoinThreads, smem) !=
          cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long quads = padded / 4;
  long long blocks = (quads + kJoinThreads - 1) / kJoinThreads;
  if (blocks > static_cast<long long>(sms) * per_sm) blocks = static_cast<long long>(sms) * per_sm;
  kernel<<<static_cast<int>(blocks < 1 ? 1 : blocks), kJoinThreads, smem, stream>>>(
      lanes, prog, padded, num_docs, out);
  return cudaGetLastError();
}

// One leaf for every member: the lane element (a [width] row for an MV
// lane) is read once; member b's constants are at p + b * pw.
template <bool kGeneral>
__device__ __forceinline__ void eval_leaf_members(const void* const* lanes, const void* lane,
                                                  int op, int elem, int width, long long row,
                                                  const int* p, int pw, int arg, int nb,
                                                  unsigned* bits) {
  if constexpr (kGeneral) {
    if (op == kIvfProbe) {
      const int a = read_id(lane, elem, row);
#pragma unroll
      for (int b = 0; b < kMaxMembers; ++b) {
        if (b >= nb) break;
        const int* ids = static_cast<const int*>(lanes[p[0]]) + b * arg;
        const uint8_t* ok = static_cast<const uint8_t*>(lanes[p[1]]) + b * arg;
        unsigned hit = 0u;
        for (int i = 0; i < arg; ++i) hit |= static_cast<unsigned>(a == ids[i] && ok[i] != 0);
        bits[b] = hit;
      }
      return;
    }
    if (op == kJoinBits) {
      // p[0]: the uint8 [arg] member map over the key range from p[1] (a
      // constant in the lane's type): bit b of byte off is set iff
      // base + off is among member b's keys. One load serves every member
#define PINOT_JOIN_BITS(T)                                                 \
  {                                                                        \
    const T v = static_cast<const T*>(lane)[row];                          \
    const T base = param<T>(p + 1);                                        \
    const unsigned long long off =                                         \
        static_cast<unsigned long long>(v) - static_cast<unsigned long long>(base); \
    const unsigned m = v >= base && off < static_cast<unsigned long long>(arg) \
                           ? static_cast<const uint8_t*>(lanes[p[0]])[off] : 0u; \
    _Pragma("unroll") for (int b = 0; b < kMaxMembers; ++b) bits[b] = (m >> b) & 1u; \
    return;                                                                \
  }
      if (elem == kI64) PINOT_JOIN_BITS(long long)
      PINOT_JOIN_BITS(int32_t)
#undef PINOT_JOIN_BITS
    }
    if (op == kJoinRaw) {
      // p[0]: the [B][Dp] lane of the members' sorted keys, arg = Dp
#define PINOT_JOIN_MEMBERS(T)                                              \
  {                                                                        \
    const T v = static_cast<const T*>(lane)[row];                          \
    const T* sk = static_cast<const T*>(lanes[p[0]]);                      \
    _Pragma("unroll") for (int b = 0; b < kMaxMembers; ++b) {              \
      if (b >= nb) break;                                                  \
      const T* skb = sk + static_cast<long long>(b) * arg;                 \
      bits[b] = skb[pinot::probe_position(skb, arg, v)] == v ? 1u : 0u;    \
    }                                                                      \
    return;                                                                \
  }
      if (elem == kI64) PINOT_JOIN_MEMBERS(long long)
      PINOT_JOIN_MEMBERS(int32_t)
#undef PINOT_JOIN_MEMBERS
    }
    if (op >= kEqRaw) {
#define PINOT_RAW_MEMBERS(T)                                               \
  {                                                                        \
    const T v = static_cast<const T*>(lane)[row];                          \
    _Pragma("unroll") for (int b = 0; b < kMaxMembers; ++b) {              \
      if (b >= nb) break;                                                  \
      bits[b] = eval_raw<T>(op, v, p + b * pw, arg);                       \
    }                                                                      \
    return;                                                                \
  }
      switch (elem) {
        case kI32: PINOT_RAW_MEMBERS(int32_t)
        case kI64: PINOT_RAW_MEMBERS(long long)
        case kF32: PINOT_RAW_MEMBERS(float)
        default: PINOT_RAW_MEMBERS(double)
      }
#undef PINOT_RAW_MEMBERS
    }
    if (width > 1) {
      // dictId leaf over an MV lane: a member matches when any entry does
#pragma unroll
      for (int b = 0; b < kMaxMembers; ++b) bits[b] = 0u;
      const long long base = row * width;
      for (int j = 0; j < width; ++j) {
        const int v = read_id(lane, elem, base + j);
#pragma unroll
        for (int b = 0; b < kMaxMembers; ++b) {
          if (b >= nb) break;
          bits[b] |= eval_id(op, v, p + b * pw, arg);
        }
      }
      return;
    }
  }
  const int v = read_id(lane, elem, row);
#pragma unroll
  for (int b = 0; b < kMaxMembers; ++b) {
    if (b >= nb) break;
    bits[b] = eval_id(op, v, p + b * pw, arg);
  }
}

// nb members over one segment of num_docs live rows: member b's mask row
// at out + b * padded, its matches added into matched[b].
template <bool kGeneral>
__global__ void filter_mask_batched_kernel(Lanes lanes, const int* __restrict__ prog,
                                           int n_nodes, int n_words, int pw, int nb,
                                           int staged, long long padded, long long num_docs,
                                           uint8_t* __restrict__ out,
                                           int* __restrict__ matched) {
  extern __shared__ int smem[];
  __shared__ int scratch[32];
  __shared__ const void* s_lanes[kMaxLanes];
  if (threadIdx.x < kMaxLanes) {
#pragma unroll
    for (int i = 0; i < kMaxLanes; ++i)
      if (threadIdx.x == i) s_lanes[i] = lanes.ptr[i];
  }
  const int* buf = prog;
  if (staged) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) smem[i] = prog[i];
    buf = smem;
  }
  __syncthreads();
  const int* params = buf + kNodeWords * n_nodes;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  int count[kMaxMembers];
#pragma unroll
  for (int b = 0; b < kMaxMembers; ++b) count[b] = 0;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < padded; row += step) {
    unsigned stack[kMaxMembers];
#pragma unroll
    for (int b = 0; b < kMaxMembers; ++b) stack[b] = 0u;
    if (row < num_docs) {
      for (int n = 0; n < n_nodes; ++n) {
        const int* node = buf + kNodeWords * n;
        const int op = node[0], arg = node[3];
        if (op == kAnd || op == kOr) {
          const unsigned m = (1u << arg) - 1u;
#pragma unroll
          for (int b = 0; b < kMaxMembers; ++b) {
            const unsigned kids = stack[b] & m;
            const unsigned bit = op == kAnd ? (kids == m) : (kids != 0u);
            stack[b] = ((stack[b] >> arg) << 1) | bit;
          }
        } else if (op == kTrue || op == kFalse) {
#pragma unroll
          for (int b = 0; b < kMaxMembers; ++b) stack[b] = (stack[b] << 1) | (op == kTrue);
        } else if (op == kVdoc) {
          // one read of the shared liveness lane for every member
          const unsigned live =
              static_cast<const uint8_t*>(s_lanes[node[1]])[row] != 0 ? 1u : 0u;
#pragma unroll
          for (int b = 0; b < kMaxMembers; ++b) stack[b] = (stack[b] << 1) | live;
        } else {
          unsigned bits[kMaxMembers];
          eval_leaf_members<kGeneral>(s_lanes, s_lanes[node[1]], op, node[4], node[5], row,
                                      params + node[2], pw, arg, nb, bits);
#pragma unroll
          for (int b = 0; b < kMaxMembers; ++b)
            if (b < nb) stack[b] = (stack[b] << 1) | bits[b];
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxMembers; ++b) {
      if (b < nb) {
        out[b * padded + row] = static_cast<uint8_t>(stack[b] & 1u);
        count[b] += static_cast<int>(stack[b] & 1u);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxMembers; ++b) {
    if (b < nb) {                       // uniform across the block
      const int c = pinot::block_sum(count[b], scratch);
      if (threadIdx.x == 0 && c != 0) atomicAdd(matched + b, c);
    }
  }
}

}  // namespace

// general: the program has a raw leaf or a leaf over an MV lane.
// seg_docs: int32 [padded / seg_rows] live rows per segment, with
// seg_matched int32 [padded / seg_rows], zeroed; or both null for one
// segment of num_docs live rows. leaf_smem: 0, or where the program is
// one join_bitmap node over one segment (its key lane and the mask
// 16-byte aligned) the bytes of the bitmap's coarse level, at most
// kJoinSmemBytes, which join_bitmap_kernel stages in shared memory;
// leaf_elem is then its key type (kI32 / kI64). wide: 1 takes the wide
// route (filter_wide_kernel) over the leaf lanes 0 .. n_row_lanes - 1,
// row_bytes each a row; host_prog is the program in host memory, passed
// in the launch's parameters where it has at most kInlineWords words
// (prog, the program on the card, may then be null).
extern "C" int pinot_filter_mask(const void* const* lane_ptrs, int n_lanes,
                                 const int* prog, int n_nodes, int n_words,
                                 int general, long long padded,
                                 long long seg_rows, const int* seg_docs,
                                 long long num_docs, void* out,
                                 int* seg_matched, int leaf_elem, int leaf_smem,
                                 int wide, const int* host_prog, const int* row_bytes,
                                 int n_row_lanes, void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes || n_nodes < 1 || seg_rows < 1 ||
      seg_rows % pinot::kThreads != 0 || padded % seg_rows != 0 ||
      (seg_docs == nullptr) != (seg_matched == nullptr))
    return -1;
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) lanes.ptr[i] = lane_ptrs[i];
  if (wide) {
    WideArgs wa{};
    if ((seg_docs != nullptr && seg_rows % kWideTile != 0) || leaf_smem != 0 ||
        !wide_args(lane_ptrs, n_lanes, host_prog, n_nodes, n_words, prog, row_bytes,
                   n_row_lanes, padded, out, wa))
      return -1;
    return static_cast<int>(launch_wide(general != 0, seg_docs != nullptr, false, lanes, wa,
                                        prog, n_nodes, n_words, 1, 0, padded, seg_rows,
                                        seg_docs, num_docs, static_cast<uint8_t*>(out),
                                        seg_matched, static_cast<cudaStream_t>(stream)));
  }
  if (leaf_smem != 0) {
    if (n_nodes != 1 || seg_docs != nullptr || (leaf_elem != kI32 && leaf_elem != kI64) ||
        leaf_smem < 0 || leaf_smem > kJoinSmemBytes)
      return -1;
    uint8_t* o = static_cast<uint8_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        leaf_elem == kI64
            ? launch_join_bitmap<long long>(lanes, prog, padded, num_docs, leaf_smem, o, s)
            : launch_join_bitmap<int32_t>(lanes, prog, padded, num_docs, leaf_smem, o, s));
  }
  const int staged = n_words <= kMaxSmemWords ? 1 : 0;
  const size_t smem = staged ? static_cast<size_t>(n_words) * sizeof(int) : 0;
  const bool stacked = seg_docs != nullptr;
  const auto kernel = general ? (stacked ? filter_mask_kernel<true, true>
                                         : filter_mask_kernel<true, false>)
                              : (stacked ? filter_mask_kernel<false, true>
                                         : filter_mask_kernel<false, false>);
  kernel<<<pinot::grid_for(kernel, padded, smem), pinot::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lanes, prog, n_nodes, n_words, staged, padded, seg_rows, seg_docs, num_docs,
      static_cast<uint8_t*>(out), seg_matched);
  return static_cast<int>(cudaGetLastError());
}

// prog: the nodes, then n_members parameter blocks of param_words words
// each; out uint8 [n_members][padded], matched int32 [n_members], zeroed.
// wide: 1 takes the wide route (filter_wide_kernel, every member over the
// same staged rows) as pinot_filter_mask's wide does, host_prog the whole
// buffer in host memory; it takes no ivf_probe or join node (the host
// keeps those programs on the row kernel).
extern "C" int pinot_filter_mask_batched(const void* const* lane_ptrs, int n_lanes,
                                         const int* prog, int n_nodes, int param_words,
                                         int n_members, int general, long long padded,
                                         long long num_docs, void* out, int* matched, int wide,
                                         const int* host_prog, const int* row_bytes,
                                         int n_row_lanes, void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes || n_nodes < 1 || param_words < 0 ||
      n_members < 1 || n_members > kMaxMembers || padded < 1)
    return -1;
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) lanes.ptr[i] = lane_ptrs[i];
  const long long words = static_cast<long long>(kNodeWords) * n_nodes +
                          static_cast<long long>(param_words) * n_members;
  if (wide) {
    WideArgs wa{};
    if (words > kMaxSmemWords ||
        !wide_args(lane_ptrs, n_lanes, host_prog, n_nodes, static_cast<int>(words), prog,
                   row_bytes, n_row_lanes, padded, out, wa))
      return -1;
    for (int n = 0; n < n_nodes; ++n) {
      const int op = host_prog[kNodeWords * n];
      if (op == kIvfProbe || op == kJoinRaw || op == kJoinBits || op == kJoinBitmap) return -1;
    }
    return static_cast<int>(launch_wide(general != 0, false, true, lanes, wa, prog, n_nodes,
                                        static_cast<int>(words), n_members, param_words, padded,
                                        padded, nullptr, num_docs, static_cast<uint8_t*>(out),
                                        matched, static_cast<cudaStream_t>(stream)));
  }
  const int staged = words <= kMaxSmemWords ? 1 : 0;
  const size_t smem = staged ? static_cast<size_t>(words) * sizeof(int) : 0;
  const auto kernel = general ? filter_mask_batched_kernel<true>
                              : filter_mask_batched_kernel<false>;
  kernel<<<pinot::grid_for(kernel, padded, smem), pinot::kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      lanes, prog, n_nodes, static_cast<int>(words), param_words, n_members, staged, padded,
      num_docs, static_cast<uint8_t*>(out), matched);
  return static_cast<int>(cudaGetLastError());
}
