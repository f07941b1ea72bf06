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
// What the design does about it: the host flattens the filter tree into a
// postfix program plus its parameters (one small int32 buffer, one copy to
// the card per dispatch). Each block stages that buffer in shared memory,
// so in-lists and member bitsets are read from shared memory, never from
// device memory per row. One thread evaluates one row at a time over a
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
// The host checks that the stack never holds more than 32 bits.
//
// Batched members (the counterpart of the vmap over a query axis in
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): up to 8
// queries of one compiled plan share the program's nodes and differ only
// in their parameters; member b's parameter block follows member b - 1's.
// One thread still evaluates one row, for every member: each leaf reads
// its lane element once and compares it with each member's constants, and
// each member keeps its own bit stack in a register. The outputs are one
// mask row per member, [B][padded], and the members' match counts. An
// ivf_probe leaf reads member b's probe ids and ok flags at row b of the
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

enum Op : int {
  kTrue = 0, kFalse = 1, kEq = 2, kNeq = 3, kRange = 4, kIn = 5,
  kNotIn = 6, kMember = 7, kAnd = 8, kOr = 9,
  kEqRaw = 10, kNeqRaw = 11, kRangeRaw = 12, kInRaw = 13, kNotInRaw = 14,
  kIvfProbe = 15, kVdoc = 16, kJoinRaw = 17, kJoinBits = 18,
};

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


constexpr int kMaxMembers = 8;

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
// segment of num_docs live rows.
extern "C" int pinot_filter_mask(const void* const* lane_ptrs, int n_lanes,
                                 const int* prog, int n_nodes, int n_words,
                                 int general, long long padded,
                                 long long seg_rows, const int* seg_docs,
                                 long long num_docs, void* out,
                                 int* seg_matched, void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes || n_nodes < 1 || seg_rows < 1 ||
      seg_rows % pinot::kThreads != 0 || padded % seg_rows != 0 ||
      (seg_docs == nullptr) != (seg_matched == nullptr))
    return -1;
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) lanes.ptr[i] = lane_ptrs[i];
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
extern "C" int pinot_filter_mask_batched(const void* const* lane_ptrs, int n_lanes,
                                         const int* prog, int n_nodes, int param_words,
                                         int n_members, int general, long long padded,
                                         long long num_docs, void* out, int* matched,
                                         void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes || n_nodes < 1 || param_words < 0 ||
      n_members < 1 || n_members > kMaxMembers || padded < 1)
    return -1;
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) lanes.ptr[i] = lane_ptrs[i];
  const long long words = static_cast<long long>(kNodeWords) * n_nodes +
                          static_cast<long long>(param_words) * n_members;
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
