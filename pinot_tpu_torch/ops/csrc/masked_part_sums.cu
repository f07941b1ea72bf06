// K2 masked_part_sums: exact masked sums of 7-bit int8 part lanes, plus the
// match count.
//
// Replaces pinot_tpu/ops/kernels.py:_part_sums (:248) and the masked count
// of _agg_outputs (:579-600): out[l] = sum over matched rows of
// parts[l][row] for each part lane l, out[L] = number of matched rows. Any
// nonzero mask byte is a match.
//
// What bounds it: bytes. One mask byte a row, and one int8 a part lane
// for the rows that match; an integer add a byte.
//
// What the design does about it: a thread reads the mask as 16-byte
// words (16 rows), two words in flight where its registers allow, and
// reads a 16-byte word of each part lane only where the mask word holds
// a match, so a selective filter leaves most part-lane sectors unread.
// The matched bytes of a mask word become 0xff by __vcmpne4; the count
// adds their set bits (8 a row), and each part lane adds its selected
// bytes four rows an instruction, __dp4a(part & sel, 0x01010101, acc).
// Every block's rows lie inside one output row (grid x: ranges x blocks
// a range), so the loop never flushes; at the end a warp adds its
// registers with __reduce_add_sync and the block's warps through shared
// memory, leaving one integer atomicAdd a block and output. Integer sums
// are exact and do not depend on the order.
//
// Rows of seg_rows rows: the output has one row of L + 1 sums per
// seg_rows input rows, out[s][l] over rows [s * seg_rows, (s + 1) *
// seg_rows). For stacked segments (the counterpart of the vmap in
// pinot_tpu/parallel/sharded.py:get_sharded_kernel) a row is a segment,
// and the rows are the JAX `partsT` regime's exact partials: the host adds
// them in int64. Exactness of int32: 7-bit lanes bound every sum by 127 *
// seg_rows, and the wrapper splits a segment with 127 * rows >= 2^31 into
// row ranges below that bound (ops/kernels.py:part_sum_range), one output
// row each, as the JAX `_part_sums` returns block partials for such a
// segment (:276-279).
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): a block
// serves up to kMaxMembers members (grid y: groups of them) over the same
// rows. It reads each member's mask word, and the part-lane words once
// where any member's word holds a match, so the shared part lanes cross
// the bus once a batch, not once a member.
//
// Routes: "vector" reads every operand as aligned 16-byte words;
// "bytes" (an operand off a 16-byte boundary) assembles the same words
// from byte loads. The wrapper picks by the operands' addresses.

#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;
constexpr int kMaxMembers = 8;
constexpr int kWarps = pinot::kThreads / 32;

struct PartLanes {
  const int8_t* ptr[kMaxParts];
};

struct Args {
  const uint8_t* mask;          // [n_members][padded]
  PartLanes parts;
  int n_parts;
  long long padded;
  long long range_words;        // 16-byte words of one output row
  int blocks_per_range;
  int n_members;
  int vec;                      // route "vector": every operand aligned
  int* out;                     // [n_members][ranges][n_parts + 1], zeroed
};

// kL: part lanes the registers hold (n_parts <= kL); kB: members a block
// serves (1, or kMaxMembers for a batch); kU: mask words a thread keeps in
// flight an iteration.
template <int kL, int kB>
__global__ void __launch_bounds__(pinot::kThreads)
    part_sums_kernel(const Args a) {
  constexpr int kU = kB == 1 && kL <= 8 ? 2 : 1;
  constexpr int kOuts = kL + 1;
  __shared__ int s_warp[kWarps][kB * kOuts];
  const int range = blockIdx.x / a.blocks_per_range;
  const int sub = blockIdx.x - range * a.blocks_per_range;
  const int m0 = blockIdx.y * kB;
  const int nb = min(kB, a.n_members - m0);
  const long long first = static_cast<long long>(range) * a.range_words;
  const long long step = static_cast<long long>(a.blocks_per_range) * blockDim.x;
  int acc[kB][kOuts];   // [kL]: 8 x the count (the set bits of sel)
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int l = 0; l < kOuts; ++l) acc[b][l] = 0;

  // the mask words of an iteration; a one-member CTA loads the next
  // iteration's while this one's part words arrive, so its loads stay in
  // flight
  constexpr bool kPrefetch = kB == 1;
  uint4 mw[kU][kB];
  auto load_masks = [&](long long w0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long w = w0 + u * step;
#pragma unroll
      for (int b = 0; b < kB; ++b)
        mw[u][b] = b < nb && w < a.range_words
                       ? pinot::load16(a.mask + (m0 + b) * a.padded + (first + w) * 16, a.vec)
                       : make_uint4(0, 0, 0, 0);
    }
  };
  long long w0 = static_cast<long long>(sub) * blockDim.x + threadIdx.x;
  load_masks(w0);
  for (; w0 < a.range_words; w0 += kU * step) {
    uint4 m[kU][kB];
    bool any[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      uint32_t bits = 0;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        m[u][b] = mw[u][b];
        bits |= m[u][b].x | m[u][b].y | m[u][b].z | m[u][b].w;
      }
      any[u] = bits != 0;
    }
    const long long next = w0 + kU * step;
    if (kPrefetch && next < a.range_words) load_masks(next);
    uint4 p[kU][kL];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long row = (first + w0 + u * step) * 16;
#pragma unroll
      for (int l = 0; l < kL; ++l)
        if (any[u] && l < a.n_parts) p[u][l] = pinot::load16(a.parts.ptr[l] + row, a.vec);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!any[u]) continue;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        if (b >= nb) continue;
        const uint32_t s0 = __vcmpne4(m[u][b].x, 0u), s1 = __vcmpne4(m[u][b].y, 0u),
                       s2 = __vcmpne4(m[u][b].z, 0u), s3 = __vcmpne4(m[u][b].w, 0u);
        acc[b][kL] += __popc(s0) + __popc(s1) + __popc(s2) + __popc(s3);
#pragma unroll
        for (int l = 0; l < kL; ++l) {
          if (l >= a.n_parts) continue;
          int v = acc[b][l];
          v = __dp4a(static_cast<int>(p[u][l].x & s0), 0x01010101, v);
          v = __dp4a(static_cast<int>(p[u][l].y & s1), 0x01010101, v);
          v = __dp4a(static_cast<int>(p[u][l].z & s2), 0x01010101, v);
          v = __dp4a(static_cast<int>(p[u][l].w & s3), 0x01010101, v);
          acc[b][l] = v;
        }
      }
    }
    if (!kPrefetch && next < a.range_words) load_masks(next);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    acc[b][kL] >>= 3;
#pragma unroll
    for (int l = 0; l < kOuts; ++l) {
      const int s = __reduce_add_sync(0xffffffffu, acc[b][l]);
      if (lane == 0) s_warp[warp][b * kOuts + l] = s;
    }
  }
  __syncthreads();
  const long long ranges = a.padded / (a.range_words * 16);
  for (int i = threadIdx.x; i < nb * kOuts; i += blockDim.x) {
    const int b = i / kOuts, l = i - b * kOuts;
    if (l < kL && l >= a.n_parts) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_warp[w][i];
    const int col = l == kL ? a.n_parts : l;
    if (s != 0)
      atomicAdd(a.out + ((m0 + b) * ranges + range) * (a.n_parts + 1) + col, s);
  }
}

template <int kL, int kB>
int launch_with(Args a, long long ranges, cudaStream_t stream) {
  const auto kernel = part_sums_kernel<kL, kB>;
  const int groups = (a.n_members + kB - 1) / kB;
  // one wave over every (range, member group); no block without a word
  constexpr int kU = kB == 1 && kL <= 8 ? 2 : 1;
  const long long most = (a.range_words + kU * pinot::kThreads - 1) / (kU * pinot::kThreads);
  const long long wave = pinot::grid_for(kernel, ranges * groups * most * pinot::kThreads, 0);
  const long long per = (wave + ranges * groups - 1) / (ranges * groups);
  if (ranges * per > 0x7fffffffLL) return -1;
  a.blocks_per_range = static_cast<int>(per);
  kernel<<<dim3(static_cast<unsigned>(ranges * per), groups), pinot::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kL>
int launch_parts(const Args& a, long long ranges, cudaStream_t stream) {
  return a.n_members == 1 ? launch_with<kL, 1>(a, ranges, stream)
                          : launch_with<kL, kMaxMembers>(a, ranges, stream);
}

int launch(const void* mask, const void* const* part_ptrs, int n_parts, long long padded,
           long long seg_rows, int n_members, int vec, void* out, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || seg_rows < 16 || seg_rows % 16 != 0 ||
      padded % seg_rows != 0 || n_members < 1 || (n_members + kMaxMembers - 1) / kMaxMembers > 65535)
    return -1;
  Args a{};
  a.mask = static_cast<const uint8_t*>(mask);
  for (int l = 0; l < n_parts; ++l) a.parts.ptr[l] = static_cast<const int8_t*>(part_ptrs[l]);
  a.n_parts = n_parts;
  a.padded = padded;
  a.range_words = seg_rows / 16;
  a.n_members = n_members;
  a.vec = vec;
  a.out = static_cast<int*>(out);
  const long long ranges = padded / seg_rows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_parts <= 4) return launch_parts<4>(a, ranges, s);
  if (n_parts <= 8) return launch_parts<8>(a, ranges, s);
  return launch_parts<16>(a, ranges, s);
}

}  // namespace

// out: int32 [padded / seg_rows][n_parts + 1], zeroed. vec: 1 where the
// mask and every part lane are 16-byte aligned (route "vector").
extern "C" int pinot_masked_part_sums(const void* mask, const void* const* part_ptrs,
                                      int n_parts, long long padded, long long seg_rows,
                                      int vec, void* out, void* stream) {
  return launch(mask, part_ptrs, n_parts, padded, seg_rows, 1, vec, out, stream);
}

// mask uint8 [n_members][padded]; out int32 [n_members][padded /
// seg_rows][n_parts + 1], zeroed.
extern "C" int pinot_masked_part_sums_batched(const void* mask, const void* const* part_ptrs,
                                              int n_parts, long long padded,
                                              long long seg_rows, int n_members, int vec,
                                              void* out, void* stream) {
  return launch(mask, part_ptrs, n_parts, padded, seg_rows, n_members, vec, out, stream);
}
