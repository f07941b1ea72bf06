// K4 masked_histogram: exact int32 counts of the dictIds of matched rows,
// and, in its fused form, the HyperLogLog registers of the ids present.
//
// Replaces pinot_tpu/ops/kernels.py:_histogram (:566), which takes
// _mxu_histogram (:354, one-hot matrix products built from _cmp_onehot
// :308 and _radix_onehots :324) up to DENSE_CARD_LIMIT and a scatter-add
// above it, the MV entry histogram of _agg_outputs (:638-652) and the
// "hll" branch of _agg_outputs (:620-636): out[v] = number of entries e of
// rows with mask[row] != 0 and ids[row, e] == v, for v in [0, limit),
// where a single-value lane has one entry per row and limit = card_pad
// (ids outside count nowhere, as the one-hot compare drops them), and an
// MV lane [P, W] has W with limit = the cardinality (padding entries, id
// == cardinality, count nowhere, as the JAX entry mask drops them).
// `total`, when given, receives the number of entries counted: COUNTMV's
// answer, the JAX hist[:card].sum(). With `regs` (the fused HLL form):
// regs[r] = max over the ids d with out[d] > 0 and idx[d] == r of
// rank[d], 0 where there is none, for r in [0, m); idx and rank are the
// per-dictId tables the loader builds with the host sketch's hashing
// (sketches.hll_tables), padding ids carry rank 0, the max identity.
//
// What bounds it: bytes. One mask byte a row, and the id words of the
// rows that match (a [W] row for MV), plus the table written; unless many
// matched rows share few ids, when increments of one address serialise
// (teamID has 16 values, position 10, SSB d_year 7).
//
// What the design does about it:
// - A thread reads the mask as 16-byte words (16 rows; any nonzero byte
//   is a match, common.cuh:match_bits), and the 16 rows' ids as 16-byte
//   words only where its mask word holds a match: 1, 2 or 4 words for an
//   int8, int16, int32 lane, and an MV lane's rows where 16 of them take
//   at most kIdWords words (int8 up to 4 entries a row, int16 up to 2),
//   each width built as its own kernel; wider MV rows are read entry by
//   entry. The rows and entries unroll with constant indices, so an id
//   comes out of the words by a shift.
// - Each matched entry is one atomic increment. Hot ids: on the smem
//   route a block keeps a copy of a small table for each warp (up to
//   kCopyBytes), so a hot id's increments meet only inside one warp's
//   instruction, which the card serialises; the copies add up in the
//   flush. Combining a warp's equal ids with __match_any_sync first was
//   measured and dropped: on baseballStats' mask (66% of rows matched)
//   it took teamID's kernel to 16.6 µs and playerName's to 25.1, against
//   7.3 and 10.5 here (H100, tools/reduce_bench.py); the match
//   instruction's throughput, not the atomics, bounded it.
// - Table routes. "smem": each block counts into its table copies in
//   shared memory and flushes the non-zero bins into the zeroed device
//   table at its end, one atomic a bin. The flush reads copies x card_pad
//   bins a block, so the grid shrinks as the table grows: at most rows /
//   (kFlushRatio x copies x card_pad) blocks, and never fewer than one an
//   SM. The wrapper takes "smem" wherever one table fits a block's
//   shared memory (kernels.hist_table): at 16,384 bins on 2.5M rows
//   (an int16 lane of 10,000 ids) it read 30.1 µs against the device
//   table's 50.5 (H100, chip_smoke.py). Past that, "global": every
//   increment goes to the device table.
// - The HLL registers come from the first increment of each id: an id is
//   present exactly when some atomic on its device bin returns 0 (the
//   smem route's flush, or the global route's increment). That atomic's
//   thread does atomicMax(regs + idx[d], rank[d]), so each present id
//   makes one register atomic over the whole launch, with no register
//   table and no second launch; the max does not depend on the order, so
//   the registers equal the two-step plain version's bit for bit.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): over a
// single-value lane a block serves up to kMaxMembers members (grid y:
// member groups) over one read of the id lane, reading each member's
// mask word and the id words once where any member's word matches; each
// member has its own tables (shared where kMaxMembers of them fit a
// block, else one member a block on grid y). An MV lane takes one member
// a block on grid y: with 8 members' rows a thread, position at 8
// members read 92.0 µs of kernel against 62.9 a member a block (H100,
// tools/reduce_bench.py), its id words coming again from L2. The stacked
// form is the same kernel over the flat [S * P] rows.
//
// Routes: "vector" reads every operand as aligned 16-byte words; "bytes"
// (an operand off a 16-byte boundary) assembles the same words from byte
// loads. The wrapper picks by the operands' addresses. Integer atomics:
// the counts are exact and do not depend on the order.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kMaxMembers = 8;
// 16-byte id words a thread holds for its 16 rows: a single-value lane's
// (1, 2 or 4), or an MV lane's where 16 rows take at most this many
constexpr int kIdWords = 4;
// The smem route's flush (its blocks' table copies, each card_pad bins)
// reads at most rows / kFlushRatio bins a launch, and never takes fewer
// than a block an SM.
constexpr long long kFlushRatio = 4;
// Shared bytes a block's table copies may take before a block keeps
// fewer than one copy a warp: small tables get a copy a warp (a hot id's
// increments then meet only inside a warp's instruction).
constexpr int kCopyBytes = 16 * 1024;

struct Args {
  const uint8_t* mask;          // [n_members][padded]
  const void* ids;              // [padded][width]
  long long padded;
  long long words;              // 16-row mask words, the last one partial
  long long full_words;         // padded / 16
  int width;
  int limit;
  int card_pad;
  int n_members;
  int copies;                   // table copies a member on the smem route
  int vec;                      // route "vector": every operand aligned
  int* out;                     // [n_members][card_pad], zeroed
  int* total;                   // [n_members], zeroed, or null
  const int* hll_idx;           // [card_pad] (the fused form), or null
  const int* hll_rank;          // [card_pad]
  int m;
  int* regs;                    // [n_members][m], zeroed, or null
};

// The matched rows of a partial last mask word as bits (rows past padded
// are not read).
__device__ __forceinline__ unsigned tail_bits(const Args& a, int member, long long w) {
  const uint8_t* p = a.mask + member * a.padded + w * 16;
  const int n = static_cast<int>(a.padded - w * 16);
  unsigned bits = 0;
  for (int r = 0; r < n; ++r) bits |= (p[r] != 0 ? 1u : 0u) << r;
  return bits;
}

// Element j of the id words v, sign-extended: by selects, which a
// constant j (every caller's, after unrolling) folds away, so v stays in
// registers.
template <typename T>
__device__ __forceinline__ int element(const uint32_t (&v)[kIdWords * 4], int j) {
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // elements a 32-bit word
  const int i = j / kPer;
  uint32_t x = v[0];
#pragma unroll
  for (int k = 1; k < kIdWords * 4; ++k) x = i == k ? v[k] : x;
  return static_cast<int>(static_cast<T>(x >> ((j % kPer) * 8 * static_cast<int>(sizeof(T)))));
}

// Id d was seen for the first time by this member: its rank into its
// register.
__device__ __forceinline__ void first_seen(const Args& a, int member, int d) {
  const int r = a.hll_idx[d], k = a.hll_rank[d];
  if (r >= 0 && r < a.m && k > 0) atomicMax(a.regs + member * a.m + r, k);
}

// Entry v (a dictId, or anything outside [0, limit), which counts
// nowhere) counted in `table`; on the global route the increment that
// finds the bin at 0 sets the id's register.
template <bool kSmem>
__device__ __forceinline__ void add(const Args& a, int* table, int member, int v, int& count) {
  if (v < 0 || v >= a.limit) return;
  ++count;
  if (!kSmem && a.regs != nullptr) {
    if (atomicAdd(table + v, 1) == 0) first_seen(a, member, v);
  } else {
    atomicAdd(table + v, 1);
  }
}

// One member's matched rows of a 16-row word (`bits`): their entries
// from the id words where `words`, else one by one from row_ids. kW: the
// lane's width where the kernel was built for it (constant indices),
// else 0 (a.width entries a row, read one by one).
template <typename T, bool kSmem, int kW>
__device__ __forceinline__ void count_rows(const Args& a, int* table, int member, uint32_t bits,
                                           bool words, const uint32_t (&idw)[kIdWords * 4],
                                           const T* row_ids, int& count) {
  if constexpr (kW > 0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (!((bits >> r) & 1u)) continue;
#pragma unroll
      for (int e = 0; e < kW; ++e)
        add<kSmem>(a, table, member,
                   words ? element<T>(idw, r * kW + e) : static_cast<int>(__ldg(row_ids + r * kW + e)),
                   count);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      if (!((bits >> r) & 1u)) continue;
      for (int e = 0; e < a.width; ++e)
        add<kSmem>(a, table, member, static_cast<int>(__ldg(row_ids + r * a.width + e)), count);
    }
  }
}

// T: the id lane's element type; kB: members a block serves (1, or
// kMaxMembers for a batch); kSmem: the table route; kW: entries a row
// where 16 rows' ids fit kIdWords words (1 for a single-value lane), else
// 0.
template <typename T, int kB, bool kSmem, int kW>
__global__ void __launch_bounds__(kHistThreads) histogram_kernel(const Args a) {
  extern __shared__ int bins[];            // [nb][copies][card_pad] on smem
  __shared__ int s_count[kB];
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * kB;
  const int nb = min(kB, a.n_members - m0);
  if (kSmem)
    for (int i = threadIdx.x; i < nb * a.copies * a.card_pad; i += blockDim.x) bins[i] = 0;
  if (static_cast<int>(threadIdx.x) < kB) s_count[threadIdx.x] = 0;
  __syncthreads();
  const int copy = warp & (a.copies - 1);
  const long long step = static_cast<long long>(gridDim.x) * kHistThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kHistThreads + threadIdx.x;
       w < a.words; w += step) {
    const bool full = w < a.full_words;
    uint4 mw[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b)
      mw[b] = b < nb && full ? pinot::load16(a.mask + (m0 + b) * a.padded + w * 16, a.vec)
                             : make_uint4(0, 0, 0, 0);
    // the members' 16 row bits, two members a register
    uint32_t packed[(kB + 1) / 2];
    uint32_t any = 0;
#pragma unroll
    for (int k = 0; k < (kB + 1) / 2; ++k) packed[k] = 0;
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const uint32_t bits = full ? pinot::match_bits(mw[b]) : (b < nb ? tail_bits(a, m0 + b, w) : 0u);
      packed[b / 2] |= bits << ((b % 2) * 16);
      any |= bits;
    }
    if (any == 0) continue;
    // the 16 rows' ids as words, but for a partial word (one by one)
    const bool words = kW > 0 && full;
    uint32_t idw[kIdWords * 4];
#pragma unroll
    for (int k = 0; k < kIdWords * 4; ++k) idw[k] = 0;
    if (words) {
      const uint8_t* p = static_cast<const uint8_t*>(a.ids) +
                         w * 16 * (kW > 0 ? kW : 1) * static_cast<int>(sizeof(T));
#pragma unroll
      for (int k = 0; k < (kW > 0 ? kW : 1) * static_cast<int>(sizeof(T)); ++k) {
        const uint4 q = pinot::load16(p + 16 * k, a.vec);
        idw[4 * k] = q.x;
        idw[4 * k + 1] = q.y;
        idw[4 * k + 2] = q.z;
        idw[4 * k + 3] = q.w;
      }
    }
    const T* row_ids = static_cast<const T*>(a.ids) + w * 16 * a.width;
    auto member = [&](int b) {
      uint32_t bits = packed[0];
#pragma unroll
      for (int k = 1; k < (kB + 1) / 2; ++k) bits = b / 2 == k ? packed[k] : bits;
      bits = (bits >> ((b % 2) * 16)) & 0xffffu;
      if (bits == 0) return;
      int* table = kSmem ? bins + (b * a.copies + copy) * a.card_pad
                         : a.out + static_cast<long long>(m0 + b) * a.card_pad;
      int count = 0;
      count_rows<T, kSmem, kW>(a, table, m0 + b, bits, words, idw, row_ids, count);
      if (a.total != nullptr && count != 0) atomicAdd(s_count + b, count);
    };
#pragma unroll
    for (int b = 0; b < kB; ++b)
      if (b < nb) member(b);
  }
  __syncthreads();
  if (kSmem) {
    for (int i = threadIdx.x; i < nb * a.card_pad; i += blockDim.x) {
      const int b = i / a.card_pad, d = i - b * a.card_pad;
      int c = 0;
      for (int k = 0; k < a.copies; ++k) c += bins[(b * a.copies + k) * a.card_pad + d];
      if (c == 0) continue;
      const int old = atomicAdd(a.out + static_cast<long long>(m0 + b) * a.card_pad + d, c);
      if (a.regs != nullptr && old == 0) first_seen(a, m0 + b, d);
    }
  }
  if (a.total != nullptr && static_cast<int>(threadIdx.x) < nb && s_count[threadIdx.x] != 0)
    atomicAdd(a.total + m0 + threadIdx.x, s_count[threadIdx.x]);
}

using Kernel = void (*)(Args);

// The one-member kernel for a lane of `width` entries a row: constant
// widths where
// 16 rows' ids fit kIdWords words (int8 up to 4, int16 up to 2), else the
// row-by-row form.
template <typename T, bool kSmem>
Kernel kernel_for(int width) {
  if (width == 1) return histogram_kernel<T, 1, kSmem, 1>;
  if constexpr (sizeof(T) <= 2)
    if (width == 2) return histogram_kernel<T, 1, kSmem, 2>;
  if constexpr (sizeof(T) == 1) {
    if (width == 3) return histogram_kernel<T, 1, kSmem, 3>;
    if (width == 4) return histogram_kernel<T, 1, kSmem, 4>;
  }
  return histogram_kernel<T, 1, kSmem, 0>;
}

// Dynamic shared memory a block's tables may take: the opt-in room less
// the kernels' static shared memory (at most kMaxMembers ints).
int room(int* out) {
  int device = 0, optin = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = optin - static_cast<int>(sizeof(int)) * kMaxMembers;
  return static_cast<int>(rc);
}

template <typename T, int kB, bool kSmem>
int launch_with(Args a, cudaStream_t stream) {
  Kernel kernel = histogram_kernel<T, kB, kSmem, 1>;
  if constexpr (kB == 1) kernel = kernel_for<T, kSmem>(a.width);
  const long long tables = std::min(kB, a.n_members);
  a.copies = 1;      // a power of two, at most a copy a warp
  while (kSmem && a.copies < kHistWarps &&
         2LL * a.copies * tables * a.card_pad * static_cast<long long>(sizeof(int)) <= kCopyBytes)
    a.copies *= 2;
  const size_t smem = kSmem ? static_cast<size_t>(tables * a.copies * a.card_pad) * sizeof(int) : 0;
  if (smem > 48 * 1024 - sizeof(int) * kB) {
    const cudaError_t rc = pinot::allow_dynamic_smem(kernel, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  int device = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHistThreads, smem) !=
          cudaSuccess || per_sm < 1)
    per_sm = 1;
  const long long groups = (a.n_members + kB - 1) / kB;
  // one wave, a word a thread at most; on smem, at most the flush's
  // share of the rows, and at least an SM's worth of blocks
  long long cap = (static_cast<long long>(sms) * per_sm + groups - 1) / groups;
  if (kSmem) {
    const long long flush = a.padded / (kFlushRatio * a.copies * a.card_pad);
    cap = std::min(cap, std::max(flush, (sms + groups - 1) / groups));
  }
  long long blocks = (a.words + kHistThreads - 1) / kHistThreads;
  blocks = std::max(1LL, std::min(blocks, cap));
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)), kHistThreads,
           smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_elem(const Args& a, int use_smem, cudaStream_t stream) {
  if (use_smem) {
    int bytes = 0;
    const int rc = room(&bytes);
    if (rc != 0) return rc;
    if (a.n_members > 1 && a.width == 1 &&
        static_cast<long long>(kMaxMembers) * a.card_pad * static_cast<long long>(sizeof(int)) <= bytes)
      return launch_with<T, kMaxMembers, true>(a, stream);
    return launch_with<T, 1, true>(a, stream);
  }
  return a.n_members > 1 && a.width == 1 ? launch_with<T, kMaxMembers, false>(a, stream)
                                         : launch_with<T, 1, false>(a, stream);
}

int launch(const void* mask, const void* ids, int elem, long long padded, int width,
           int limit, int card_pad, int n_members, void* out, void* total, int vec,
           int use_smem, const void* hll_idx, const void* hll_rank, int m, void* regs,
           void* stream) {
  if (card_pad < 1 || width < 1 || limit < 0 || limit > card_pad || padded < 1 ||
      elem < pinot::kI8 || elem > pinot::kI32 || n_members < 1 || n_members > 65535 ||
      (regs != nullptr && (m < 1 || hll_idx == nullptr || hll_rank == nullptr)))
    return -1;
  Args a{};
  a.mask = static_cast<const uint8_t*>(mask);
  a.ids = ids;
  a.padded = padded;
  a.full_words = padded / 16;
  a.words = (padded + 15) / 16;
  a.width = width;
  a.limit = limit;
  a.card_pad = card_pad;
  a.n_members = n_members;
  a.vec = vec;
  a.out = static_cast<int*>(out);
  a.total = static_cast<int*>(total);
  a.hll_idx = static_cast<const int*>(hll_idx);
  a.hll_rank = static_cast<const int*>(hll_rank);
  a.m = m;
  a.regs = static_cast<int*>(regs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem) {
    case pinot::kI8: return launch_elem<int8_t>(a, use_smem, s);
    case pinot::kI16: return launch_elem<int16_t>(a, use_smem, s);
    default: return launch_elem<int32_t>(a, use_smem, s);
  }
}

}  // namespace

// out int32 [card_pad] and total int32 [1] (or null), zeroed; with regs
// (int32 [m], zeroed), the HLL registers of the ids present, from the
// int32 [card_pad] tables hll_idx / hll_rank. vec: 1 where the mask and
// the id lane are 16-byte aligned (route "vector"); use_smem: the table
// route "smem".
extern "C" int pinot_masked_histogram(const void* mask, const void* ids, int elem,
                                      long long padded, int width, int limit, int card_pad,
                                      void* out, void* total, int vec, int use_smem,
                                      const void* hll_idx, const void* hll_rank, int m,
                                      void* regs, void* stream) {
  return launch(mask, ids, elem, padded, width, limit, card_pad, 1, out, total, vec,
                use_smem, hll_idx, hll_rank, m, regs, stream);
}

// mask uint8 [n_members][padded]; out int32 [n_members][card_pad], total
// int32 [n_members] (or null) and regs int32 [n_members][m] (or null),
// zeroed.
extern "C" int pinot_masked_histogram_batched(const void* mask, const void* ids, int elem,
                                              long long padded, int width, int limit,
                                              int card_pad, int n_members, void* out,
                                              void* total, int vec, int use_smem,
                                              const void* hll_idx, const void* hll_rank,
                                              int m, void* regs, void* stream) {
  return launch(mask, ids, elem, padded, width, limit, card_pad, n_members, out, total, vec,
                use_smem, hll_idx, hll_rank, m, regs, stream);
}

// out[0]: dynamic shared bytes a block's tables may take (the smem
// route takes a table of card_pad int32 bins up to it).
extern "C" int pinot_masked_histogram_room(int* out) {
  return room(out);
}
