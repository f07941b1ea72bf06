// K14 block_compact, K15 slot_tables and K16 rank_slots: the compacted
// filtered group-by of the JAX planner (kmax > 0).
//
// Replaces pinot_tpu/ops/kernels.py:_block_compact (:785) with the lane
// registry of _group_outputs_compacted (:1070-1111) (K14),
// _slot_sum_tables (:835) with the scatter min / max of :1194-1216 (K15),
// and the ranked layout's sort and rank dedup (:1122-1140) (K16).
//
// K14: the rows (of each segment, or of each row of a [S, P] stack) in
// blocks of 2,048; a matched row's slot is block * r + its rank among the
// block's matched rows, in row order; ranks at or past r are dropped and
// raise `overflow`. Two routes, which the host picks (ops/kernels.py:
// compact_route): the warp route below for keys without an MV key, the
// block route for MV keys. For MV keys the rows are _expand_mv_group's: P * W
// expanded rows (doc-major, entry combination minor, first MV key
// fastest), walked in the kernel and never written; a combination whose
// entry is padding or outside its member table is not matched, and the
// blocks are those of the expanded rows, as in JAX. Each slot gets the
// int32 group key (group_key.cuh's evaluator, the one K3 uses), each
// int8 part value, each float64 value (sum lanes and raw min / max
// lanes) and each int32 dictId (id min / max lanes) of its row; unused
// slots get key g_pad and zeros. It also counts the matched docs, once
// each (the plan's numDocsScanned). JAX carries keys and ids in 7-bit planes
// only to feed its matrix unit; here they are words. On the block route a
// block's ranks come from a warp ballot and popcount, then a scan of the 8
// warps' counts in shared memory, 256 rows at a time in row order, so
// every slot holds the row JAX's one-hot matmul puts there.
//
// K15: count, part sums, float64 sums and min / max over the slots,
// addressed by gslot (a key for the dense layout, a rank for the ranked
// one; gslot >= t_slots drops the slot). Part sums are int32 and exact,
// one table per `chunk_slots` slots of a segment's cap (JAX's
// DENSE_ROWS_LIMIT macro-chunks, :1157-1167), or one int64 table over a
// stack (`psums_wide`); float64 sums in a run-dependent order, held to a
// tolerance; extremes equal. Two launches: slot_init_kernel writes the
// device tables' starting values; slot_fold_kernel reads gslot 32
// consecutive slots a warp, drops the invalid ones by predicate and folds
// the valid ones (group_fold.cuh, which K3 shares) into a block's shared
// table (`smem`) or the device tables (`global`). No list: where few of a
// segment's slots are valid (most SSB tables), a list kernel, its counter
// and one more dependent load cost more than the idle lanes; where a
// quarter are (Q2.1), listing won by ~3 µs (PERF.md §6).
//
// K16: the ranked layout's dedup. For each valid slot, gslot is the rank
// of its key among the distinct valid keys of its segment, ascending, and
// rkeys[rank] = key, padded with g_pad. JAX sorts the compacted keys and
// takes a cumsum of the new-key flags; here a presence bitmap over the
// g_pad keys (rank_mark), an exclusive scan of its words' popcounts that
// also writes rkeys (rank_scan, one block a segment) and a popcount below
// each key's bit (rank_assign) give the same function in O(g_pad / 32 +
// cap). Past ops/kernels.py:RANK_BITMAP_G_LIMIT keys the bitmap would
// outgrow the work, and the wrapper sorts the keys with K12 instead;
// rank_sorted then numbers the new keys of the sorted run.
//
// What bounds them: bytes. K14 reads the mask and, for matched rows, their
// key ids, parts and values, and writes cap slots; K15 reads the slots and
// writes the tables; K16 reads the keys twice and writes gslot and rkeys.
// For a selective filter (cap ~ P / 100) K14's mask read is most of it.
// The design keeps the row order with a scan and no sort, and reads a
// row's lanes only when it takes a slot.

#include "group_fold.cuh"
#include "group_key.cuh"

namespace {

using pinot::KeyLanes;
namespace fold = pinot::fold;

constexpr int kCBlock = 2048;          // ops/kernels.py:CBLOCK
constexpr int kMaxParts = 16;
constexpr int kMaxVals = 16;
constexpr int kMaxIds = 16;
constexpr int kMaxExt = 16;
constexpr int kWarps = pinot::kThreads / 32;
constexpr int kScanThreads = 1024;     // K16's one block a segment

struct CompactLanes {
  const int8_t* part[kMaxParts];
  const void* val[kMaxVals];
  int val_elem[kMaxVals];
  const void* id[kMaxIds];
  int id_elem[kMaxIds];
};

__global__ void block_compact_kernel(const uint8_t* __restrict__ mask, KeyLanes keys_p,
                                     int n_keys, int w_total, CompactLanes lanes_p, int n_parts,
                                     int n_vals, int n_ids, long long n_blocks, int g_pad, int r,
                                     int* __restrict__ keys_out, int8_t* __restrict__ parts_out,
                                     double* __restrict__ vals_out, int* __restrict__ ids_out,
                                     int* __restrict__ overflow, int* __restrict__ matched) {
  __shared__ KeyLanes keys;
  __shared__ CompactLanes lanes;
  __shared__ int warp_n[kWarps];
  __shared__ int scratch[32];
  int local = 0;                        // matched docs, each once
  if (threadIdx.x == 0) {
    keys = keys_p;
    lanes = lanes_p;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cap = n_blocks * r;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    int running = 0;                    // matched rows of the block so far
    for (int it = 0; it < kCBlock / pinot::kThreads; ++it) {
      const long long e = b * kCBlock + it * pinot::kThreads + threadIdx.x;
      const long long doc = w_total == 1 ? e : e / w_total;
      int key = 0;
      bool ok = mask[doc] != 0;
      if (ok && e == doc * w_total) ++local;
      if (ok) {
        key = pinot::sv_key(keys, n_keys, doc);
        ok = pinot::mv_key(keys, n_keys, doc, static_cast<int>(e - doc * w_total), &key);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_n[warp] = __popc(bal);
      __syncthreads();
      int before = running, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int n = warp_n[w];
        before += w < warp ? n : 0;
        total += n;
      }
      const int rank = before + __popc(bal & ((1u << lane) - 1u));
      if (ok && rank < r) {
        const long long slot = b * r + rank;
        keys_out[slot] = min(max(key, 0), g_pad - 1);
        for (int l = 0; l < n_parts; ++l) parts_out[l * cap + slot] = lanes.part[l][doc];
        for (int v = 0; v < n_vals; ++v)
          vals_out[v * cap + slot] = pinot::read_value(lanes.val[v], lanes.val_elem[v], doc);
        for (int i = 0; i < n_ids; ++i)
          ids_out[i * cap + slot] = pinot::read_id(lanes.id[i], lanes.id_elem[i], doc);
      }
      running += total;
      __syncthreads();                  // warp_n is rewritten next
    }
    for (int s = min(running, r) + threadIdx.x; s < r; s += blockDim.x) {
      const long long slot = b * r + s;
      keys_out[slot] = g_pad;
      for (int l = 0; l < n_parts; ++l) parts_out[l * cap + slot] = 0;
      for (int v = 0; v < n_vals; ++v) vals_out[v * cap + slot] = 0.0;
      for (int i = 0; i < n_ids; ++i) ids_out[i * cap + slot] = 0;
    }
    if (threadIdx.x == 0 && running > r) atomicExch(overflow, 1);
  }
  const int total = pinot::block_sum(local, scratch);
  if (threadIdx.x == 0 && total != 0) atomicAdd(matched, total);
}

// K14's warp route, for keys without an MV key (a row is matched iff its
// mask byte is nonzero) and r <= kWarpSlots: one warp a 2,048-row block,
// no block barrier in the loop. block_compact_kernel above walks a block
// in 8 steps of 256 rows, each reading one mask byte a thread between two
// __syncthreads (~2 KB in flight an SM; 57x its bound at SSB Q2.1). Here
// lane l reads 16-byte words l, l + 32, l + 64, l + 96 of the block's
// mask (rows [16 w, 16 w + 16) of word w), all four at once, 64 bytes a
// thread in flight. Each round of 32 words (512 rows in row order) counts
// its nonzero bytes a lane, and a __shfl_up_sync scan gives each lane the
// rank of its first matched row; the lane writes the rows of ranks below
// r, in row order, into its warp's list in shared memory. Then the warp's
// lanes take the r slots in turn (slot s: lane s % 32), so the gathers of
// the matched rows' keys, parts, values and ids and the slot writes are
// spread over the warp and coalesced, and slots past the matches get key
// g_pad and zeros. At SSB Q2.1 (16 matched rows a block) the warps of the
// whole mask are resident at once, and the time is each warp's chain of
// device-memory waits: the mask, then the gathers, which the first
// kGatherParts part loads join so that they wait once with the key's.
// The key and lane tables are read in place from the launch's parameters,
// with no copy to shared memory and no barrier before the first load.
constexpr int kWarpSlots = 256;        // ops/kernels.py:SORTED_RUNG_R
constexpr int kGatherParts = 4;        // part loads a slot issues together

// the bytes of w that are nonzero, as bit 7 of each byte
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

__global__ void __launch_bounds__(pinot::kThreads)
    block_compact_warp_kernel(const uint8_t* __restrict__ mask,
                              const __grid_constant__ KeyLanes keys, int n_keys,
                              const __grid_constant__ CompactLanes lanes, int n_parts,
                              int n_vals, int n_ids, long long n_blocks, int g_pad, int r,
                              int* __restrict__ keys_out, int8_t* __restrict__ parts_out,
                              double* __restrict__ vals_out, int* __restrict__ ids_out,
                              int* __restrict__ overflow, int* __restrict__ matched) {
  // keys and lanes: a __grid_constant__ struct indexed at run time is
  // read in place, with no local copy
  __shared__ int docs[kWarps][kWarpSlots];   // a warp's matched rows by rank
  __shared__ int warp_matched[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long cap = n_blocks * r;
  int* list = docs[warp];
  int local = 0;                        // matched rows (docs) of this warp
  for (long long b = static_cast<long long>(blockIdx.x) * kWarps + warp; b < n_blocks;
       b += static_cast<long long>(gridDim.x) * kWarps) {
    const uint4* m = reinterpret_cast<const uint4*>(mask + b * kCBlock);
    uint4 q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = m[k * 32 + lane];
    unsigned nz[16];                    // round k's word i: nz[4 k + i]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      nz[4 * k] = nonzero_bytes(q[k].x);
      nz[4 * k + 1] = nonzero_bytes(q[k].y);
      nz[4 * k + 2] = nonzero_bytes(q[k].z);
      nz[4 * k + 3] = nonzero_bytes(q[k].w);
    }
    int first[4];                       // each round's first rank of the lane
    int running = 0;                    // matched rows of the earlier rounds
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cnt = __popc(nz[4 * k]) + __popc(nz[4 * k + 1]) + __popc(nz[4 * k + 2]) +
                      __popc(nz[4 * k + 3]);
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      first[k] = running + incl - cnt;
      running += __shfl_sync(0xffffffffu, incl, 31);
    }
    // the lane's matched rows by rank, in row order, those below r listed
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int rank = first[k];
      const int row0 = (k * 32 + lane) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned bits = nz[4 * k + i];
        if (bits != 0u && rank < r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if ((bits >> (8 * j + 7)) & 1u) {
              if (rank < r) list[rank] = row0 + 4 * i + j;
              ++rank;
            }
          }
        }
      }
    }
    local += running;
    __syncwarp();
    const int taken = min(running, r);
    for (int s = lane; s < r; s += 32) {
      const long long slot = b * r + s;
      if (s < taken) {
        const long long doc = b * kCBlock + list[s];
        // the first kGatherParts parts' loads in flight with the key's
        int part[kGatherParts];
#pragma unroll
        for (int l = 0; l < kGatherParts; ++l)
          if (l < n_parts) part[l] = lanes.part[l][doc];
        keys_out[slot] = min(max(pinot::sv_key(keys, n_keys, doc), 0), g_pad - 1);
#pragma unroll
        for (int l = 0; l < kGatherParts; ++l)
          if (l < n_parts) parts_out[l * cap + slot] = static_cast<int8_t>(part[l]);
        for (int l = kGatherParts; l < n_parts; ++l)
          parts_out[l * cap + slot] = lanes.part[l][doc];
        for (int v = 0; v < n_vals; ++v)
          vals_out[v * cap + slot] = pinot::read_value(lanes.val[v], lanes.val_elem[v], doc);
        for (int i = 0; i < n_ids; ++i)
          ids_out[i * cap + slot] = pinot::read_id(lanes.id[i], lanes.id_elem[i], doc);
      } else {
        keys_out[slot] = g_pad;
        for (int l = 0; l < n_parts; ++l) parts_out[l * cap + slot] = 0;
        for (int v = 0; v < n_vals; ++v) vals_out[v * cap + slot] = 0.0;
        for (int i = 0; i < n_ids; ++i) ids_out[i * cap + slot] = 0;
      }
    }
    if (lane == 0 && running > r) atomicExch(overflow, 1);
    __syncwarp();                       // the list is rewritten next
  }
  if (lane == 0) warp_matched[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_matched[w];
    if (total != 0) atomicAdd(matched, total);
  }
}

struct SlotLanes {
  const int8_t* part[kMaxParts];
  const double* sum[kMaxVals];
  const void* ext[kMaxExt];    // int32 ids (id modes) or float64 values
};

struct SlotLoad {
  const SlotLanes& r;
  long long i;
  __device__ int part(int l) const { return r.part[l][i]; }
  __device__ double sum(int j) const { return r.sum[j][i]; }
  __device__ int id(int e) const { return static_cast<const int*>(r.ext[e])[i]; }
  __device__ double raw(int e) const { return static_cast<const double*>(r.ext[e])[i]; }
};

// The device tables' starting values, the first of K15's two launches.
__global__ void __launch_bounds__(pinot::kThreads)
    slot_init_kernel(const __grid_constant__ fold::Tables t, int chunks) {
  fold::init_tables(t, chunks);
}

// K15's fold: every slot, 32 consecutive ones a warp (one coalesced read
// of gslot), the invalid ones (gslot outside [0, t_slots)) dropped by
// predicate; each valid lane reads its part, sum and extreme lanes, then
// the warp folds (group_fold.cuh). A warp with no valid slot issues no
// more than its gslot read.
__global__ void __launch_bounds__(fold::kFoldThreads, 2)
    slot_fold_kernel(const int* __restrict__ gslot, long long n_slots, long long cap,
                     long long chunk_slots, const __grid_constant__ SlotLanes lanes,
                     const __grid_constant__ fold::Tables t, int route, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double scratch[fold::kWarps * 32];
  const fold::Ctx c = fold::begin(t, route, S, smem, scratch);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool one_chunk = t.wide || chunk_slots >= cap;   // no 64-bit division a slot
  const long long stride = static_cast<long long>(gridDim.x) * fold::kWarps * 32;
  for (long long b0 = (static_cast<long long>(blockIdx.x) * fold::kWarps + warp) * 32;
       b0 < n_slots; b0 += stride) {
    const long long i = b0 + lane;
    const int key = i < n_slots ? gslot[i] : -1;
    const bool valid = key >= 0 && key < t.t_slots;
    const SlotLoad ld{lanes, i};
    const fold::Vals v = fold::load_vals(t, valid, ld);
    const int chunk = valid && !one_chunk ? static_cast<int>((i % cap) / chunk_slots) : 0;
    fold::warp_fold(t, c, valid, key, chunk, v, ld);
  }
  fold::end(t, c);
}

// Block-wide exclusive int scan over kScanThreads threads; *total gets the
// block's sum. Every thread must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();                      // warp_tot may still be read
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];             // kScanThreads / 32 == 32 warps
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    warp_tot[lane] = wi - w;            // exclusive prefix of the warps
    if (lane == 31) warp_tot[32] = wi;
  }
  __syncthreads();
  *total = warp_tot[32];
  return warp_tot[warp] + incl - v;
}

__global__ void rank_mark_kernel(const int* __restrict__ kc, long long n, long long cap,
                                 int g_pad, long long words, unsigned* __restrict__ bitmap) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int k = kc[i];
    if (k < 0 || k >= g_pad) continue;
    atomicOr(bitmap + (i / cap) * words + (k >> 5), 1u << (k & 31));
  }
}

// One block a segment: the exclusive prefix of the bitmap words'
// popcounts, rkeys from the set bits in ascending order, g_pad after them.
__global__ void rank_scan_kernel(const unsigned* __restrict__ bitmap, long long words,
                                 long long cap, int g_pad, int* __restrict__ prefix,
                                 int* __restrict__ rkeys, int* __restrict__ n_distinct) {
  __shared__ int warp_tot[33];
  const long long s = blockIdx.x;
  const unsigned* bm = bitmap + s * words;
  int* pre = prefix + s * words;
  int* rk = rkeys + s * cap;
  int running = 0;
  for (long long w0 = 0; w0 < words; w0 += kScanThreads) {
    const long long w = w0 + threadIdx.x;
    unsigned bits = w < words ? bm[w] : 0u;
    int tile = 0;
    const int ex = running + block_exclusive_scan(__popc(bits), warp_tot, &tile);
    if (w < words) {
      pre[w] = ex;
      for (int k = ex; bits; ++k, bits &= bits - 1)
        rk[k] = static_cast<int>(w * 32 + __ffs(bits) - 1);
    }
    running += tile;
  }
  for (long long k = running + threadIdx.x; k < cap; k += blockDim.x) rk[k] = g_pad;
  if (threadIdx.x == 0) n_distinct[s] = running;
}

__global__ void rank_assign_kernel(const int* __restrict__ kc, long long n, long long cap,
                                   int g_pad, long long words, const unsigned* __restrict__ bitmap,
                                   const int* __restrict__ prefix, int* __restrict__ gslot) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int k = kc[i];
    if (k < 0 || k >= g_pad) {
      gslot[i] = static_cast<int>(n);   // the drop slot
      continue;
    }
    const long long s = i / cap, at = s * words + (k >> 5);
    gslot[i] = static_cast<int>(s * cap + prefix[at] +
                                __popc(bitmap[at] & ((1u << (k & 31)) - 1u)));
  }
}

// One block a segment over its cap keys sorted by K12 (perm: the slot of
// each sorted position): a new key starts a rank.
__global__ void rank_sorted_kernel(const int* __restrict__ sk, const int* __restrict__ perm,
                                   long long n, long long cap, int g_pad,
                                   int* __restrict__ gslot, int* __restrict__ rkeys,
                                   int* __restrict__ n_distinct) {
  __shared__ int warp_tot[33];
  const long long s = blockIdx.x, lo = s * cap;
  int running = 0;
  for (long long j0 = 0; j0 < cap; j0 += kScanThreads) {
    const long long j = j0 + threadIdx.x;
    const int k = j < cap ? sk[lo + j] : g_pad;
    const bool valid = k >= 0 && k < g_pad;
    const bool first = valid && (j == 0 || sk[lo + j - 1] != k);
    int tile = 0;
    const int ex = running + block_exclusive_scan(first ? 1 : 0, warp_tot, &tile);
    if (j < cap) {
      const int rank = ex + (first ? 1 : 0) - 1;
      gslot[perm[lo + j]] = valid ? static_cast<int>(lo + rank) : static_cast<int>(n);
      if (first) rkeys[lo + rank] = k;
    }
    running += tile;
  }
  for (long long k = running + threadIdx.x; k < cap; k += blockDim.x) rkeys[lo + k] = g_pad;
  if (threadIdx.x == 0) n_distinct[s] = running;
}

}  // namespace

extern "C" int pinot_block_compact(
    const void* mask, const void* const* key_ptrs, const int* key_elems,
    const int* key_strides, const int* key_kinds, const int* key_widths,
    const int* key_limits, const long long* key_offsets,
    const void* const* key_members, const int* key_mlens,
    const void* const* key_tables, const void* const* key_codes, const int* key_tlens,
    int n_keys, const void* const* part_ptrs, int n_parts, const void* const* val_ptrs,
    const int* val_elems, int n_vals, const void* const* id_ptrs, const int* id_elems,
    int n_ids, long long n_rows, int g_pad, int r, void* keys_out, void* parts_out,
    void* vals_out, void* ids_out, void* overflow, void* matched, int warp, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_vals < 0 || n_vals > kMaxVals || n_ids < 0 ||
      n_ids > kMaxIds || g_pad < 1 || r < 1 || r > kCBlock || n_rows % kCBlock != 0 ||
      (warp && (r > kWarpSlots || reinterpret_cast<uintptr_t>(mask) % 16 != 0)))
    return -1;
  KeyLanes keys;
  int n_mv = 0;
  long long w_total = 1;
  if (!pinot::fill_key_lanes(&keys, n_keys, key_ptrs, key_elems, key_strides, key_kinds,
                             key_widths, key_limits, key_offsets, key_members, key_mlens,
                             key_tables, key_codes, key_tlens, &n_mv, &w_total))
    return -1;
  CompactLanes lanes{};
  for (int l = 0; l < n_parts; ++l) lanes.part[l] = static_cast<const int8_t*>(part_ptrs[l]);
  for (int v = 0; v < n_vals; ++v) {
    lanes.val[v] = val_ptrs[v];
    lanes.val_elem[v] = val_elems[v];
  }
  for (int i = 0; i < n_ids; ++i) {
    lanes.id[i] = id_ptrs[i];
    lanes.id_elem[i] = id_elems[i];
  }
  const long long n_blocks = n_rows / kCBlock;
  if (warp) {
    if (n_mv != 0) return -1;
    const int grid = pinot::grid_for(block_compact_warp_kernel, n_blocks * 32, 0);
    block_compact_warp_kernel<<<grid, pinot::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(mask), keys, n_keys, lanes, n_parts, n_vals, n_ids, n_blocks,
        g_pad, r, static_cast<int*>(keys_out), static_cast<int8_t*>(parts_out),
        static_cast<double*>(vals_out), static_cast<int*>(ids_out), static_cast<int*>(overflow),
        static_cast<int*>(matched));
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = pinot::grid_for(block_compact_kernel, n_blocks * pinot::kThreads, 0);
  block_compact_kernel<<<grid, pinot::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), keys, n_keys, static_cast<int>(w_total), lanes, n_parts,
      n_vals, n_ids, n_blocks, g_pad, r, static_cast<int*>(keys_out),
      static_cast<int8_t*>(parts_out), static_cast<double*>(vals_out),
      static_cast<int*>(ids_out), static_cast<int*>(overflow), static_cast<int*>(matched));
  return static_cast<int>(cudaGetLastError());
}

// Route codes (ops/kernels.py:FOLD_ROUTES): 0 global, 1 smem.
// `bound_items` > 0: a wide launch's shared int32 part sums, the slots a
// block may fold at most (ops/kernels.py:FOLD_BOUND_ITEMS).
extern "C" int pinot_slot_tables(
    const void* gslot, long long n_slots, long long cap, long long chunk_slots,
    const void* const* part_ptrs, int n_parts, const void* const* sum_ptrs, int n_sums,
    const void* const* ext_ptrs, const int* ext_modes, const int* ext_inits,
    void* const* ext_outs, int n_ext, int t_slots, int route, long long bound_items,
    int psums_wide, void* count, void* psums, void* csums, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_sums < 0 || n_sums > kMaxVals || n_ext < 0 ||
      n_ext > kMaxExt || t_slots < 1 || cap < 1 || chunk_slots < 1 || route < fold::kGlobal ||
      route > fold::kSmem || bound_items < 0)
    return -1;
  SlotLanes lanes{};
  for (int l = 0; l < n_parts; ++l) lanes.part[l] = static_cast<const int8_t*>(part_ptrs[l]);
  for (int j = 0; j < n_sums; ++j) lanes.sum[j] = static_cast<const double*>(sum_ptrs[j]);
  fold::Tables t{};
  t.count = static_cast<int*>(count);
  t.psums = psums_wide ? nullptr : static_cast<int*>(psums);
  t.psums64 = psums_wide ? static_cast<unsigned long long*>(psums) : nullptr;
  t.csums = static_cast<double*>(csums);
  t.n_parts = n_parts;
  t.n_sums = n_sums;
  t.t_slots = t_slots;
  t.wide = psums_wide;
  if (!fold::set_ext(&t, n_ext, ext_modes, ext_inits, ext_outs)) return -1;
  for (int e = 0; e < n_ext; ++e) lanes.ext[e] = ext_ptrs[e];
  const long long chunks = psums_wide ? 1 : (cap + chunk_slots - 1) / chunk_slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the device tables' starting values, then the fold: on `smem` a
  // block's shared table (one int32 chunk a slot's table: the sums of a
  // segment's cap, or a stack's wide ones, which each block keeps below
  // 2^31: at most bound_items plus its last pass of kFoldThreads slots)
  fold::Shape sh;
  if (route == fold::kSmem) {
    if (chunks != 1 || (bound_items > 0 && fold::kFoldThreads > bound_items)) return -2;
    sh = fold::shared_shape(slot_fold_kernel, t, n_slots, bound_items, n_slots / 32 + 1);
    if (sh.ctas == 0) return -2;
  } else {
    sh.ctas = fold::global_ctas(slot_fold_kernel, n_slots / 32 + 1);
  }
  slot_init_kernel<<<pinot::grid_for(slot_init_kernel, t_slots, 0), pinot::kThreads, 0, s>>>(
      t, static_cast<int>(chunks));
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  slot_fold_kernel<<<sh.ctas, fold::kFoldThreads, sh.smem, s>>>(
      static_cast<const int*>(gslot), n_slots, cap, chunk_slots, lanes, t, route, sh.S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pinot_slot_tables_caps(int* out) { return fold::caps(slot_fold_kernel, out); }

// K16 by either route. The bitmap route (sk == nullptr): `bitmap`
// (uint32 [S, words], zeroed) and `prefix` (int32 [S, words]) are the
// caller's scratch. The sort route: sk and perm are each segment's cap
// keys as K12 sorted them and the slot of each sorted position.
extern "C" int pinot_rank_slots(const void* kc, long long n, long long cap, int g_pad,
                                void* bitmap, void* prefix, const void* sk, const void* perm,
                                void* gslot, void* rkeys, void* n_distinct, void* stream) {
  if (cap < 1 || n < cap || n % cap != 0 || g_pad < 1) return -1;
  const long long segs = n / cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sk != nullptr) {
    rank_sorted_kernel<<<static_cast<int>(segs), kScanThreads, 0, st>>>(
        static_cast<const int*>(sk), static_cast<const int*>(perm), n, cap, g_pad,
        static_cast<int*>(gslot), static_cast<int*>(rkeys), static_cast<int*>(n_distinct));
    return static_cast<int>(cudaGetLastError());
  }
  const long long words = (static_cast<long long>(g_pad) + 31) / 32;
  const int grid = pinot::grid_for(n);
  rank_mark_kernel<<<grid, pinot::kThreads, 0, st>>>(static_cast<const int*>(kc), n, cap, g_pad,
                                                     words, static_cast<unsigned*>(bitmap));
  rank_scan_kernel<<<static_cast<int>(segs), kScanThreads, 0, st>>>(
      static_cast<const unsigned*>(bitmap), words, cap, g_pad, static_cast<int*>(prefix),
      static_cast<int*>(rkeys), static_cast<int*>(n_distinct));
  rank_assign_kernel<<<grid, pinot::kThreads, 0, st>>>(
      static_cast<const int*>(kc), n, cap, g_pad, words, static_cast<const unsigned*>(bitmap),
      static_cast<const int*>(prefix), static_cast<int*>(gslot));
  return static_cast<int>(cudaGetLastError());
}
