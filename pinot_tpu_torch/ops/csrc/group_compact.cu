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
// raise `overflow`. For MV keys the rows are _expand_mv_group's: P * W
// expanded rows (doc-major, entry combination minor, first MV key
// fastest), walked in the kernel and never written; a combination whose
// entry is padding or outside its member table is not matched, and the
// blocks are those of the expanded rows, as in JAX. Each slot gets the
// int32 group key (group_key.cuh's evaluator, the one K3 uses), each
// int8 part value, each float64 value (sum lanes and raw min / max
// lanes) and each int32 dictId (id min / max lanes) of its row; unused
// slots get key g_pad and zeros. It also counts the matched docs, once
// each (the plan's numDocsScanned). JAX carries keys and ids in 7-bit planes
// only to feed its matrix unit; here they are words. A block's ranks come
// from a warp ballot and popcount, then a scan of the 8 warps' counts in
// shared memory, 256 rows at a time in row order, so every slot holds the
// row JAX's one-hot matmul puts there.
//
// K15: count, part sums, float64 sums and min / max over the slots,
// addressed by gslot (a key for the dense layout, a rank for the ranked
// one; gslot >= t_slots drops the slot). Part sums are int32 and exact,
// one table per `chunk_slots` slots of a segment's cap (JAX's
// DENSE_ROWS_LIMIT macro-chunks, :1157-1167), or one int64 table over a
// stack (`psums_wide`, 64-bit atomics); float64 sums use atomicAdd, in a
// run-dependent order, so they are held to a tolerance; id min / max are
// int32 atomics, raw ones compare-and-swap loops (atomic_extreme). Tables
// of at most `smem_slots` slots that fit are folded per block in shared
// memory and merged once per touched slot, as K3 does.
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
// The design keeps the row order with one ballot a warp and no sort, and
// reads a row's lanes only when it takes a slot.

#include "group_key.cuh"

namespace {

using pinot::KeyLanes;
using pinot::atomic_extreme;

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

enum ExtMode : int { kIdMin = 0, kIdMax = 1, kRawMin = 2, kRawMax = 3 };

__host__ __device__ __forceinline__ bool is_raw(int mode) { return mode == kRawMin || mode == kRawMax; }

struct SlotLanes {
  const int8_t* part[kMaxParts];
  const double* sum[kMaxVals];
  const void* ext[kMaxExt];    // int32 ids (id modes) or float64 values
  int ext_mode[kMaxExt];
  int ext_init[kMaxExt];       // id tables: the sentinel the table starts at
  int ext_slot[kMaxExt];       // index among the id tables or the raw ones
  void* ext_out[kMaxExt];      // int32 or float64 [t_slots]
};

__global__ void slot_tables_kernel(const int* __restrict__ gslot, long long n_slots,
                                   long long cap, long long chunk_slots, SlotLanes lanes_p,
                                   int n_parts, int n_sums, int n_ext, int n_raw, int t_slots,
                                   int use_smem, int psums_wide, int* __restrict__ count,
                                   void* __restrict__ psums_out, double* __restrict__ csums) {
  int* const psums = psums_wide ? nullptr : static_cast<int*>(psums_out);
  unsigned long long* const psums64 =
      psums_wide ? static_cast<unsigned long long*>(psums_out) : nullptr;
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ SlotLanes lanes;
  if (threadIdx.x == 0) lanes = lanes_p;
  __syncthreads();

  int* t_count = count;
  int* t_psums = psums;
  double* t_csums = csums;
  int* t_idext = nullptr;
  double* t_rawext = nullptr;
  if (use_smem) {   // one chunk, int32 part sums: the caller checked
    double* d = reinterpret_cast<double*>(smem);
    t_csums = d;
    t_rawext = d + static_cast<long long>(n_sums) * t_slots;
    int* i = reinterpret_cast<int*>(t_rawext + static_cast<long long>(n_raw) * t_slots);
    t_count = i;
    t_psums = i + t_slots;
    t_idext = t_psums + static_cast<long long>(n_parts) * t_slots;
    for (int s = threadIdx.x; s < t_slots; s += blockDim.x) {
      t_count[s] = 0;
      for (int l = 0; l < n_parts; ++l) t_psums[l * t_slots + s] = 0;
      for (int j = 0; j < n_sums; ++j) t_csums[j * t_slots + s] = 0.0;
      for (int e = 0; e < n_ext; ++e) {
        const int m = lanes.ext_mode[e], at = lanes.ext_slot[e] * t_slots + s;
        if (is_raw(m))
          t_rawext[at] = m == kRawMin ? INFINITY : -INFINITY;
        else
          t_idext[at] = lanes.ext_init[e];
      }
    }
    __syncthreads();
  }

  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_slots;
       i += step) {
    const int g = gslot[i];
    if (g < 0 || g >= t_slots) continue;              // the drop slot
    atomicAdd(t_count + g, 1);
    const long long chunk = (i % cap) / chunk_slots;   // 0 when use_smem
    for (int l = 0; l < n_parts; ++l) {
      const int p = lanes.part[l][i];
      if (p == 0) continue;
      if (psums64 && !use_smem)
        atomicAdd(psums64 + static_cast<long long>(l) * t_slots + g,
                  static_cast<unsigned long long>(p));
      else
        atomicAdd(t_psums + (chunk * n_parts + l) * t_slots + g, p);
    }
    for (int j = 0; j < n_sums; ++j)
      atomicAdd(t_csums + static_cast<long long>(j) * t_slots + g, lanes.sum[j][i]);
    for (int e = 0; e < n_ext; ++e) {
      const int m = lanes.ext_mode[e];
      const long long at = use_smem ? static_cast<long long>(lanes.ext_slot[e]) * t_slots + g : g;
      if (is_raw(m))
        atomic_extreme((use_smem ? t_rawext : static_cast<double*>(lanes.ext_out[e])) + at,
                       static_cast<const double*>(lanes.ext[e])[i], m == kRawMin);
      else
        atomic_extreme((use_smem ? t_idext : static_cast<int*>(lanes.ext_out[e])) + at,
                       static_cast<const int*>(lanes.ext[e])[i], m == kIdMin);
    }
  }

  if (use_smem) {   // merge the slots this block touched
    __syncthreads();
    for (int s = threadIdx.x; s < t_slots; s += blockDim.x) {
      const int c = t_count[s];
      if (c == 0) continue;
      atomicAdd(count + s, c);
      for (int l = 0; l < n_parts; ++l) {
        const int p = t_psums[l * t_slots + s];
        if (p == 0) continue;
        if (psums64)
          atomicAdd(psums64 + static_cast<long long>(l) * t_slots + s,
                    static_cast<unsigned long long>(static_cast<unsigned>(p)));
        else
          atomicAdd(psums + static_cast<long long>(l) * t_slots + s, p);
      }
      for (int j = 0; j < n_sums; ++j)
        atomicAdd(csums + static_cast<long long>(j) * t_slots + s, t_csums[j * t_slots + s]);
      for (int e = 0; e < n_ext; ++e) {
        const int m = lanes.ext_mode[e], at = lanes.ext_slot[e] * t_slots + s;
        if (is_raw(m))
          atomic_extreme(static_cast<double*>(lanes.ext_out[e]) + s, t_rawext[at], m == kRawMin);
        else
          atomic_extreme(static_cast<int*>(lanes.ext_out[e]) + s, t_idext[at], m == kIdMin);
      }
    }
  }
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
    void* vals_out, void* ids_out, void* overflow, void* matched, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_vals < 0 || n_vals > kMaxVals || n_ids < 0 ||
      n_ids > kMaxIds || g_pad < 1 || r < 1 || r > kCBlock || n_rows % kCBlock != 0)
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
  const int grid = pinot::grid_for(block_compact_kernel, n_blocks * pinot::kThreads, 0);
  block_compact_kernel<<<grid, pinot::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), keys, n_keys, static_cast<int>(w_total), lanes, n_parts,
      n_vals, n_ids, n_blocks, g_pad, r, static_cast<int*>(keys_out),
      static_cast<int8_t*>(parts_out), static_cast<double*>(vals_out),
      static_cast<int*>(ids_out), static_cast<int*>(overflow), static_cast<int*>(matched));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pinot_slot_tables(
    const void* gslot, long long n_slots, long long cap, long long chunk_slots,
    const void* const* part_ptrs, int n_parts, const void* const* sum_ptrs, int n_sums,
    const void* const* ext_ptrs, const int* ext_modes, const int* ext_inits,
    void* const* ext_outs, int n_ext, int t_slots, int smem_slots, int psums_wide, void* count,
    void* psums, void* csums, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_sums < 0 || n_sums > kMaxVals || n_ext < 0 ||
      n_ext > kMaxExt || t_slots < 1 || cap < 1 || chunk_slots < 1)
    return -1;
  SlotLanes lanes{};
  for (int l = 0; l < n_parts; ++l) lanes.part[l] = static_cast<const int8_t*>(part_ptrs[l]);
  for (int j = 0; j < n_sums; ++j) lanes.sum[j] = static_cast<const double*>(sum_ptrs[j]);
  int n_raw = 0;
  for (int e = 0; e < n_ext; ++e) {
    if (ext_modes[e] < kIdMin || ext_modes[e] > kRawMax) return -1;
    lanes.ext[e] = ext_ptrs[e];
    lanes.ext_mode[e] = ext_modes[e];
    lanes.ext_init[e] = ext_inits[e];
    lanes.ext_slot[e] = is_raw(ext_modes[e]) ? n_raw++ : e - n_raw;
    lanes.ext_out[e] = ext_outs[e];
  }
  // shared tables: float64 sums and raw extremes, then int32 count, part
  // sums and id extremes; only for one chunk whose int32 sums stay exact
  const long long table_bytes = static_cast<long long>(t_slots) *
      (8LL * (n_sums + n_raw) + 4LL * (1 + n_parts + n_ext - n_raw));
  int device = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncGetAttributes(&attr, slot_tables_kernel);
  const long long room = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  const int use_smem = t_slots <= smem_slots && table_bytes <= room &&
                       n_slots <= chunk_slots && 127LL * n_slots < (1LL << 31) ? 1 : 0;
  const size_t smem = use_smem ? static_cast<size_t>(table_bytes) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        slot_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int grid = pinot::grid_for(slot_tables_kernel, n_slots, smem);
  slot_tables_kernel<<<grid, pinot::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gslot), n_slots, cap, chunk_slots, lanes, n_parts, n_sums, n_ext,
      n_raw, t_slots, use_smem, psums_wide, static_cast<int*>(count), psums,
      static_cast<double*>(csums));
  return static_cast<int>(cudaGetLastError());
}

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
