// The group-table fold that K3 (dense_group_aggregate.cu) and K15
// (group_compact.cu, slot_tables) share: per-group count, int8 part sums
// (int32, or int64 over a stack), float64 sums and id / raw min / max,
// folded one (key, item) a lane, a warp at a time.
//
// The shape of a call. Each kernel is two launches. The first writes the
// device tables' starting values (init_tables); K3's (list_kernel), whose
// few registers keep its whole mask in flight, also lists the matched
// rows, so that its fold kernel takes them in batches of 32, a batch a
// warp, every batch full but the last, and pays the gathers' latency once
// a 32 matched rows, not once a row. K15's fold kernel reads its slots 32
// consecutive ones a warp and drops the invalid ones by predicate. The
// device tables are views of one buffer that the wrapper carves
// (ops/kernels.py:fold_layout): count int32 [T], part sums int32 [C][L][T]
// (C chunks of rows, K15's DENSE_ROWS_LIMIT chunks; K3 has one) or int64
// [L][T] (`wide`), float64 sums [J][T], one int32 or float64 [T] table per
// extreme, and K3's list's length and list.
//
// Two routes, which the wrapper picks by fit (ops/kernels.py:fold_route)
// and a check can force:
//   smem:    each block folds into its own copy of the whole table in
//            shared memory (up to the opt-in 227 KB a block), then merges
//            the slots it touched (count > 0) with one device atomic a
//            slot and table, each block starting its walk at another slot;
//            a launch takes at most one block a table's worth of items
//            (blocks x T <= the rows or slots read);
//   global:  the device tables directly, for tables no block holds.
//
// Atomics. On the smem route each lane issues its own integer and
// extreme shared atomics: a block's own table takes them, contended,
// faster than a warp's combines (match, reductions, a leader's reads) on
// the card; float64 sums, whose atomics on one shared address queue, are
// added in the warp first (lanes of one key, through its scratch) and
// one lane adds the group's sum. On the global route
// lanes that hold the same key (__match_any_sync) fold together and one
// lane, the lowest, issues each atomic: counts add the group's
// population, int part sums and id extremes combine with
// __reduce_add_sync / __reduce_min_sync / __reduce_max_sync over the
// group's mask, float64 sums and raw extremes through the warp's shared
// scratch (the leader reads its peers', in lane order), so a hot group
// costs one device atomic a warp, not 32 queued on one address. A shared
// table keeps raw extremes as order-preserving int64 keys (raw_key), so it
// takes native 64-bit atomicMin / atomicMax; device tables take
// compare-and-swap loops. No atomic returns a value the fold waits for. Integer sums stay exact and order-free
// (int32 wraps as the plain version's index_add_ does), extremes equal;
// float64 sums change their addition order and stay within CSUMS_RTOL. A
// raw extreme keeps NaN: a NaN value wins the combine and the atomic, as
// XLA's min and max propagate it.
//
// Exactness of int32 shared part sums over a stack (`wide`, an int64
// device table): a block folds at most 127 x (its items) x W_total, which
// stays below 2^31 by the number of blocks the launch takes (shared_shape:
// the caller's bound on a block's items, ops/kernels.py:FOLD_BOUND_ITEMS).
#pragma once

#include <climits>

#include "common.cuh"

namespace pinot {
namespace fold {

constexpr int kMaxExt = 16;
constexpr int kGather = 4;             // a lane's loads of a kind issued before its folds
// threads a block of a fold kernel: twice the other kernels', so that a
// table filling one SM's shared memory still has 16 warps to hide the
// gathers' latency
constexpr int kFoldThreads = 512;
constexpr int kWarps = kFoldThreads / 32;
// blocks a launch on the smem route takes at most one for this many rows
// or slots read a table slot: their zeroing and merge never outgrow the
// fold
constexpr long long kRowsPerSlot = 1;

enum ExtMode : int { kIdMin = 0, kIdMax = 1, kRawMin = 2, kRawMax = 3 };
enum Route : int { kGlobal = 0, kSmem = 1 };

__host__ __device__ __forceinline__ bool is_raw(int mode) {
  return mode == kRawMin || mode == kRawMax;
}

// The device tables (views of one buffer) and what they hold.
struct Tables {
  int* count;                   // [T]
  int* psums;                   // int32 [C][L][T] unless wide
  unsigned long long* psums64;  // int64 [L][T] when wide
  double* csums;                // [J][T]
  void* ext[kMaxExt];           // int32 (id modes) or float64 [T]
  int ext_mode[kMaxExt];
  int ext_init[kMaxExt];        // id tables: the sentinel they start at
  int ext_slot[kMaxExt];        // index among the id tables or the raw ones
  int n_parts, n_sums, n_ext, n_raw;
  int t_slots;
  int wide;
};

// Fills the ext_* fields and n_raw; false on a mode the fold does not take.
inline bool set_ext(Tables* t, int n_ext, const int* modes, const int* inits,
                    void* const* outs) {
  if (n_ext < 0 || n_ext > kMaxExt) return false;
  t->n_ext = n_ext;
  t->n_raw = 0;
  for (int e = 0; e < n_ext; ++e) {
    if (modes[e] < kIdMin || modes[e] > kRawMax) return false;
    t->ext[e] = outs[e];
    t->ext_mode[e] = modes[e];
    t->ext_init[e] = inits[e];
    t->ext_slot[e] = is_raw(modes[e]) ? t->n_raw++ : e - t->n_raw;
  }
  return true;
}

// Bytes of a block's shared table of S slots (a multiple of 32): float64
// sums and raw extremes, then int32 count, part sums and id extremes.
__host__ __device__ __forceinline__ long long slice_bytes(const Tables& t, long long S) {
  return S * (8LL * (t.n_sums + t.n_raw) + 4LL * (1 + t.n_parts + t.n_ext - t.n_raw));
}

struct Slice {
  double* sums;       // [n_sums][S]
  long long* rawx;    // [n_raw][S], as raw_key
  int* count;         // [S]
  int* parts;         // [n_parts][S]
  int* idx;           // [n_id][S]
};

__device__ __forceinline__ Slice carve(unsigned char* base, const Tables& t, int S) {
  Slice s;
  s.sums = reinterpret_cast<double*>(base);
  s.rawx = reinterpret_cast<long long*>(s.sums + static_cast<long long>(t.n_sums) * S);
  s.count = reinterpret_cast<int*>(s.rawx + static_cast<long long>(t.n_raw) * S);
  s.parts = s.count + S;
  s.idx = s.parts + static_cast<long long>(t.n_parts) * S;
  return s;
}

// A raw extreme in a shared table is an int64 key whose signed order is
// the float64 order (the value's bits, a negative one's magnitude bits
// flipped), so a block's own table folds it with one native 64-bit
// atomicMin / atomicMax, not a compare-and-swap loop that hot slots
// retry; a NaN, which wins, is the key that wins (INT64_MIN for a min,
// INT64_MAX for a max), and decodes to a NaN at the merge.
__device__ __forceinline__ long long raw_key(double v, bool is_min) {
  if (isnan(v)) return is_min ? LLONG_MIN : LLONG_MAX;
  const long long b = __double_as_longlong(v);
  return b ^ ((b >> 63) & 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double raw_value(long long k, bool is_min) {
  if (k == (is_min ? LLONG_MIN : LLONG_MAX)) return __longlong_as_double(0x7ff8000000000000LL);
  return __longlong_as_double(k ^ ((k >> 63) & 0x7fffffffffffffffLL));
}

// The device tables' starting values (zeros; the id sentinels; +inf /
// -inf), one grid-stride pass of the calling grid: each kernel's first
// launch writes them (K3's beside its scan), so a call launches that
// kernel and the fold's, not one fill a table.
__device__ __forceinline__ void init_tables(const Tables& t, int chunks) {
  const long long T = t.t_slots;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = i0; i < T; i += step) {
    t.count[i] = 0;
    if (t.wide) {
      for (int l = 0; l < t.n_parts; ++l) t.psums64[l * T + i] = 0ULL;
    } else {
      for (long long c = 0; c < static_cast<long long>(chunks) * t.n_parts; ++c)
        t.psums[c * T + i] = 0;
    }
    for (int j = 0; j < t.n_sums; ++j) t.csums[j * T + i] = 0.0;
    for (int e = 0; e < t.n_ext; ++e) {
      const int m = t.ext_mode[e];
      if (is_raw(m))
        static_cast<double*>(t.ext[e])[i] = m == kRawMin ? INFINITY : -INFINITY;
      else
        static_cast<int*>(t.ext[e])[i] = t.ext_init[e];
    }
  }
}

// A block's view of where its folds land: its shared table of S slots at
// `base` (route smem), or the device tables (route global).
struct Ctx {
  int route;
  int S;
  unsigned char* base;
  double* scratch;      // this warp's 32 doubles
};

// Zero this block's shared table (sums, counts, parts) and set its
// extremes to their sentinels; the caller syncs the block.
__device__ __forceinline__ void zero_slice(const Tables& t, const Ctx& c) {
  const Slice s = carve(c.base, t, c.S);
  const int S = c.S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s.count[i] = 0;
    for (int l = 0; l < t.n_parts; ++l) s.parts[l * S + i] = 0;
    for (int j = 0; j < t.n_sums; ++j) s.sums[j * S + i] = 0.0;
    for (int e = 0; e < t.n_ext; ++e) {
      const int m = t.ext_mode[e], at = t.ext_slot[e] * S + i;
      if (is_raw(m))
        s.rawx[at] = raw_key(m == kRawMin ? INFINITY : -INFINITY, m == kRawMin);
      else
        s.idx[at] = t.ext_init[e];
    }
  }
}

// The float64 value of the group's lanes combined by the leader (the
// lowest lane of `peers`): sums, or extremes with NaN winning. Every lane
// of the warp calls it; `shared_keys` (some group holds two lanes) is
// warp-uniform, and without it every lane is its own group.
template <int kOp>   // 0 sum, 1 min, 2 max
__device__ __forceinline__ double group_combine(double v, unsigned peers, bool lead,
                                                bool shared_keys, double* scratch) {
  if (!shared_keys) return v;
  const int lane = threadIdx.x & 31;
  scratch[lane] = v;
  __syncwarp();
  if (lead) {
    for (unsigned m = peers & (peers - 1u); m; m &= m - 1u) {
      const double o = scratch[__ffs(m) - 1];
      if (kOp == 0)
        v += o;
      else if (!isnan(v) && (isnan(o) || (kOp == 1 ? o < v : o > v)))
        v = o;
    }
  }
  __syncwarp();
  return v;
}

// A lane's first kGather part, sum and extreme values, loaded before its
// key is matched so that their loads are in flight with the key's.
struct Vals {
  int part[kGather];
  double sum[kGather];
  double ext[kGather];   // an id extreme's int32 value, exactly
};

template <class Load>
__device__ __forceinline__ Vals load_vals(const Tables& t, bool valid, const Load& ld) {
  Vals v;
#pragma unroll
  for (int u = 0; u < kGather; ++u) {
    v.part[u] = valid && u < t.n_parts ? ld.part(u) : 0;
    v.sum[u] = valid && u < t.n_sums ? ld.sum(u) : 0.0;
    const bool here = valid && u < t.n_ext;
    v.ext[u] = !here ? 0.0 : is_raw(t.ext_mode[u]) ? ld.raw(u) : static_cast<double>(ld.id(u));
  }
  return v;
}

// The leader's target slot: the block's shared table (route smem) or the
// device tables.
struct Target {
  Slice s;
  int at;       // the key's slot
  bool shared;
};

__device__ __forceinline__ Target target(const Tables& t, const Ctx& c, int key) {
  Target g;
  g.shared = c.route == kSmem;
  g.at = key;
  if (g.shared) g.s = carve(c.base, t, c.S);
  return g;
}

// A raw extreme into the target: the shared table's key (`at` the table's
// offset in the shared table) through the native 64-bit atomicMin /
// atomicMax, skipped when the stored key already wins, or the device
// table's float64.
__device__ __forceinline__ void raw_extreme(const Target& g, int at, double* table, double v,
                                            bool is_min) {
  if (!g.shared) {
    atomic_extreme(table + g.at, v, is_min);
    return;
  }
  long long* k = g.s.rawx + at + g.at;
  const long long key = raw_key(v, is_min);
  if (is_min ? key < *k : key > *k) {
    if (is_min) atomicMin(k, key); else atomicMax(k, key);
  }
}

// One lane's item folded with its own atomics (no other lane of the warp
// holds its key, or the table is this block's own): into its slot of the
// shared table or of the device tables; float64 sums too unless `sums` is
// false (the caller adds them).
template <class Load>
__device__ __forceinline__ void lane_fold(const Tables& t, const Ctx& c, int key, const Vals& v,
                                          const Load& ld, int chunk = 0, bool sums = true) {
  const Target g = target(t, c, key);
  const long long T = t.t_slots;
  for (int l = 0; l < t.n_parts; ++l) {
    const int p = l < kGather ? v.part[l] : ld.part(l);
    if (p == 0) continue;
    if (g.shared)
      atomicAdd(g.s.parts + l * c.S + g.at, p);
    else if (t.wide)
      atomicAdd(t.psums64 + l * T + g.at, static_cast<unsigned long long>(static_cast<long long>(p)));
    else
      atomicAdd(t.psums + (static_cast<long long>(chunk) * t.n_parts + l) * T + g.at, p);
  }
  for (int j = 0; sums && j < t.n_sums; ++j)
    atomicAdd((g.shared ? g.s.sums + j * c.S : t.csums + j * T) + g.at,
              j < kGather ? v.sum[j] : ld.sum(j));
  for (int e = 0; e < t.n_ext; ++e) {
    const int m = t.ext_mode[e];
    if (is_raw(m))
      raw_extreme(g, t.ext_slot[e] * c.S, static_cast<double*>(t.ext[e]),
                  e < kGather ? v.ext[e] : ld.raw(e), m == kRawMin);
    else
      atomic_extreme((g.shared ? g.s.idx + t.ext_slot[e] * c.S : static_cast<int*>(t.ext[e])) +
                         g.at,
                     e < kGather ? static_cast<int>(v.ext[e]) : ld.id(e), m == kIdMin);
  }
  atomicAdd((g.shared ? g.s.count : t.count) + g.at, 1);
}

// Fold this lane's item (valid: it survives; key in [0, T); chunk: the
// row chunk of its int32 part sums, 0 for one chunk) into the tables, the
// warp together. `v`: the item's first values (load_vals); `ld` reads the
// others: part(l) int, sum(j) double, id(e) int, raw(e) double, for valid
// lanes only. Every lane of the warp must call it.
template <class Load>
__device__ __forceinline__ void warp_fold(const Tables& t, const Ctx& c, bool valid, int key,
                                          int chunk, const Vals& v, const Load& ld) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (c.route == kSmem) {
    // a block's own table: each lane's own atomics straight into shared
    // memory, which takes them contended faster than the warp combines;
    // but float64 atomics on one shared address queue, so lanes of one
    // key add their float64 sums in the warp first and one adds the sum
    if (valid) lane_fold(t, c, key, v, ld, 0, false);
    if (t.n_sums == 0) return;
    const unsigned peers = __match_any_sync(kFull, valid ? key : -1);
    const bool lead = valid && __ffs(peers) - 1 == lane;
    const bool shared_keys = __any_sync(kFull, valid && (peers & (peers - 1u)) != 0u);
    const Slice s = carve(c.base, t, c.S);
    for (int j = 0; j < t.n_sums; ++j) {
      const double x = j < kGather ? v.sum[j] : valid ? ld.sum(j) : 0.0;
      const double sum = group_combine<0>(x, peers, lead, shared_keys, c.scratch);
      if (lead) atomicAdd(s.sums + j * c.S + key, sum);
    }
    return;
  }
  if (__ballot_sync(kFull, valid) == 0u) return;
  // lanes of one (chunk, key) fold together; the invalid lanes form a
  // group of their own that issues nothing (keys are below 2^31, so -1
  // is no key)
  const unsigned peers =
      __any_sync(kFull, chunk != 0)
          ? __match_any_sync(kFull, valid ? (static_cast<unsigned long long>(chunk) << 32) |
                                                static_cast<unsigned>(key)
                                          : ~0ULL)
          : __match_any_sync(kFull, valid ? key : -1);
  const bool lead = valid && __ffs(peers) - 1 == lane;
  const bool shared_keys = __any_sync(kFull, valid && (peers & (peers - 1u)) != 0u);
  const int T = t.t_slots;
  Target g;
  if (lead) g = target(t, c, key);
  if (!shared_keys) {   // every lane its own group: its own atomics, no combining
    if (lead) lane_fold(t, c, key, v, ld, chunk);
    return;
  }

  for (int l0 = 0; l0 < t.n_parts; l0 += kGather) {
    int p[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u)
      p[u] = l0 == 0 ? v.part[u] : valid && l0 + u < t.n_parts ? ld.part(l0 + u) : 0;
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      if (l0 + u >= t.n_parts) break;
      const int s = __reduce_add_sync(peers, p[u]);
      if (!lead || s == 0) continue;
      const int l = l0 + u;
      if (g.shared)
        atomicAdd(g.s.parts + l * c.S + g.at, s);
      else if (t.wide)
        atomicAdd(t.psums64 + static_cast<long long>(l) * T + g.at,
                  static_cast<unsigned long long>(static_cast<long long>(s)));
      else
        atomicAdd(t.psums + (static_cast<long long>(chunk) * t.n_parts + l) * T + g.at, s);
    }
  }
  for (int j0 = 0; j0 < t.n_sums; j0 += kGather) {
    double x[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u)
      x[u] = j0 == 0 ? v.sum[u] : valid && j0 + u < t.n_sums ? ld.sum(j0 + u) : 0.0;
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      if (j0 + u >= t.n_sums) break;
      const double s = group_combine<0>(x[u], peers, lead, shared_keys, c.scratch);
      if (!lead) continue;
      const int j = j0 + u;
      atomicAdd((g.shared ? g.s.sums + j * c.S : t.csums + static_cast<long long>(j) * T) + g.at,
                s);
    }
  }
  for (int e0 = 0; e0 < t.n_ext; e0 += kGather) {
    double x[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int e = e0 + u;
      const bool here = valid && e < t.n_ext;
      x[u] = e0 == 0 ? v.ext[u]
             : !here ? 0.0
             : is_raw(t.ext_mode[e]) ? ld.raw(e) : static_cast<double>(ld.id(e));
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int e = e0 + u;
      if (e >= t.n_ext) break;
      const int m = t.ext_mode[e];
      if (is_raw(m)) {
        const double r = m == kRawMin
                             ? group_combine<1>(x[u], peers, lead, shared_keys, c.scratch)
                             : group_combine<2>(x[u], peers, lead, shared_keys, c.scratch);
        if (lead) raw_extreme(g, t.ext_slot[e] * c.S, static_cast<double*>(t.ext[e]), r,
                              m == kRawMin);
      } else {
        const int id = static_cast<int>(x[u]);
        const int r = m == kIdMin ? __reduce_min_sync(peers, id) : __reduce_max_sync(peers, id);
        if (lead)
          atomic_extreme((g.shared ? g.s.idx + t.ext_slot[e] * c.S : static_cast<int*>(t.ext[e])) +
                             g.at,
                         r, m == kIdMin);
      }
    }
  }
  if (lead) atomicAdd((g.shared ? g.s.count : t.count) + g.at, __popc(peers));
}

// Merge this block's shared table into the device tables: the slots it
// touched (count > 0) only, one device atomic a slot and table. The
// caller syncs the block first, so every fold into the table has landed. Blocks start their walks at slots spread over the slice, so the
// hot slots every block touches take their device atomics at different
// moments, not all blocks' at once.
__device__ __forceinline__ void merge_slice(const Tables& t, const Ctx& c) {
  const Slice s = carve(c.base, t, c.S);
  const long long T = t.t_slots;
  const int S = c.S;
  const int rot = static_cast<int>(static_cast<long long>(blockIdx.x) * S / gridDim.x);
  for (int r = threadIdx.x; r < S; r += blockDim.x) {
    const int i = r + rot < S ? r + rot : r + rot - S;
    const int n = s.count[i];
    if (n == 0) continue;
    const long long k = i;
    atomicAdd(t.count + k, n);
    for (int l = 0; l < t.n_parts; ++l) {
      const int p = s.parts[l * S + i];
      if (p == 0) continue;
      if (t.wide)
        atomicAdd(t.psums64 + l * T + k, static_cast<unsigned long long>(static_cast<long long>(p)));
      else
        atomicAdd(t.psums + l * T + k, p);
    }
    for (int j = 0; j < t.n_sums; ++j) atomicAdd(t.csums + j * T + k, s.sums[j * S + i]);
    for (int e = 0; e < t.n_ext; ++e) {
      const int m = t.ext_mode[e], at = t.ext_slot[e] * S + i;
      if (is_raw(m))
        atomic_extreme(static_cast<double*>(t.ext[e]) + k, raw_value(s.rawx[at], m == kRawMin),
                       m == kRawMin);
      else
        atomic_extreme(static_cast<int*>(t.ext[e]) + k, s.idx[at], m == kIdMin);
    }
  }
}

// This block's shared table (dynamic shared memory), zeroed, with the
// block synced after; null base on the global route.
__device__ __forceinline__ Ctx begin(const Tables& t, int route, int S, unsigned char* smem,
                                     double* scratch) {
  Ctx c;
  c.route = route;
  c.S = S;
  c.base = route == kSmem ? smem : nullptr;
  c.scratch = scratch + (threadIdx.x >> 5) * 32;
  if (route != kSmem) return c;
  zero_slice(t, c);
  __syncthreads();
  return c;
}

// After the folds: sync the block, merge its shared table.
__device__ __forceinline__ void end(const Tables& t, const Ctx& c) {
  if (c.route != kSmem) return;
  __syncthreads();
  merge_slice(t, c);
}

// Host: the launch shape of the smem route. `items` rows or slots are
// read; `bound_items`: > 0 when the shared int32 part sums must stay exact
// (wide), the items a block may fold at most, less its last pass of
// kFoldThreads (the caller keeps kFoldThreads x W_total inside it).
// Returns (blocks, slots of the shared table, dynamic shared bytes), or
// ctas = 0 when the table passes the opt-in memory.
struct Shape {
  int ctas = 0;
  int S = 0;
  size_t smem = 0;
};

template <typename Kernel>
inline Shape shared_shape(Kernel kernel, const Tables& t, long long items, long long bound_items,
                          long long units) {
  Shape sh;
  const long long T = t.t_slots;
  const long long S = (T + 31) / 32 * 32;
  const long long bytes = slice_bytes(t, S);
  int device = 0, optin = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, kernel);
  if (bytes + static_cast<long long>(attr.sharedSizeBytes) > optin) return sh;
  int per_sm = 0;
  if (allow_dynamic_smem(kernel, static_cast<size_t>(bytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFoldThreads,
                                                    static_cast<size_t>(bytes)) != cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();
    return sh;
  }
  // at most one block per kRowsPerSlot x T items, one wave, and no more
  // than the work units; enough of them that each folds <= bound_items
  long long want = items / (kRowsPerSlot * T);
  if (want < 1) want = 1;
  const long long wave = static_cast<long long>(sms) * per_sm;
  if (want > wave) want = wave;
  if (want > units) want = units < 1 ? 1 : units;
  if (bound_items > 0) {
    const long long need = (items + bound_items - 1) / bound_items;
    if (need > want) want = need;
  }
  if (want > 0x7fffffffLL) return sh;
  sh.ctas = static_cast<int>(want);
  sh.S = static_cast<int>(S);
  sh.smem = static_cast<size_t>(bytes);
  return sh;
}

// Host: the global route's grid: one full wave of kFoldThreads blocks (as
// many as registers let each SM hold), no more than `warps` warps.
template <typename Kernel>
inline int global_ctas(Kernel kernel, long long warps) {
  int device = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFoldThreads, 0) !=
          cudaSuccess ||
      per_sm < 1) {
    cudaGetLastError();
    per_sm = 1;
  }
  long long blocks = (warps + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// Host: out[0] the dynamic shared bytes a block of `kernel` may take (the
// opt-in memory less its static shared memory), out[1] the card's SMs.
template <typename Kernel>
inline int caps(Kernel kernel, int* out) {
  int device = 0, optin = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaFuncAttributes attr{};
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = optin - static_cast<int>(attr.sharedSizeBytes);
  out[1] = sms;
  return 0;
}

}  // namespace fold
}  // namespace pinot
