// K3 dense_group_aggregate: per-group count, exact int32 part sums,
// float64 sums and min/max over a dense mixed-radix group table.
//
// Replaces pinot_tpu/ops/kernels.py:_group_key (:702, kinds "ids",
// "rawoff", "idoff" (:711), "idrank" (:720), "jcode" (:740) and "jraw"
// (:752)), _expand_mv_group (:1220, kinds "mvids" and "mvin"),
// _dense_group_count (:402), _dense_group_part_sums (:407),
// _dense_group_float_sums (:503), _dense_group_extreme (:529) and the
// scatter fallback of _group_outputs (:1330-1390) for count / sum / avg /
// min / max / minmaxrange.
//
// The key of a row, and of each MV entry combination of a doc (a doc
// contributes once per cross-combination of its MV keys' entries, the
// reference's aggregateGroupByMV), is group_key.cuh's: kinds ids, rawoff,
// mvids, mvin, jcode, jraw and the adaptive remaps idoff and idrank
// (:711, :720). The join kinds read one more input per matched row than
// an ids key: a 4-byte gather from the code table (at most 8 MB at 2^21
// entries, mostly L2-resident) or a binary search of at most 17 probes of
// the sorted keys (<= 512 KB, in L2); idrank one 4-byte gather from its
// [card_pad] rank table. Tables count once each in the bound below.
// For every surviving combination:
// key = clip(sum_c term_c * stride_c, 0, g_pad - 1), then
//   count[key] += 1, psums[l][key] += parts_l[row], csums[j][key] += vals_j[row]
//   idmin[e][key] = min(., ids_e[row]), idmax[e][key] = max(., ids_e[row])
//   rawmin[e][key] = min(., double(raw_e[row])), rawmax likewise
// and the matched count counts docs, once each. The id tables start at the
// sentinels the JAX function uses (card_pad for min, -1 for max,
// :1361-1377), the raw ones at +inf / -inf in float64, the JAX package's
// sum_dtype (:1378-1390). Min and max do not depend on the order of the
// rows, so they equal JAX exactly; a NaN value wins, as XLA's min and max
// propagate NaN.
//
// What bounds it: bytes, once the matched rows are few: one mask byte per
// row, then for matched rows only their key ids (a [W] row per MV key),
// part bytes, values, plus the group table written. With many matched
// rows landing in few groups, contention on the atomics bounds it instead.
//
// What the design does about it: the TPU kernels built one-hot tiles for
// the matrix unit because scatter is slow there, and expanded MV keys
// into a [P * W] row space in device memory; on Hopper an atomic is the
// natural primitive, so this kernel does one pass over the docs, walks
// each matched doc's MV entries in registers (no expansion is written)
// and folds every combination straight into the table (a doc with more
// than kWalkCombos combinations is split into several work items, each
// walking its own range of them, so no thread's walk grows without
// bound; integer sums and min / max do not depend on the split). When the table has
// at most `smem_slots` slots (the caller's limit) and fits in a block's
// shared memory, each block folds into its own copy there (shared
// atomics, so a few hot groups no longer serialise on device memory) and
// merges it into the device table at the end with one atomic per touched
// group. Otherwise it folds into device memory directly. Int32 atomics
// make counts and part sums exact; float64 atomicAdd (native on sm_90)
// makes csums order-dependent, so they are held to a tolerance; Hopper has
// no float64 atomicMin/Max, so those are compare-and-swap loops, skipped
// when the stored value already wins. Rows that do not match cost one
// mask byte. The int32 part sums stay exact while 127 * P * W_total <
// 2^31 (W_total: the product of the MV keys' widths); the wrapper
// launches the kernel on row slices that small and adds their tables.
//
// Stacked segments (the counterpart of get_sharded_kernel in
// pinot_tpu/parallel/sharded.py, whose psum / pmin / pmax combine the
// per-segment tables): one launch over the S * P rows of the stack, so
// counts, float64 sums and min / max combine by construction. The part
// sums of a stack pass int32 (SSB sums 7-bit parts over 60M rows), so a
// stacked launch takes `psums_wide`: the device table is int64 and is
// folded with 64-bit integer atomics (exact, order-free); a block's shared
// table stays int32 and is used only while 127 * (the rows one block
// reads) * W_total < 2^31.

#include <math.h>

#include "group_key.cuh"

namespace {

using pinot::KeyLanes;
using pinot::atomic_extreme;

constexpr int kMaxParts = 16;
constexpr int kMaxFloats = 8;
constexpr int kMaxExt = 16;

// one thread walks at most this many of a doc's MV entry combinations
// (ops/kernels.py:MAX_GROUP_COMBOS); a doc with more is split into walks
// of this length, each its own work item
constexpr int kWalkCombos = 1 << 16;

enum ExtMode : int { kIdMin = 0, kIdMax = 1, kRawMin = 2, kRawMax = 3 };
struct PartLanes {
  const int8_t* ptr[kMaxParts];
};

struct FloatLanes {
  const double* ptr[kMaxFloats];
};

struct ExtLanes {
  const void* ptr[kMaxExt];
  int elem[kMaxExt];
  int mode[kMaxExt];
  int init[kMaxExt];       // id tables: the sentinel the table starts at
  int slot[kMaxExt];       // index among the id tables or among the raw ones
  void* out[kMaxExt];      // int32 [g_pad] (id) or float64 [g_pad] (raw)
};

__host__ __device__ __forceinline__ bool is_raw(int mode) { return mode == kRawMin || mode == kRawMax; }

__global__ void dense_group_aggregate_kernel(
    const uint8_t* __restrict__ mask, KeyLanes keys_p, int n_keys, int n_mv,
    int w_total, PartLanes parts_p, int n_parts, FloatLanes floats_p, int n_floats,
    ExtLanes ext_p, int n_ext, int n_raw, long long padded, int g_pad, int use_smem,
    int psums_wide, int* __restrict__ count, void* __restrict__ psums_out,
    double* __restrict__ csums, int* __restrict__ matched) {
  // int32 [L][g_pad] part sums, or int64 ones (psums_wide)
  int* const psums = psums_wide ? nullptr : static_cast<int*>(psums_out);
  unsigned long long* const psums64 =
      psums_wide ? static_cast<unsigned long long*>(psums_out) : nullptr;
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int scratch[32];
  // the lane descriptors in shared memory: indexing the parameter structs
  // by a loop counter makes every thread copy them to local memory
  __shared__ KeyLanes keys;
  __shared__ PartLanes parts;
  __shared__ FloatLanes floats;
  __shared__ ExtLanes ext;
  if (threadIdx.x == 0) {
    keys = keys_p;
    parts = parts_p;
    floats = floats_p;
    ext = ext_p;
  }
  __syncthreads();

  // table pointers: this block's shared copy, or the device tables
  int* t_count = count;
  int* t_psums = psums;
  double* t_csums = csums;
  int* t_idext = nullptr;       // shared only: [n_ext - n_raw][g_pad] int
  double* t_rawext = nullptr;   // shared only: [n_raw][g_pad] double
  if (use_smem) {
    double* d = reinterpret_cast<double*>(smem);
    t_csums = d;
    t_rawext = d + static_cast<long long>(n_floats) * g_pad;
    int* i = reinterpret_cast<int*>(t_rawext + static_cast<long long>(n_raw) * g_pad);
    t_count = i;
    t_psums = i + g_pad;
    t_idext = t_psums + static_cast<long long>(n_parts) * g_pad;
    for (int s = threadIdx.x; s < g_pad; s += blockDim.x) {
      t_count[s] = 0;
      for (int l = 0; l < n_parts; ++l) t_psums[l * g_pad + s] = 0;
      for (int j = 0; j < n_floats; ++j) t_csums[j * g_pad + s] = 0.0;
      for (int e = 0; e < n_ext; ++e) {
        const int m = ext.mode[e], at = ext.slot[e] * g_pad + s;
        if (is_raw(m))
          t_rawext[at] = m == kRawMin ? INFINITY : -INFINITY;
        else
          t_idext[at] = ext.init[e];
      }
    }
    __syncthreads();
  }

  // fold one (row, group key) pair into the tables
  auto fold = [&](long long row, int key) {
    key = min(max(key, 0), g_pad - 1);
    atomicAdd(t_count + key, 1);
    for (int l = 0; l < n_parts; ++l) {
      const int p = parts.ptr[l][row];
      if (p == 0) continue;
      const long long at = static_cast<long long>(l) * g_pad + key;
      if (psums64 && !use_smem)
        atomicAdd(psums64 + at, static_cast<unsigned long long>(p));
      else
        atomicAdd(t_psums + at, p);
    }
    for (int j = 0; j < n_floats; ++j)
      atomicAdd(t_csums + static_cast<long long>(j) * g_pad + key, floats.ptr[j][row]);
    for (int e = 0; e < n_ext; ++e) {
      const int m = ext.mode[e];
      const long long slot = use_smem ? static_cast<long long>(ext.slot[e]) * g_pad + key : key;
      if (is_raw(m)) {
        double* t = use_smem ? t_rawext : static_cast<double*>(ext.out[e]);
        atomic_extreme(t + slot, pinot::read_value(ext.ptr[e], ext.elem[e], row), m == kRawMin);
      } else {
        int* t = use_smem ? t_idext : static_cast<int*>(ext.out[e]);
        atomic_extreme(t + slot, pinot::read_id(ext.ptr[e], ext.elem[e], row), m == kIdMin);
      }
    }
  };

  int local = 0;
  // work items: one per row, or n_walks per row when a doc's walk is
  // longer than kWalkCombos (item = row * n_walks + walk)
  const int n_walks = (w_total + kWalkCombos - 1) / kWalkCombos;
  const long long items = padded * n_walks;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long item = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       item < items; item += step) {
    const long long row = n_walks == 1 ? item : item / n_walks;
    const int walk = n_walks == 1 ? 0 : static_cast<int>(item - row * n_walks);
    if (!mask[row]) continue;
    if (walk == 0) ++local;             // the doc counts once
    const int base = pinot::sv_key(keys, n_keys, row);   // the single-value keys' part
    if (n_mv == 0) {
      fold(row, base);
      continue;
    }
    // the cross product of the MV keys' entries, first MV key fastest;
    // this item walks combinations [walk * kWalkCombos, +kWalkCombos)
    const int t_end = min(w_total, (walk + 1) * kWalkCombos);
    for (int t = walk * kWalkCombos; t < t_end; ++t) {
      int key = base;
      if (pinot::mv_key(keys, n_keys, row, t, &key)) fold(row, key);
    }
  }

  if (use_smem) {   // merge the groups this block touched
    __syncthreads();
    for (int s = threadIdx.x; s < g_pad; s += blockDim.x) {
      const int c = t_count[s];
      if (c == 0) continue;
      atomicAdd(count + s, c);
      for (int l = 0; l < n_parts; ++l) {
        const int p = t_psums[l * g_pad + s];
        if (p == 0) continue;
        const long long at = static_cast<long long>(l) * g_pad + s;
        if (psums64)
          atomicAdd(psums64 + at, static_cast<unsigned long long>(static_cast<unsigned>(p)));
        else
          atomicAdd(psums + at, p);
      }
      for (int j = 0; j < n_floats; ++j)
        atomicAdd(csums + static_cast<long long>(j) * g_pad + s, t_csums[j * g_pad + s]);
      for (int e = 0; e < n_ext; ++e) {
        const int m = ext.mode[e], at = ext.slot[e] * g_pad + s;
        if (is_raw(m))
          atomic_extreme(static_cast<double*>(ext.out[e]) + s, t_rawext[at], m == kRawMin);
        else
          atomic_extreme(static_cast<int*>(ext.out[e]) + s, t_idext[at], m == kIdMin);
      }
    }
  }
  const int total = pinot::block_sum(local, scratch);
  if (threadIdx.x == 0 && total != 0) atomicAdd(matched, total);
}

}  // namespace

extern "C" int pinot_dense_group_aggregate(
    const void* mask, const void* const* key_ptrs, const int* key_elems,
    const int* key_strides, const int* key_kinds, const int* key_widths,
    const int* key_limits, const long long* key_offsets,
    const void* const* key_members, const int* key_mlens,
    const void* const* key_tables, const void* const* key_codes, const int* key_tlens,
    int n_keys,
    const void* const* part_ptrs,
    int n_parts, const void* const* float_ptrs, int n_floats,
    const void* const* ext_ptrs, const int* ext_elems, const int* ext_modes,
    const int* ext_inits, void* const* ext_outs, int n_ext,
    long long padded, int g_pad, int smem_slots, int psums_wide, void* count,
    void* psums, void* csums, void* matched, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_floats < 0 || n_floats > kMaxFloats ||
      n_ext < 0 || n_ext > kMaxExt || g_pad < 1)
    return -1;
  KeyLanes keys;
  int n_mv = 0;
  long long w_total = 1;
  if (!pinot::fill_key_lanes(&keys, n_keys, key_ptrs, key_elems, key_strides, key_kinds,
                             key_widths, key_limits, key_offsets, key_members, key_mlens,
                             key_tables, key_codes, key_tlens, &n_mv, &w_total))
    return -1;
  PartLanes parts{};
  for (int l = 0; l < n_parts; ++l)
    parts.ptr[l] = static_cast<const int8_t*>(part_ptrs[l]);
  FloatLanes floats{};
  for (int j = 0; j < n_floats; ++j)
    floats.ptr[j] = static_cast<const double*>(float_ptrs[j]);
  ExtLanes ext{};
  int n_raw = 0;
  for (int e = 0; e < n_ext; ++e) {
    ext.ptr[e] = ext_ptrs[e];
    ext.elem[e] = ext_elems[e];
    ext.mode[e] = ext_modes[e];
    ext.init[e] = ext_inits[e];
    ext.slot[e] = is_raw(ext_modes[e]) ? n_raw++ : e - n_raw;
    ext.out[e] = ext_outs[e];
  }
  // the shared table: float64 csums and raw extremes, then int32 count,
  // part sums and id extremes, g_pad slots each
  const long long table_bytes = static_cast<long long>(g_pad) *
      (8LL * (n_floats + n_raw) + 4LL * (1 + n_parts + n_ext - n_raw));
  int device = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  cudaFuncGetAttributes(&attr, dense_group_aggregate_kernel);
  const long long smem_room = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  int use_smem = g_pad <= smem_slots && table_bytes <= smem_room ? 1 : 0;
  if (use_smem && psums_wide && n_parts > 0) {
    // a block's int32 shared part sums hold 127 * (its rows) * W_total
    const int g = pinot::grid_for(dense_group_aggregate_kernel, padded,
                                  static_cast<size_t>(table_bytes));
    const long long chunk = static_cast<long long>(g) * pinot::kThreads;
    const long long rows = (padded + chunk - 1) / chunk * pinot::kThreads;
    if (127LL * rows * w_total >= (1LL << 31) || w_total > kWalkCombos) use_smem = 0;
  }
  const size_t smem = use_smem ? static_cast<size_t>(table_bytes) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dense_group_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const long long n_walks = (w_total + kWalkCombos - 1) / kWalkCombos;
  const int grid = pinot::grid_for(dense_group_aggregate_kernel, padded * n_walks, smem);
  dense_group_aggregate_kernel<<<grid, pinot::kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), keys, n_keys, n_mv, static_cast<int>(w_total),
      parts, n_parts, floats,
      n_floats, ext, n_ext, n_raw, padded, g_pad, use_smem, psums_wide,
      static_cast<int*>(count), psums, static_cast<double*>(csums),
      static_cast<int*>(matched));
  return static_cast<int>(cudaGetLastError());
}
