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
// natural primitive. Two launches (group_fold.cuh): list_kernel reads the
// mask as 16-byte words, four a lane (a warp a 2,048-row unit, every unit
// in flight at once on its few registers), lists the matched rows by a
// scan of each lane's nonzero bytes (its length is the matched doc count)
// and writes the tables' starting values; fold_kernel takes the listed
// rows 32 to a warp, each lane loading its row's values with its key's
// lanes (group_key.cuh, every kind), and folds them into a block's
// shared table or, with warp-aggregated atomics, the device table, the
// route the wrapper picks by fit (ops/kernels.py:fold_route). A matched doc's MV entries are walked in registers (no
// expansion is written), the lanes in step; a doc with more than
// kWalkCombos combinations is split into walks of that length, each its
// own item of the list (item = doc * n_walks + walk), so no walk grows
// without bound; integer sums and min / max do not depend on the split.
// Int32 atomics make counts and part sums exact; float64 atomicAdd
// (native on sm_90) makes csums order-dependent, so they are held to a
// tolerance; Hopper has no float64 atomicMin/Max, so a block's shared
// table keeps them as order-preserving int64 keys (native 64-bit
// atomics) and device memory takes compare-and-swap loops, skipped when
// the stored value already wins.
// Rows that do not match cost one mask byte, read 16 a lane. The int32
// part sums stay exact while 127 * P * W_total < 2^31 (W_total: the
// product of the MV keys' widths); the wrapper launches the kernel on row
// slices that small and adds their tables.
//
// Stacked segments (the counterpart of get_sharded_kernel in
// pinot_tpu/parallel/sharded.py, whose psum / pmin / pmax combine the
// per-segment tables): one launch over the S * P rows of the stack, so
// counts, float64 sums and min / max combine by construction. The part
// sums of a stack pass int32 (SSB sums 7-bit parts over 60M rows), so a
// stacked launch takes `psums_wide`: the device table is int64 and is
// folded with 64-bit integer atomics (exact, order-free); a block's
// shared table stays int32, and the launch takes enough blocks that each
// folds 127 * (its rows) * W_total < 2^31.

#include <math.h>

#include "group_fold.cuh"
#include "group_key.cuh"

namespace {

using pinot::KeyLanes;
namespace fold = pinot::fold;

constexpr int kMaxParts = 16;
constexpr int kMaxFloats = 8;
constexpr int kMaxExt = 16;

// a lane walks at most this many of a doc's MV entry combinations an item
// (ops/kernels.py:MAX_GROUP_COMBOS); a doc with more is split into walks
// of this length, each its own item
constexpr int kWalkCombos = 1 << 16;
constexpr int kUnitWords = 128;        // list_kernel's unit: 128 16-byte mask words

// The metric lanes of a matched row.
struct RowLanes {
  const int8_t* part[kMaxParts];
  const double* sum[kMaxFloats];
  const void* ext[kMaxExt];
  int ext_elem[kMaxExt];
};

struct RowLoad {
  const RowLanes& r;
  long long row;
  __device__ int part(int l) const { return r.part[l][row]; }
  __device__ double sum(int j) const { return r.sum[j][row]; }
  __device__ int id(int e) const { return pinot::read_id(r.ext[e], r.ext_elem[e], row); }
  __device__ double raw(int e) const { return pinot::read_value(r.ext[e], r.ext_elem[e], row); }
};

// Block-wide list positions: each warp's `n` items get consecutive
// positions of the list whose length `counter` holds; returns this warp's
// first. `sh`: kWarpsList + 1 ints of shared memory. Every thread of the
// block calls it, with its warp's n in lane 0.
constexpr int kWarpsList = pinot::kThreads / 32;

__device__ __forceinline__ int block_reserve(int n, int* counter, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                      // sh may still be read
  if (lane == 0) sh[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarpsList; ++w) {
      const int c = sh[w];
      sh[w] = total;
      total += c;
    }
    sh[kWarpsList] = total ? atomicAdd(counter, total) : 0;
  }
  __syncthreads();
  return sh[kWarpsList] + sh[warp];
}

// bit i: byte i of the 16 nonzero
__device__ __forceinline__ unsigned row_bits(uint4 q) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned nz = (((w[k] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[k]) & 0x80808080u;
    bits |= (((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) | ((nz >> 28) & 8u))
            << (4 * k);
  }
  return bits;
}

// The scan: a warp takes a unit of 2,048 rows (128 16-byte mask words, four
// a lane), counts its matched rows, and the block's warps reserve
// consecutive places of the list together (one atomic a block of 8
// units); the warp lists the unit's matched rows in order in shared memory
// and copies them out, 32 consecutive entries a store. The list's length
// is the matched doc count. Its registers are few, so the whole mask is
// in flight at once; the same grid writes the tables' starting values.
__global__ void __launch_bounds__(pinot::kThreads) list_kernel(
    const uint8_t* __restrict__ mask, long long padded, int* __restrict__ list,
    int* __restrict__ counter, const __grid_constant__ fold::Tables t) {
  __shared__ int sh[kWarpsList + 1];
  __shared__ unsigned short stage[kWarpsList][kUnitWords * 16];
  fold::init_tables(t, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned short* my = stage[warp];
  // 16-byte words from the aligned address at or below the mask; the
  // bytes before the mask and past its rows are dropped
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(mask) & 15u);
  const uint4* words = reinterpret_cast<const uint4*>(mask - mis);
  const long long n_words = (padded + mis + 15) / 16;
  const long long units = (n_words + kUnitWords - 1) / kUnitWords;
  for (long long bu = blockIdx.x; bu * kWarpsList < units; bu += gridDim.x) {
    const long long u = bu * kWarpsList + warp;
    const long long row0 = u * kUnitWords * 16 - mis;
    unsigned bits[4];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long w = u * kUnitWords + k * 32 + lane;
      const long long first = row0 + static_cast<long long>(k * 32 + lane) * 16;
      bits[k] = u < units && w < n_words ? row_bits(words[w]) : 0u;
      if (first < 0) bits[k] &= (0xffffu << static_cast<int>(-first)) & 0xffffu;
      if (first + 16 > padded) {
        const long long keep = padded - first;
        bits[k] &= keep <= 0 ? 0u : (1u << static_cast<int>(keep)) - 1u;
      }
      cnt += __popc(bits[k]);
    }
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    const int base = block_reserve(total, counter, sh);
    // the unit's rows in order in shared memory, then copied out a run of
    // 32 list entries a store
    int at = incl - cnt;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      for (unsigned b = bits[k]; b; b &= b - 1u)
        my[at++] = static_cast<unsigned short>((k * 32 + lane) * 16 + __ffs(b) - 1);
    __syncwarp();
    for (int j = lane; j < total; j += 32) list[base + j] = static_cast<int>(row0 + my[j]);
    __syncwarp();
  }
}

// The fold: the listed docs (times their walks, when a doc's MV
// combinations are split at kWalkCombos) in batches of 32, a batch a warp:
// each lane loads its row's values with its key's lanes, then the warp
// folds (group_fold.cuh). Every batch is full but the last, so the
// gathers' latency is paid once a 32 matched rows.
__global__ void __launch_bounds__(fold::kFoldThreads, 2) fold_kernel(
    const int* __restrict__ list, const int* __restrict__ counter,
    const __grid_constant__ KeyLanes keys, int n_keys, int n_mv, int w_total,
    const __grid_constant__ RowLanes lanes, const __grid_constant__ fold::Tables t, int route,
    int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double scratch[fold::kWarps * 32];
  const fold::Ctx c = fold::begin(t, route, S, smem, scratch);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_walks = (w_total + kWalkCombos - 1) / kWalkCombos;
  const long long items = static_cast<long long>(*counter) * n_walks;
  const int g_pad = t.t_slots;
  const long long stride = static_cast<long long>(gridDim.x) * fold::kWarps * 32;
  for (long long b0 = (static_cast<long long>(blockIdx.x) * fold::kWarps + warp) * 32; b0 < items;
       b0 += stride) {
    const long long e = b0 + lane;
    const bool valid = e < items;
    const long long doc = n_walks == 1 ? e : e / n_walks;
    const int walk = n_walks == 1 ? 0 : static_cast<int>(e - doc * n_walks);
    const long long row = valid ? list[doc] : 0;
    const RowLoad ld{lanes, row};
    const fold::Vals v = fold::load_vals(t, valid, ld);
    const int sv = valid ? pinot::sv_key(keys, n_keys, row) : 0;
    if (n_mv == 0) {
      fold::warp_fold(t, c, valid, min(max(sv, 0), g_pad - 1), 0, v, ld);
      continue;
    }
    // the cross product of the MV keys' entries, first MV key fastest;
    // this item walks combinations [walk * kWalkCombos, +kWalkCombos), the
    // lanes in step
    const int walk_len = min(w_total, kWalkCombos);
    for (int tw = 0; tw < walk_len; ++tw) {
      const int tc = walk * kWalkCombos + tw;
      int key = sv;
      const bool ok = valid && tc < w_total && pinot::mv_key(keys, n_keys, row, tc, &key);
      fold::warp_fold(t, c, ok, min(max(key, 0), g_pad - 1), 0, v, ld);
    }
  }
  fold::end(t, c);
}

}  // namespace

// Route codes of the C entry point (ops/kernels.py:FOLD_ROUTES): 0 global,
// 1 smem. `bound_items` > 0: a wide launch's shared int32 part sums, the
// rows x W_total a block may fold at most (ops/kernels.py:
// FOLD_BOUND_ITEMS).
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
    long long padded, int g_pad, int route, long long bound_items, int psums_wide, void* count,
    void* psums, void* csums, void* matched, void* list, void* stream) {
  if (n_parts < 0 || n_parts > kMaxParts || n_floats < 0 || n_floats > kMaxFloats ||
      n_ext < 0 || n_ext > kMaxExt || g_pad < 1 || route < fold::kGlobal || route > fold::kSmem ||
      bound_items < 0)
    return -1;
  KeyLanes keys;
  int n_mv = 0;
  long long w_total = 1;
  if (!pinot::fill_key_lanes(&keys, n_keys, key_ptrs, key_elems, key_strides, key_kinds,
                             key_widths, key_limits, key_offsets, key_members, key_mlens,
                             key_tables, key_codes, key_tlens, &n_mv, &w_total))
    return -1;
  fold::Tables t{};
  t.count = static_cast<int*>(count);
  t.psums = psums_wide ? nullptr : static_cast<int*>(psums);
  t.psums64 = psums_wide ? static_cast<unsigned long long*>(psums) : nullptr;
  t.csums = static_cast<double*>(csums);
  t.n_parts = n_parts;
  t.n_sums = n_floats;
  t.t_slots = g_pad;
  t.wide = psums_wide;
  if (!fold::set_ext(&t, n_ext, ext_modes, ext_inits, ext_outs)) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  RowLanes lanes{};
  for (int l = 0; l < n_parts; ++l) lanes.part[l] = static_cast<const int8_t*>(part_ptrs[l]);
  for (int j = 0; j < n_floats; ++j) lanes.sum[j] = static_cast<const double*>(float_ptrs[j]);
  for (int e = 0; e < n_ext; ++e) {
    lanes.ext[e] = ext_ptrs[e];
    lanes.ext_elem[e] = ext_elems[e];
  }
  int ctas = 0, S = 0;
  size_t smem = 0;
  if (route == fold::kGlobal) {
    ctas = fold::global_ctas(fold_kernel, padded * w_total / 32 + 1);
  } else {
    // a block folds at most bound_items plus its last pass of kFoldThreads
    // docs, each of W_total combinations
    if (bound_items > 0 && fold::kFoldThreads * w_total > bound_items) return -2;
    const fold::Shape sh = fold::shared_shape(fold_kernel, t, padded * w_total, bound_items,
                                              padded * w_total / 32 + 1);
    if (sh.ctas == 0) return -2;
    ctas = sh.ctas;
    S = sh.S;
    smem = sh.smem;
  }
  // the list of matched rows, its length in `matched` (from 0)
  cudaError_t rc = cudaMemsetAsync(matched, 0, sizeof(int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long mis = static_cast<long long>(reinterpret_cast<uintptr_t>(mask) & 15u);
  const long long units = ((padded + mis + 15) / 16 + kUnitWords - 1) / kUnitWords;
  list_kernel<<<pinot::grid_for(list_kernel, units * 32 > g_pad ? units * 32 : g_pad, 0),
                pinot::kThreads, 0, s>>>(static_cast<const uint8_t*>(mask), padded,
                                         static_cast<int*>(list), static_cast<int*>(matched), t);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fold_kernel<<<ctas, fold::kFoldThreads, smem, s>>>(
      static_cast<const int*>(list), static_cast<const int*>(matched), keys, n_keys, n_mv,
      static_cast<int>(w_total), lanes, t, route, S);
  return static_cast<int>(cudaGetLastError());
}

// out[0]: the dynamic shared bytes a block may take, out[1]: SMs.
extern "C" int pinot_dense_group_aggregate_caps(int* out) { return fold::caps(fold_kernel, out); }
