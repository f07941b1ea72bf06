// The mixed-radix group key of pinot_tpu/ops/kernels.py:_group_key (:702)
// and the MV row space of _expand_mv_group (:1220), evaluated per row by
// K3 (dense_group_aggregate.cu) and K14 (group_compact.cu, block_compact).
//
// Key terms, one per group column c, in int32 with two's-complement wrap
// as XLA computes them (kernels.py:766-768):
//   ids:    the dictId lane's id;
//   rawoff: (raw - offset) in the lane's own width (int32 or int64),
//           then narrowed to int32;
//   mvids:  one entry of the doc's [W] MV row; padding entries (id >=
//           cardinality) drop the combination;
//   mvin:   as mvids, and an entry outside the member table drops it too;
//   jcode:  a join's dim group code of the row's fact-key dictId,
//           code[clip(id, 0, len - 1)] from an int32 table over the fact
//           key's dictionary (the planner's JoinContext.code_table_for);
//   jraw:   a join's dim group code of the row's raw int32 / int64 key:
//           the code beside the key's lower-bound position (clipped to
//           Dp - 1) in the dim keys sorted by K12 with their codes. The
//           padding repeats (largest key, its code), so a key found in
//           the padding run reads the right code. Rows whose key has no
//           dim row read some code: the join leaf of K1 masked them;
//   idoff:  the adaptive offset remap (:711): id - offset, the offset the
//           phase-A scout's smallest matched id (a runtime value);
//   idrank: the adaptive densifying remap (:720): rank[id] from a runtime
//           int32 [card_pad] table (the id's rank among the present ids),
//           0 for an id outside [0, card_pad). JAX evaluates it as a
//           one-hot matmul against the rank vector, which is exact (ranks
//           are below 512) and gives 0 there too; a gather is the same
//           function and one 4-byte read a row from an L2-resident table.
// A doc with MV keys contributes once per cross-combination of its MV
// keys' entries (the reference's aggregateGroupByMV): the first MV key
// walks fastest, as _expand_mv_group's mixed-radix entry index does, and
// each key position keeps its own entry index, so the same column as two
// keys gives the full cross product. The key is
// clip(sum_c term_c * stride_c, 0, g_pad - 1); the caller clips.
#pragma once

#include "common.cuh"

namespace pinot {

constexpr int kMaxKeys = 8;

// key kinds, as ops/kernels.py:_KEY_KINDS codes them
enum KeyKind : int {
  kIds = 0, kRawOff = 1, kMvIds = 2, kMvIn = 3, kJCode = 4, kJRaw = 5,
  kIdOff = 6, kIdRank = 7
};

struct KeyLanes {
  const void* ptr[kMaxKeys];
  const uint8_t* member[kMaxKeys];   // mvin: bool [mlen]
  const void* table[kMaxKeys];       // jcode: int32 codes; jraw: sorted keys;
                                     // idrank: int32 ranks [tlen]
  const int* codes[kMaxKeys];        // jraw: the sorted keys' int32 codes [tlen]
  int tlen[kMaxKeys];
  long long offset[kMaxKeys];        // rawoff: in the lane's width; idoff: int32
  int elem[kMaxKeys];
  int stride[kMaxKeys];
  int kind[kMaxKeys];
  int width[kMaxKeys];               // MV: entries per row; else 1
  int limit[kMaxKeys];               // MV: cardinality (padding ids >= it)
  int mlen[kMaxKeys];
};

__host__ __device__ __forceinline__ bool is_mv(int kind) { return kind == kMvIds || kind == kMvIn; }

// int32 arithmetic that wraps as XLA's does (signed overflow is undefined
// in C++, unsigned is not)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// the single-value term of key c for one row (every kind but mvids / mvin)
__device__ __forceinline__ int sv_term(const KeyLanes& k, int c, long long row) {
  switch (k.kind[c]) {
    case kJCode: {
      const int id = read_id(k.ptr[c], k.elem[c], row);
      return static_cast<const int*>(k.table[c])[min(max(id, 0), k.tlen[c] - 1)];
    }
    case kJRaw: {
      int pos;
      if (k.elem[c] == kI64)
        pos = probe_position(static_cast<const long long*>(k.table[c]), k.tlen[c],
                             static_cast<const long long*>(k.ptr[c])[row]);
      else
        pos = probe_position(static_cast<const int*>(k.table[c]), k.tlen[c],
                             static_cast<const int*>(k.ptr[c])[row]);
      return k.codes[c][pos];
    }
    case kRawOff:
      if (k.elem[c] == kI64)
        return static_cast<int>(static_cast<const long long*>(k.ptr[c])[row] - k.offset[c]);
      return static_cast<int>(static_cast<unsigned>(static_cast<const int*>(k.ptr[c])[row]) -
                              static_cast<unsigned>(k.offset[c]));
    case kIdOff:
      return static_cast<int>(static_cast<unsigned>(read_id(k.ptr[c], k.elem[c], row)) -
                              static_cast<unsigned>(k.offset[c]));
    case kIdRank: {
      const int id = read_id(k.ptr[c], k.elem[c], row);
      return id >= 0 && id < k.tlen[c] ? static_cast<const int*>(k.table[c])[id] : 0;
    }
    default:
      return read_id(k.ptr[c], k.elem[c], row);
  }
}

// The single-value keys' part of a row's key.
__device__ __forceinline__ int sv_key(const KeyLanes& k, int n_keys, long long row) {
  int base = 0;
  for (int c = 0; c < n_keys; ++c)
    if (!is_mv(k.kind[c])) base = wrap_add(base, wrap_mul(sv_term(k, c, row), k.stride[c]));
  return base;
}

// Combination t of a doc's MV entries added to `key` (its single-value
// part); false when an entry of the combination is padding or outside its
// member table, and the combination then drops.
__device__ __forceinline__ bool mv_key(const KeyLanes& k, int n_keys, long long row, int t,
                                       int* key) {
  int rem = t;
  for (int c = 0; c < n_keys; ++c) {
    const int kind = k.kind[c];
    if (!is_mv(kind)) continue;
    const int w = k.width[c];
    const int id = read_id(k.ptr[c], k.elem[c], row * w + rem % w);
    rem /= w;
    if (id >= k.limit[c] ||
        (kind == kMvIn && !k.member[c][min(max(id, 0), k.mlen[c] - 1)]))
      return false;
    *key = wrap_add(*key, wrap_mul(id, k.stride[c]));
  }
  return true;
}

// The key lanes from the C entry point's arrays; the number of MV keys in
// *n_mv and the product of their widths in *w_total. Returns false on a
// kind or table the kernels do not take, or when one doc's combinations
// could overflow an int32 part sum (127 * W_total >= 2^31).
inline bool fill_key_lanes(KeyLanes* keys, int n_keys, const void* const* key_ptrs,
                           const int* key_elems, const int* key_strides, const int* key_kinds,
                           const int* key_widths, const int* key_limits,
                           const long long* key_offsets, const void* const* key_members,
                           const int* key_mlens, const void* const* key_tables,
                           const void* const* key_codes, const int* key_tlens, int* n_mv,
                           long long* w_total) {
  if (n_keys < 1 || n_keys > kMaxKeys) return false;
  *keys = KeyLanes{};
  *n_mv = 0;
  *w_total = 1;
  for (int c = 0; c < n_keys; ++c) {
    const int kind = key_kinds[c];
    if (kind < kIds || kind > kIdRank) return false;
    keys->ptr[c] = key_ptrs[c];
    keys->elem[c] = key_elems[c];
    keys->stride[c] = key_strides[c];
    keys->kind[c] = kind;
    keys->width[c] = key_widths[c];
    keys->limit[c] = key_limits[c];
    keys->offset[c] = key_offsets[c];
    keys->member[c] = static_cast<const uint8_t*>(key_members[c]);
    keys->mlen[c] = key_mlens[c];
    keys->table[c] = key_tables[c];
    keys->codes[c] = static_cast<const int*>(key_codes[c]);
    keys->tlen[c] = key_tlens[c];
    if ((kind == kJCode || kind == kJRaw || kind == kIdRank) &&
        (key_tables[c] == nullptr || key_tlens[c] < 1 ||
         (kind == kJRaw && key_codes[c] == nullptr)))
      return false;
    if (is_mv(kind)) {
      if (key_widths[c] < 1 ||
          (kind == kMvIn && (key_members[c] == nullptr || key_mlens[c] < 1)))
        return false;
      ++*n_mv;
      *w_total *= key_widths[c];
      if (127LL * *w_total >= (1LL << 31)) return false;   // one doc overflows
    }
  }
  return true;
}

}  // namespace pinot
