// A stable LSD radix sort of up to 65,536 rows inside one thread-block
// cluster, in one launch: K12's route for n <= 65,536 rows
// (sort_window.cu) and the sort of K6's <= k selected rows
// (masked_select.cu).
//
// A cluster of n_ctas CTAs (1, 2, 4 or 8, the portable limit) of 1,024
// threads sorts rows [0, n). CTA `me` owns the positions [me * chunk,
// me * chunk + chunk), chunk = ceil(n / n_ctas) rounded up to 32, at most
// 8,192, and holds their row numbers (16 bits: n <= 65,536) in shared
// memory.
//
// 1. The bits that vary. Each CTA ORs and ANDs its rows' key bits (8
//    loads in flight a thread); after cluster.sync() every CTA combines
//    all CTAs' words through distributed shared memory (DSMEM).
// 2. Packed keys. Where the varying bits of all lanes, and the one
//    "row at or past valid_rows" bit above them, number at most 64, each
//    row's varying bits are packed into one 64-bit key (the last lane's
//    lowest, the valid bit highest; runs of consecutive varying bits move
//    as one shift and mask), and the key travels with its row number: a
//    pass of 8 bits reads its digit from shared memory, and the caller
//    rebuilds the sorted keys from the packed bits and the constant ones.
//    Packing saves passes (a window's partition code, an ASC code and a
//    DESC ~code against the padding's 0 vary in 40 bits: 5 passes where
//    whole varying bytes take 7) and reads: a digit read through the
//    permutation from the caller's lanes is a random 4-byte read, a
//    32-byte L2 sector, 8,192 of them a pass on each of the cluster's 8
//    SMs. With more than 64 varying bits the passes are the varying
//    bytes, their digits read that way. A key of at most 48 bits carries
//    its row number in its top 16 bits, so a row moves as one word.
// 3. A pass. Warp w of a CTA owns warp_rows consecutive positions of the
//    CTA's range, 32 a step, up to 8 steps, so the order CTA, warp, step,
//    lane is position order. A lane reads its 8 rows' digits; a ballot
//    for each bit of the pass's digit, all 8 rows' in flight together,
//    gives the lanes of the same digit (a cost that does not grow with
//    the digits' variety, as __match_any_sync's does); walking its
//    steps in order, the warp adds each group's size to its own count of
//    the digit (no atomics: a count row is one warp's), and a row's rank
//    in the warp is that count before its step plus its peers in lower
//    lanes. Thread d < 256 turns the 32 warps' counts of digit d into
//    exclusive offsets and the CTA's count, and the 256 counts' exclusive
//    scan gives where the CTA's rows of digit d start in the CTA: each
//    row goes to that start plus its warp's offset plus its rank in a
//    staging buffer, the CTA's rows sorted by digit, stably. After
//    cluster.sync() thread d reads every CTA's count of d through DSMEM:
//    its total over the cluster and the part of the CTAs before this one;
//    the 256 totals' exclusive scan plus that part is where this CTA's
//    rows of digit d start in the cluster (digit-major, CTA-minor). Then
//    the CTA's threads walk the staging buffer in order and store each
//    row (and its packed key) into the owning CTA's buffers through
//    DSMEM: neighbouring threads store to neighbouring positions of one
//    digit's run, so the remote stores coalesce. A second cluster.sync()
//    ends the pass. One buffer a CTA is enough: every CTA has read its own
//    before the first barrier, and the stores into it come after.
//
// No global scratch, no memset, no atomics in device memory, and the
// whole sort is one launch. Two cluster barriers a pass.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace pinot {

namespace cg = cooperative_groups;

constexpr int kSortThreads = 1024;                       // threads of a CTA
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 8;                            // rows a lane holds
constexpr int kSortCtaRows = kSortThreads * kSortItems;  // 8,192
constexpr int kSortMaxCtas = 8;
constexpr int kSortMaxRows = kSortCtaRows * kSortMaxCtas;  // 65,536
constexpr int kSortRadix = 256;
constexpr int kSortMaxLanes = 8;
constexpr int kSortMaxPasses = 8 * kSortMaxLanes + 1;     // byte passes
constexpr int kSortMaxRuns = 64;                          // runs of varying bits
constexpr int kSortRowShift = 48;     // a packed key of <= 48 bits carries its row above

// The shared memory of one CTA (dynamic: about 212 KB).
struct SortSmem {
  unsigned long long key[kSortCtaRows];        // packed keys
  unsigned long long stage_key[kSortCtaRows];  // or the digit, unpacked
  unsigned short row[kSortCtaRows];
  unsigned short stage_row[kSortCtaRows];
  unsigned char digit[kSortCtaRows];           // a pass's digits, unpacked
  int warp_count[kSortWarps][kSortRadix];
  int cta_count[kSortRadix];
  int local_base[kSortRadix];
  int base[kSortRadix];
  int warp_sum[kSortWarps];
  // [0]: the rows before valid_rows, [1]: the rows at or past it
  unsigned long long bits_or[2][kSortMaxLanes];
  unsigned long long bits_and[2][kSortMaxLanes];
  unsigned long long warp_or[2][kSortMaxLanes][kSortWarps];
  unsigned long long warp_and[2][kSortMaxLanes][kSortWarps];
  unsigned long long fixed[kSortMaxLanes];      // a lane's bits, where constant
  // split: the rows past valid_rows all hold the keys invalid_bits, so
  // only the valid rows' bits are packed (the others' order is theirs)
  unsigned long long invalid_bits[kSortMaxLanes];
  int split;
  // packed: run r moves run_len bits of lane run_lane from bit run_shift
  // to bit run_pos of the key; the valid bit is bit valid_bit
  signed char run_lane[kSortMaxRuns];
  unsigned char run_shift[kSortMaxRuns], run_len[kSortMaxRuns], run_pos[kSortMaxRuns];
  int run_first[kSortMaxLanes], run_count[kSortMaxLanes];
  int n_runs, valid_bit, n_bits;
  // unpacked: pass j's digit is byte pass_shift / 8 of lane pass_lane (-1:
  // the valid bit)
  signed char pass_lane[kSortMaxPasses];
  unsigned char pass_shift[kSortMaxPasses];
  int n_passes, packed;
  // each CTA's row and key buffers, mapped for DSMEM stores
  unsigned short* remote_row[kSortMaxCtas];
  unsigned long long* remote_key[kSortMaxCtas];
};

// Exclusive scan of v over threads 0..255 (warps 0-7; every thread of the
// CTA calls it, threads past 255 with v = 0); thread t < 256 gets the sum
// of v over threads below it. Returns with the CTA synchronised.
__device__ __forceinline__ int digit_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int pre = 0;
  if (threadIdx.x < kSortRadix)
    for (int w = 0; w < warp; ++w) pre += warp_sum[w];
  __syncthreads();                    // warp_sum may be written again
  return pre + incl - v;
}

// CTAs of the cluster that sorts n rows: up to 1,024 rows a CTA below 8
// CTAs, so a small sort runs on few SMs.
inline int sort_ctas(long long n) {
  int c = 1;
  while (c < kSortMaxCtas && static_cast<long long>(c) * kSortThreads < n) c <<= 1;
  return c;
}

// Lanes of the warp whose digit equals this lane's, among the lanes
// `live`: one ballot for each of the digit's `bits` low bits.
__device__ __forceinline__ unsigned digit_peers(int d, int bits, unsigned live) {
  unsigned m = live;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < bits) {
      const bool bit = (d >> b) & 1;
      const unsigned v = __ballot_sync(0xffffffffu, bit);
      m &= bit ? v : ~v;
    }
  }
  return m;
}

__device__ __forceinline__ unsigned long long low_bits(int len) {
  return len >= 64 ? ~0ULL : (1ULL << len) - 1ULL;
}

// The positions a CTA holds after cluster_sort: position i in [lo, hi)
// is row row(i); where the keys were packed (packed), bits(l, i) is its
// lane-l key bits, rebuilt from the packed bits and the constant ones.
struct SortRange {
  const SortSmem* sm;
  int lo, hi;
  bool packed, rowkey;
  __device__ __forceinline__ unsigned row(int i) const {
    return rowkey ? static_cast<unsigned>(sm->key[i - lo] >> kSortRowShift) : sm->row[i - lo];
  }
  __device__ __forceinline__ unsigned long long bits(int l, int i) const {
    const unsigned long long k = sm->key[i - lo];
    if (sm->split && ((k >> sm->valid_bit) & 1ULL)) return sm->invalid_bits[l];
    unsigned long long v = sm->fixed[l];
    for (int r = 0; r < sm->n_runs; ++r)
      if (sm->run_lane[r] == l)
        v |= ((k >> sm->run_pos[r]) & low_bits(sm->run_len[r])) << sm->run_shift[r];
    return v;
  }
};

// Keys: lanes() key lanes, most significant first; wide(l): lane l has 64
// bits, else 32; bits(l, row): the row's key bits in unsigned order (the
// caller flips a signed lane's sign bit). Rows at or past valid_rows sort
// after every other row. Every thread of every CTA of the cluster calls
// it with the same n and valid_rows; it returns with the cluster
// synchronised, so no CTA's shared memory is read or written any more.
template <class Keys>
__device__ SortRange cluster_sort(SortSmem& sm, const Keys& keys, int n, int valid_rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = ((n + n_ctas - 1) / n_ctas + 31) & ~31;
  const int lo = min(n, me * chunk), hi = min(n, lo + chunk);
  const int warp_rows = ((chunk + kSortWarps - 1) / kSortWarps + 31) & ~31;
  const int w_lo = min(hi, lo + warp * warp_rows), w_hi = min(hi, w_lo + warp_rows);
  const int n_lanes = keys.lanes();

  // 1. the bits that vary over the cluster's rows: each warp's OR and AND
  // a lane, then thread l folds the warps' (a 64-bit shared atomic is a
  // compare-and-swap loop, 32 warps deep)
  for (int l = 0; l < n_lanes; ++l) {
    unsigned long long o[2] = {0ULL, 0ULL}, a[2] = {~0ULL, ~0ULL};
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {      // 8 loads in flight
      const int i = lo + tid + s * kSortThreads;
      if (i < hi) {
        const unsigned long long b = keys.bits(l, i);
        const int g = i >= valid_rows;
        o[g] |= b;
        a[g] &= b;
      }
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        o[g] |= __shfl_xor_sync(0xffffffffu, o[g], off);
        a[g] &= __shfl_xor_sync(0xffffffffu, a[g], off);
      }
      if (lane == 0) {
        sm.warp_or[g][l][warp] = o[g];
        sm.warp_and[g][l][warp] = a[g];
      }
    }
  }
  __syncthreads();
  if (tid < 2 * n_lanes) {
    const int g = tid / n_lanes, l = tid % n_lanes;
    unsigned long long o = 0ULL, a = ~0ULL;
    for (int w = 0; w < kSortWarps; ++w) {
      o |= sm.warp_or[g][l][w];
      a &= sm.warp_and[g][l][w];
    }
    sm.bits_or[g][l] = o;
    sm.bits_and[g][l] = a;
  }
  cluster.sync();
  if (tid < n_ctas) {
    sm.remote_row[tid] = cluster.map_shared_rank(sm.row, tid);
    sm.remote_key[tid] = cluster.map_shared_rank(sm.key, tid);
  }
  if (tid == 0) {
    // the runs of varying bits, from the last lane's lowest, and the byte
    // passes that would read them unpacked
    int runs = 0, pos = 0, np = 0;
    bool fits = true;
    unsigned long long o[2][kSortMaxLanes], a[2][kSortMaxLanes];
    bool split = valid_rows < n;
    for (int l = 0; l < n_lanes; ++l)
      for (int g = 0; g < 2; ++g) {
        o[g][l] = 0ULL;
        a[g][l] = ~0ULL;
        for (int c = 0; c < n_ctas; ++c) {
          o[g][l] |= *cluster.map_shared_rank(&sm.bits_or[g][l], c);
          a[g][l] &= *cluster.map_shared_rank(&sm.bits_and[g][l], c);
        }
        if (g == 1 && o[1][l] != a[1][l]) split = false;
      }
    sm.split = split;
    for (int l = n_lanes - 1; l >= 0; --l) {
      // the byte passes read every row's key; split, the packed bits
      // are the valid rows' only
      const unsigned long long all_o = o[0][l] | o[1][l], all_a = a[0][l] & a[1][l];
      sm.fixed[l] = split ? a[0][l] : all_a;
      sm.invalid_bits[l] = a[1][l];
      sm.run_first[l] = runs;
      const unsigned long long bytes = all_o & ~all_a;
      unsigned long long v = split ? o[0][l] & ~a[0][l] : bytes;
      for (int shift = 0; shift < (keys.wide(l) ? 64 : 32); shift += 8)
        if ((bytes >> shift) & 0xFFULL) {
          sm.pass_lane[np] = static_cast<signed char>(l);
          sm.pass_shift[np++] = static_cast<unsigned char>(shift);
        }
      while (v) {
        const int t = __ffsll(static_cast<long long>(v)) - 1;
        const unsigned long long rest = ~(v >> t);
        const int len = rest ? __ffsll(static_cast<long long>(rest)) - 1 : 64 - t;
        if (runs == kSortMaxRuns || pos + len > 64) fits = false;
        if (fits) {
          sm.run_lane[runs] = static_cast<signed char>(l);
          sm.run_shift[runs] = static_cast<unsigned char>(t);
          sm.run_len[runs] = static_cast<unsigned char>(len);
          sm.run_pos[runs++] = static_cast<unsigned char>(pos);
        }
        pos += len;
        v &= ~(low_bits(len) << t);
      }
      sm.run_count[l] = runs - sm.run_first[l];
    }
    if (valid_rows < n) {
      sm.pass_lane[np] = -1;
      sm.pass_shift[np++] = 0;
      fits = fits && pos < 64;
      sm.valid_bit = pos++;
    } else {
      sm.valid_bit = -1;
    }
    sm.n_runs = runs;
    sm.packed = fits;
    sm.n_passes = fits ? (pos + 7) / 8 : np;
    sm.n_bits = pos;
  }
  __syncthreads();
  const int n_passes = sm.n_passes;
  const bool packed = sm.packed != 0;
  const int key_bits = sm.n_bits;
  const bool rowkey = packed && key_bits <= kSortRowShift;
  // pos / chunk for pos < 2^16 and 32 <= chunk <= 8,192: a multiply-high
  const unsigned chunk_magic = 0xffffffffu / static_cast<unsigned>(chunk) + 1u;

  // 2. each row's number and, packed, its key: 4 rows a thread at a time,
  // a lane's 4 rows loaded together, then its runs placed
  constexpr int kHalf = kSortItems / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned long long k[kHalf];
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const int i = lo + tid + (h * kHalf + s) * kSortThreads;
      k[s] = rowkey ? static_cast<unsigned long long>(i) << kSortRowShift : 0ULL;
      if (sm.valid_bit >= 0 && i >= valid_rows) k[s] |= 1ULL << sm.valid_bit;
      if (!rowkey && i < hi) sm.row[i - lo] = static_cast<unsigned short>(i);
    }
    if (!packed) continue;
    for (int l = 0; l < n_lanes; ++l) {
      const int r0 = sm.run_first[l], r1 = r0 + sm.run_count[l];
      if (r0 == r1) continue;
      unsigned long long b[kHalf];
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        const int i = lo + tid + (h * kHalf + s) * kSortThreads;
        b[s] = i < hi && !(sm.split && i >= valid_rows) ? keys.bits(l, i) : 0ULL;
      }
      for (int r = r0; r < r1; ++r) {
        const int sh = sm.run_shift[r], at = sm.run_pos[r];
        const unsigned long long mask = low_bits(sm.run_len[r]);
#pragma unroll
        for (int s = 0; s < kHalf; ++s) k[s] |= ((b[s] >> sh) & mask) << at;
      }
    }
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      const int i = lo + tid + (h * kHalf + s) * kSortThreads;
      if (i < hi) sm.key[i - lo] = k[s];
    }
  }
  __syncthreads();

  // 3. the passes
  const unsigned below_lane = (1u << lane) - 1u;
  for (int j = 0; j < n_passes; ++j) {
    // this warp's rows' digits: packed, bits 8j.. of the key; else the
    // byte read through the row numbers (8 reads in flight a lane)
    int d[kSortItems];
    if (packed) {
#pragma unroll
      for (int s = 0; s < kSortItems; ++s) {
        const int i = w_lo + s * 32 + lane;
        d[s] = i < w_hi ? static_cast<int>((sm.key[i - lo] >> (8 * j)) & 0xFFULL) : kSortRadix;
      }
    } else {
      const int l = sm.pass_lane[j], shift = sm.pass_shift[j];
#pragma unroll
      for (int s = 0; s < kSortItems; ++s) {
        const int i = w_lo + s * 32 + lane;
        if (i < w_hi) {
          const unsigned r = sm.row[i - lo];
          d[s] = l < 0 ? (r >= static_cast<unsigned>(valid_rows) ? 1 : 0)
                       : static_cast<int>((keys.bits(l, r) >> shift) & 0xFFULL);
          sm.digit[i - lo] = static_cast<unsigned char>(d[s]);
        } else {
          d[s] = kSortRadix;
        }
      }
    }
    // the digit's bits in this pass: 8, fewer in a packed key's top pass,
    // 1 in the unpacked valid pass
    const int bits = packed ? min(8, max(1, key_bits - 8 * j)) : (sm.pass_lane[j] < 0 ? 1 : 8);
    unsigned peers[kSortItems];
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {
      // warp-uniform: a step past the warp's rows has none, a full one all
      const int first = w_lo + s * 32;
      if (first >= w_hi) {
        peers[s] = 0u;
        continue;
      }
      const unsigned live = first + 32 <= w_hi ? 0xffffffffu
                                               : __ballot_sync(0xffffffffu, d[s] < kSortRadix);
      peers[s] = digit_peers(d[s], bits, live);
    }
    int* wc = sm.warp_count[warp];
    for (int i = lane; i < kSortRadix; i += 32) wc[i] = 0;
    __syncwarp();
    // a row's rank in its warp: the warp's count of its digit before its
    // step, plus its peers in lower lanes
    int rank[kSortItems];
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {
      const bool live = d[s] < kSortRadix;
      rank[s] = live ? wc[d[s]] + __popc(peers[s] & below_lane) : 0;
      __syncwarp();
      if (live && lane == __ffs(peers[s]) - 1) wc[d[s]] += __popc(peers[s]);
      __syncwarp();
    }
    __syncthreads();
    int count = 0;                    // thread d: the CTA's rows of digit d
    if (tid < kSortRadix) {
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = sm.warp_count[w][tid];
        sm.warp_count[w][tid] = count;
        count += c;
      }
      sm.cta_count[tid] = count;
    }
    const int local = digit_scan(count, sm.warp_sum);
    if (tid < kSortRadix) sm.local_base[tid] = local;
    __syncthreads();
    // the CTA's rows in digit order, stably, into the staging buffers
    // (only the ranks stay in registers across the barriers)
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {
      const int i = w_lo + s * 32 + lane;
      if (i < w_hi) {
        const unsigned long long key = packed ? sm.key[i - lo] : 0ULL;
        const int dg = packed ? static_cast<int>((key >> (8 * j)) & 0xFFULL) : sm.digit[i - lo];
        const int at = sm.local_base[dg] + wc[dg] + rank[s];
        if (!rowkey) sm.stage_row[at] = sm.row[i - lo];
        sm.stage_key[at] = packed ? key : static_cast<unsigned long long>(dg);
      }
    }
    cluster.sync();                   // every CTA's counts are visible
    int total = 0, before = 0;
    if (tid < kSortRadix) {
#pragma unroll
      for (int c = 0; c < kSortMaxCtas; ++c) {
        if (c < n_ctas) {
          const int v = *cluster.map_shared_rank(&sm.cta_count[tid], c);
          total += v;
          if (c < me) before += v;
        }
      }
    }
    const int start = digit_scan(total, sm.warp_sum);
    if (tid < kSortRadix) sm.base[tid] = start + before;
    __syncthreads();
    // each digit's run of the staging buffers to its place in the cluster
    for (int i = tid; i < hi - lo; i += kSortThreads) {
      const unsigned long long k = sm.stage_key[i];
      const int dg = packed ? static_cast<int>((k >> (8 * j)) & 0xFFULL) : static_cast<int>(k);
      const int pos = sm.base[dg] + i - sm.local_base[dg];
      const int owner = static_cast<int>(__umulhi(static_cast<unsigned>(pos), chunk_magic));
      const int at = pos - owner * chunk;
      if (!rowkey) sm.remote_row[owner][at] = sm.stage_row[i];
      if (packed) sm.remote_key[owner][at] = k;
    }
    cluster.sync();
  }
  // no pass: the CTAs may still read each other's OR / AND words
  if (n_passes == 0) cluster.sync();
  return SortRange{&sm, lo, hi, packed, rowkey};
}

}  // namespace pinot
