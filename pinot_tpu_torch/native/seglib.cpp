// Native segment-build hot loops.
//
// Copy of pinot_tpu/native/seglib.cpp. The card answers queries; the HOST
// builds segments — and the build's hot
// loops (cube grouping, grouped stats, fixed-bit packing) are pure
// pointer-chasing/accumulation work where numpy pays a full array pass
// per operator. This is the same division of labor as the reference,
// whose segment creation is native Java/C++ speed
// (core/segment/creator/impl/SegmentIndexCreationDriverImpl.java): one
// tight loop per task, compiled -O3, called through ctypes.
//
// Build: compiled on first use by pinot_tpu_torch/native/__init__.py with g++
// (graceful numpy fallback when no compiler is present).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// pack_bits: ids (< 2^nb) -> dense little-endian bitstream as uint32 words
// ---------------------------------------------------------------------------
void pack_bits_u32(const int32_t* ids, int64_t n, int nb, uint32_t* out,
                   int64_t n_words) {
    std::memset(out, 0, n_words * sizeof(uint32_t));
    uint64_t acc = 0;      // bit accumulator, low bits first
    int fill = 0;          // bits currently in acc
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc |= (uint64_t)(uint32_t)ids[i] << fill;
        fill += nb;
        while (fill >= 32) {
            out[w++] = (uint32_t)acc;
            acc >>= 32;
            fill -= 32;
        }
    }
    if (fill > 0 && w < n_words) out[w] = (uint32_t)acc;
}

// inverse of pack_bits_u32: dense little-endian bitstream -> ids
void unpack_bits_u32(const uint32_t* words, int64_t n_words, int nb,
                     int64_t n, int32_t* out) {
    uint64_t acc = 0;
    int fill = 0;
    int64_t w = 0;
    const uint32_t mask = (nb >= 32) ? 0xFFFFFFFFu
                                     : ((1u << nb) - 1u);
    for (int64_t i = 0; i < n; ++i) {
        while (fill < nb && w < n_words) {
            acc |= (uint64_t)words[w++] << fill;
            fill += 32;
        }
        out[i] = (int32_t)(acc & mask);
        acc >>= nb;
        fill -= nb;
    }
}

// ---------------------------------------------------------------------------
// group_index_i64: row keys -> per-row group ranks (sorted-key order) +
// sorted unique keys. Open-addressing hash (splitmix64 mix), then the
// unique set (tiny vs n) is sorted and ranks remapped.
// Returns g (number of groups), or -1 on alloc failure.
// ---------------------------------------------------------------------------
static inline uint64_t mix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

int64_t group_index_i64(const int64_t* key, int64_t n,
                        int64_t* uniq_out, int32_t* rank_out) {
    if (n <= 0) return 0;
    uint64_t cap = 1;
    while (cap < (uint64_t)n * 2) cap <<= 1;
    std::vector<int64_t> tkey;
    std::vector<int32_t> tgid;
    try {
        tkey.assign(cap, INT64_MIN);     // INT64_MIN = empty sentinel
        tgid.assign(cap, -1);
    } catch (...) { return -1; }
    const uint64_t mask = cap - 1;
    int64_t ng = 0;
    // pass 1: assign provisional group ids in first-seen order
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = key[i];
        uint64_t h = mix64((uint64_t)k) & mask;
        for (;;) {
            if (tkey[h] == k) { rank_out[i] = tgid[h]; break; }
            if (tkey[h] == INT64_MIN) {
                tkey[h] = k;
                tgid[h] = (int32_t)ng;
                uniq_out[ng] = k;
                rank_out[i] = (int32_t)ng;
                ++ng;
                break;
            }
            h = (h + 1) & mask;
        }
    }
    // sort unique keys, remap provisional ids -> sorted ranks
    std::vector<int32_t> order((size_t)ng);
    for (int64_t i = 0; i < ng; ++i) order[i] = (int32_t)i;
    std::sort(order.begin(), order.end(),
              [&](int32_t a, int32_t b) { return uniq_out[a] < uniq_out[b]; });
    std::vector<int32_t> rank_of((size_t)ng);
    std::vector<int64_t> sorted((size_t)ng);
    for (int64_t r = 0; r < ng; ++r) {
        rank_of[order[r]] = (int32_t)r;
        sorted[r] = uniq_out[order[r]];
    }
    std::memcpy(uniq_out, sorted.data(), (size_t)ng * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) rank_out[i] = rank_of[rank_out[i]];
    return ng;
}

// ---------------------------------------------------------------------------
// grouped stats: one pass accumulating count/sum/min/max per group
// ---------------------------------------------------------------------------
void group_counts_i64(const int32_t* rank, int64_t n, int64_t g,
                      int64_t* counts) {
    std::memset(counts, 0, (size_t)g * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) counts[rank[i]]++;
}

void group_stats_f64(const int32_t* rank, const double* vals, int64_t n,
                     int64_t g, double* sums, double* mins, double* maxs) {
    for (int64_t j = 0; j < g; ++j) {
        sums[j] = 0.0;
        mins[j] = 1e308 * 10;            // +inf
        maxs[j] = -1e308 * 10;           // -inf
    }
    for (int64_t i = 0; i < n; ++i) {
        int32_t r = rank[i];
        double v = vals[i];
        sums[r] += v;
        if (v < mins[r]) mins[r] = v;
        if (v > maxs[r]) maxs[r] = v;
    }
}

// grouped stats over an argsort permutation: one pass fusing the gather
// (vals[order]) with sum/min/max accumulation per run — replaces a 64MB
// materialized gather plus three reduceat passes
void group_stats_sorted_f64(const int64_t* order, const int64_t* starts,
                            int64_t g, int64_t n, const double* vals,
                            double* sums, double* mins, double* maxs) {
    for (int64_t j = 0; j < g; ++j) {
        int64_t e = (j + 1 < g) ? starts[j + 1] : n;
        double s = 0.0, mn = 1e308 * 10, mx = -1e308 * 10;
        for (int64_t i = starts[j]; i < e; ++i) {
            double v = vals[order[i]];
            s += v;
            if (v < mn) mn = v;
            if (v > mx) mx = v;
        }
        sums[j] = s;
        mins[j] = mn;
        maxs[j] = mx;
    }
}

// mixed-radix packed key construction: key = ((d0*c1)+d1)*c2+d2 ... in one
// pass (numpy pays 2 full passes per dimension)
void packed_key_i64(const int32_t* const* dims, const int64_t* cards,
                    int n_dims, int64_t n, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = 0;
        for (int d = 0; d < n_dims; ++d) k = k * cards[d] + dims[d][i];
        out[i] = k;
    }
}

}  // extern "C"
