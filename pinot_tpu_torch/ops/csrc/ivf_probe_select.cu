// K9 ivf_probe_select: the IVF probe list of each segment's codebook, for
// one query or up to 8.
//
// K9 replaces pinot_tpu/ops/kernels.py:ivf_select_probes (:140), the probe
// list of the "ivf_probe" filter predicate (_eval_ivf_probe, :161) and
// pinot_tpu/ops/ivf_kernels.py:build_ivf_probe_kernel (:74): the nprobe
// live centroids of highest score, by the monotone int32 key of the score
// clamped to >= -INT32_MAX (INT32_MIN for a centroid whose cvalid is
// false), descending, ties to the lower centroid id, as lax.top_k orders
// them; ok[i] = i < the number of live centroids. A centroid's score is
// K8's (vector_scores.cu) bit for bit: the same rounded operations of
// vec_tree.cuh. What bounds K9: the codebook's bytes (C_pad * dim_pad * 4:
// 128 KB at 256 x 128, 4 MB at 8,192 x 128) and the ranking. One launch
// per call, a thread-block cluster per (segment, member): 1 CTA up to
// 1,024 centroids, else 2, 4 or 8 CTAs on neighbouring SMs, each taking a
// tile of at most 1,024. A CTA scores its tile (the butterflies of U rows
// in flight reduced as one reduce-scatter, 16 rows a lane group at 128
// dims) and packs one 64-bit word a centroid: the key's order-preserving
// bits high, ~id low, so a larger word is a higher key or, on equal keys,
// the lower id. A bitonic sort in shared memory orders the tile's words
// descending (the steps below a distance of 64 in registers, a warp's 64
// words at a time), and the live words lead, which gives the tile's live
// count. After cluster.sync() every CTA ranks its best min(nprobe, tile)
// words against the other tiles' best through distributed shared memory
// (a binary search a tile, all tiles in step: a word's rank is its place
// in its own tile plus the words above it in the others) and writes the
// ids of ranks below nprobe; CTA 0 sums the tiles' live counts the same
// way and writes ok. The ranks are a total order, so each rank below
// nprobe is written by exactly one thread, and a word truncated from a
// tile's list never changes a rank below nprobe (a tile that drops a word
// above w keeps nprobe words above w). Cost O(C_pad log^2 tile) spread
// over the cluster, no global scratch, no counters.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): the grid
// gains a member axis, cluster (s, b) ranking codebook s for query b.

#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"
#include "vec_tree.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kProbeTile = 1024;      // centroids a CTA ranks at most
constexpr int kMaxCluster = 8;        // CTAs a cluster (the portable limit)
constexpr int kMaxCentroids = kProbeTile * kMaxCluster;

// K9's block shape: threads, and rows in flight a lane group (a CTA
// reads its tile of up to 1,024 rows with up to 64 floats a lane in
// flight, 128 KB a CTA at 128 dims, to cover device memory's latency)
template <int E>
struct ProbeShape {
  static constexpr int kThreads = E <= 16 ? 512 : 256;
  static constexpr int kRows = E >= 64 ? 1 : (64 / E > 16 ? 16 : 64 / E);
};

// A centroid's rank word: the key's bits in unsigned order high, ~id low.
__device__ __forceinline__ unsigned long long probe_word(int key, int id) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
         static_cast<unsigned>(~id);
}

// One compare-exchange of the bitonic network at distance j < 32 for the
// word x at position p, its partner in lane ^ j: in a descending block of
// stage k the lower position keeps the larger word.
__device__ __forceinline__ unsigned long long bitonic_lane_step(unsigned long long x, int p,
                                                                int k, int j) {
  const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, j);
  const bool larger = ((p & j) == 0) == ((p & k) == 0);
  return larger ? (x > y ? x : y) : (x < y ? x : y);
}

// Steps j = min(k / 2, 32) .. 1 of stage k (k >= 64) on a warp's 64 words
// at x0 (position p0) and x1 (p0 + 32), lane l holding p0 = base + l.
__device__ __forceinline__ void bitonic_warp_steps(unsigned long long& x0,
                                                   unsigned long long& x1, int p0, int k) {
  const bool desc = (p0 & k) == 0;                     // j = 32: both in this lane
  const unsigned long long big = x0 > x1 ? x0 : x1, small = x0 > x1 ? x1 : x0;
  x0 = desc ? big : small;
  x1 = desc ? small : big;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    x0 = bitonic_lane_step(x0, p0, k, j);
    x1 = bitonic_lane_step(x1, p0 + 32, k, j);
  }
}

// Bitonic sort of n (a power of two) words in shared memory, descending.
// Every thread of the block calls it, after the words are written and
// visible; it returns with the block synchronised. From 64 words on, the
// stages up to 64 and every step at a distance below 64 run in registers
// a warp (64 words, two a lane, shuffles), so a 1,024-word tile takes 14
// block barriers instead of 55.
__device__ void sort_words_desc(unsigned long long* w, int n) {
  const int l = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if (n < 64) {
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
          const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));   // bit j clear
          const int c = a | j;
          const unsigned long long x = w[a], y = w[c];
          if ((a & k) == 0 ? x < y : x > y) {
            w[a] = y;
            w[c] = x;
          }
        }
        __syncthreads();
      }
    }
    return;
  }
  // base is warp-uniform, so every lane reaches every shuffle
  for (int base = warp * 64; base < n; base += n_warps * 64) {
    const int p0 = base + l;
    unsigned long long x0 = w[p0], x1 = w[p0 + 32];
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        x0 = bitonic_lane_step(x0, p0, k, j);
        x1 = bitonic_lane_step(x1, p0 + 32, k, j);
      }
    bitonic_warp_steps(x0, x1, p0, 64);
    w[p0] = x0;
    w[p0 + 32] = x1;
  }
  __syncthreads();
  for (int k = 128; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int a = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int c = a | j;
        const unsigned long long x = w[a], y = w[c];
        if ((a & k) == 0 ? x < y : x > y) {
          w[a] = y;
          w[c] = x;
        }
      }
      __syncthreads();
    }
    for (int base = warp * 64; base < n; base += n_warps * 64) {
      const int p0 = base + l;
      unsigned long long x0 = w[p0], x1 = w[p0 + 32];
      bitonic_warp_steps(x0, x1, p0, k);
      w[p0] = x0;
      w[p0 + 32] = x1;
    }
    __syncthreads();
  }
}

// Cluster (s, b) of gridDim.x CTAs: codebook s for query b. CTA `me`
// takes centroids [me * tile, min(c_pad, (me + 1) * tile)), its words
// padded with zeros (below every centroid's word) to tile_pad. A row over
// L lanes of E elements, U rows a lane group in flight, scored by K8's
// step (vec_tree.cuh:score_rows with one query slot): each lane's
// subtrees of the U rows' products and squares, then warp_tree_scatter
// over the U rows (the same pairs as warp_tree's butterflies), so lane x
// < min(U, L) ends with rows (x & (min(U, L) - 1)) + t * min(U, L) and
// scores them.
template <int L, int E, bool kCos>
__global__ void __launch_bounds__(ProbeShape<E>::kThreads)
    probe_select_kernel(const float* __restrict__ cent, const uint8_t* __restrict__ cvalid,
                        int c_pad, int tile, int tile_pad, const float* __restrict__ q,
                        pinot::QNorms q_norms, int nprobe, int* __restrict__ ids,
                        uint8_t* __restrict__ ok) {
  constexpr int kDim = L * E;
  constexpr int U = ProbeShape<E>::kRows;
  constexpr int rpw = 32 / L;            // rows per warp and unrolled step
  cg::cluster_group cluster = cg::this_cluster();
  const int me = static_cast<int>(cluster.block_rank());
  const int n_ctas = static_cast<int>(cluster.num_blocks());
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* words = reinterpret_cast<unsigned long long*>(smem);
  float* qs = reinterpret_cast<float*>(words + tile_pad);
  __shared__ int live;
  const long long s = blockIdx.y;
  const int member = blockIdx.z;
  const float* mat = cent + s * c_pad * kDim;
  const uint8_t* valid = cvalid + s * c_pad;
  const float q_norm = q_norms.v[member];
  q += static_cast<long long>(member) * kDim;
  const long long out = (static_cast<long long>(member) * gridDim.y + s) * nprobe;
  const int lo = me * tile, hi = min(c_pad, lo + tile);
  for (int i = threadIdx.x; i < kDim; i += blockDim.x) qs[i] = q[i];
  for (int i = threadIdx.x; i < tile_pad; i += blockDim.x) words[i] = 0ull;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  // r0 is warp-uniform, so every lane reaches every shuffle
  for (int r0 = lo + warp * rpw * U; r0 < hi; r0 += n_warps * rpw * U) {
    float m[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * rpw + sub;
      pinot::load_lane<E>(mat, r < hi ? r : -1, kDim, li, m[u]);
    }
    pinot::score_rows<L, E, U, 1, kCos>(m, qs, &q_norm, 1, li, [&](int, int u, float score) {
      const int r = r0 + u * rpw + sub;
      if (r < hi) words[r - lo] = probe_word(valid[r] ? pinot::score_key(score) : INT_MIN, r);
    });
  }
  __syncthreads();
  sort_words_desc(words, tile_pad);
  // the live centroids' words lead: a dead one's key bits are 0
  for (int i = threadIdx.x; i < tile_pad; i += blockDim.x)
    if ((words[i] >> 32) != 0 && (i + 1 == tile_pad || (words[i + 1] >> 32) == 0)) live = i + 1;
  // every tile's sorted words and live count are visible to the cluster
  cluster.sync();
  const int keep = min(nprobe, hi - lo), deepest = min(nprobe, tile);
  const unsigned long long* other[kMaxCluster];
  int others_keep[kMaxCluster];
#pragma unroll
  for (int t = 0; t < kMaxCluster; ++t) {
    const bool there = t < n_ctas && t != me;
    others_keep[t] = there ? min(nprobe, min(c_pad, t * tile + tile) - t * tile) : 0;
    other[t] = cluster.map_shared_rank(words, there ? t : me);
  }
  for (int i = threadIdx.x; i < keep; i += blockDim.x) {
    const unsigned long long w = words[i];
    // the words of each other tile above w (descending), the tiles'
    // binary searches in step so their remote loads overlap
    int a[kMaxCluster], z[kMaxCluster];
#pragma unroll
    for (int t = 0; t < kMaxCluster; ++t) {
      a[t] = 0;
      z[t] = others_keep[t];
    }
    for (int span = deepest; span > 0; span >>= 1) {
#pragma unroll
      for (int t = 0; t < kMaxCluster; ++t) {
        if (a[t] < z[t]) {
          const int mid = (a[t] + z[t]) >> 1;
          if (other[t][mid] > w)
            a[t] = mid + 1;
          else
            z[t] = mid;
        }
      }
    }
    int rank = i;
#pragma unroll
    for (int t = 0; t < kMaxCluster; ++t) rank += a[t];
    if (rank < nprobe) ids[out + rank] = static_cast<int>(~static_cast<unsigned>(w));
  }
  if (me == 0) {
    int n_live = 0;
#pragma unroll
    for (int t = 0; t < kMaxCluster; ++t)
      if (t < n_ctas) n_live += *cluster.map_shared_rank(&live, t);
    for (int i = threadIdx.x; i < nprobe; i += blockDim.x) ok[out + i] = i < n_live ? 1 : 0;
  }
  // no CTA leaves while another still reads its shared memory
  cluster.sync();
}

// One launch: clusters of cl CTAs, grid (cl, n_segs, nq).
template <int L, int E, bool kCos>
cudaError_t launch_probes(const float* cent, const uint8_t* cvalid, int n_segs, int c_pad,
                          const float* q, const pinot::QNorms& q_norms, int nq, int nprobe,
                          int* ids, uint8_t* ok, cudaStream_t stream) {
  int cl = 1;
  while (cl < kMaxCluster && cl * kProbeTile < c_pad) cl <<= 1;
  const int tile = (c_pad + cl - 1) / cl;
  int tile_pad = 2;   // even, so the query after the words is 16-byte aligned
  while (tile_pad < tile) tile_pad <<= 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, n_segs, nq);
  cfg.blockDim = dim3(ProbeShape<E>::kThreads);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(tile_pad) * sizeof(unsigned long long) + L * E * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, probe_select_kernel<L, E, kCos>, cent, cvalid,
                                            c_pad, tile, tile_pad, q, q_norms, nprobe, ids, ok);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

int probes(const void* cent, const void* cvalid, int n_segs, int c_pad, int dim_pad,
           const void* q, const pinot::QNorms& norms, int n_q, int cosine, int nprobe, void* ids,
           void* ok, void* stream) {
  if (n_segs < 1 || n_segs > 65535 || !pinot::pow2(dim_pad) || dim_pad > pinot::kMaxVecDim ||
      c_pad < 1 || c_pad > kMaxCentroids || nprobe < 1 || nprobe > c_pad || n_q < 1 ||
      n_q > pinot::kMaxMembers)
    return -1;
  cudaError_t rc = cudaSuccess;
  const float* c = static_cast<const float*>(cent);
  const uint8_t* v = static_cast<const uint8_t*>(cvalid);
  const float* qp = static_cast<const float*>(q);
  int* out_ids = static_cast<int*>(ids);
  uint8_t* out_ok = static_cast<uint8_t*>(ok);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_PROBES(L, E, C) \
  launch_probes<L, E, C>(c, v, n_segs, c_pad, qp, norms, n_q, nprobe, out_ids, out_ok, s)
  PINOT_VEC_DISPATCH_DIM(dim_pad, PINOT_PROBES)
#undef PINOT_PROBES
  return static_cast<int>(rc);
}

}  // namespace

// ids int32 [n_segs][nprobe], ok uint8 [n_segs][nprobe]; cent f32
// [n_segs][c_pad][dim_pad], cvalid uint8 [n_segs][c_pad].
extern "C" int pinot_ivf_probe_select(const void* cent, const void* cvalid, int n_segs,
                                      int c_pad, int dim_pad, const void* q, float q_norm,
                                      int cosine, int nprobe, void* ids, void* ok,
                                      void* stream) {
  pinot::QNorms norms{};
  norms.v[0] = q_norm;
  return probes(cent, cvalid, n_segs, c_pad, dim_pad, q, norms, 1, cosine, nprobe, ids, ok,
                stream);
}

// n_q <= 8 queries q f32 [n_q][dim_pad] with host norms q_norms[n_q]: ids
// int32 [n_q][n_segs][nprobe], ok uint8 [n_q][n_segs][nprobe].
extern "C" int pinot_ivf_probe_select_batched(const void* cent, const void* cvalid,
                                              int n_segs, int c_pad, int dim_pad,
                                              const void* q, const float* q_norms, int n_q,
                                              int cosine, int nprobe, void* ids, void* ok,
                                              void* stream) {
  if (n_q < 1 || n_q > pinot::kMaxMembers) return -1;
  pinot::QNorms norms{};
  for (int b = 0; b < n_q; ++b) norms.v[b] = q_norms[b];
  return probes(cent, cvalid, n_segs, c_pad, dim_pad, q, norms, n_q, cosine, nprobe, ids, ok,
                stream);
}
