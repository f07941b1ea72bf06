// The vector subsystem's exactness contract on the card: the balanced
// pairwise f32 sum of pinot_tpu/ops/kernels.py:vec_tree_sum (:1412), which
// adds x[2i] + x[2i+1] level by level over a power-of-two width, and the
// scores of _vector_scores (:1430) built on it.
//
// One row of dim_pad floats is spread over L = min(32, dim_pad) lanes of a
// warp, lane l holding the E = dim_pad / L consecutive elements [l * E,
// (l + 1) * E). A lane first sums its own elements as the subtree they
// form (a binary counter over E leaves, so at most log2(E) + 1 partials
// live in registers), then the L lanes combine by an xor butterfly: at
// offset o, lane x adds lane x ^ o, which pairs the subtrees 2j and 2j + 1
// of the level above, exactly the tree's pairing (float addition is
// commutative, so both lanes of a pair hold the same bits). The usual
// shfl_down reduction (x + x[i + 16]) would pair i with i + 16: another
// tree, other bits.
//
// Every product and sum is __fmul_rn / __fadd_rn (and __fsqrt_rn,
// __fdiv_rn for the cosine): nvcc contracts a * b + c into one FMA by
// default, which rounds once where XLA and PyTorch on the CPU round twice;
// the intrinsics are never contracted.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pinot {

constexpr int kMaxVecDim = 4096;   // common/schema.py:MAX_VECTOR_DIMENSION

// The subtree sum of a lane's E elements; `prod(i)` is element i.
template <int E, typename Prod>
__device__ __forceinline__ float lane_tree(Prod prod) {
  float partial[20];
  int n = 0;   // partials held (a binary counter over the leaves)
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float v = prod(i);
    // leaf i closes one subtree per trailing one bit of i
#pragma unroll
    for (int b = 0; b < 20; ++b) {
      if (((i >> b) & 1) == 0) break;
      v = __fadd_rn(partial[n - 1], v);
      --n;
    }
    partial[n++] = v;
  }
  return partial[0];
}

// The butterfly over the L lanes of one row (L a power of two <= 32, the
// rows of a warp in aligned groups of L lanes). Every lane of the warp
// must call it.
__device__ __forceinline__ float warp_tree(float v, int L) {
  for (int o = 1; o < L; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The reduce-scatter form of warp_tree for N sums a lane (N a power of
// two), over the L lanes of a row (aligned groups of L lanes, L a power of
// two <= 32). At offset O the lane keeps the half of its sums selected by
// lane bit O (sums 2i + bit), sends the other half to lane ^ O and adds
// that lane's copy of the half it kept: the same pairing as warp_tree, the
// subtree of the lanes with bit O clear beside the one with it set, so
// every sum is warp_tree's bit for bit (float addition is commutative).
// Once a lane holds one sum, the remaining offsets are warp_tree's own.
// Afterwards a lane holds N / K sums, K = min(N, L): its sum t is the one
// that started at index (lane & (K - 1)) + t * K, and the lanes at and
// past K hold copies of the first K lanes' sums. Each offset costs N / 2
// shuffles while N > 1, where N separate butterflies cost N each.
template <int N, int L, int O = 1>
__device__ __forceinline__ void warp_tree_scatter(float* v, int li) {
  if constexpr (O < L) {
    if constexpr (N > 1) {
      const bool hi = (li & O) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float even = v[2 * i], odd = v[2 * i + 1];
        const float got = __shfl_xor_sync(0xffffffffu, hi ? even : odd, O);
        v[i] = __fadd_rn(hi ? odd : even, got);
      }
      warp_tree_scatter<N / 2, L, O * 2>(v, li);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      warp_tree_scatter<1, L, O * 2>(v, li);
    }
  }
}

// _vector_scores from a row's dot and squared-norm trees: the dot, or
// under cosine dot / (sqrt(norm2) * q_norm), -inf where that is not > 0.
__device__ __forceinline__ float vec_score(float dot, float norm2, float q_norm, bool cosine) {
  if (!cosine) return dot;
  const float denom = __fmul_rn(__fsqrt_rn(norm2), q_norm);
  return denom > 0.f ? __fdiv_rn(dot, denom) : -INFINITY;
}

// The JAX monotone int32 key of an f32 score, clamped to >= -INT32_MAX
// (INT32_MIN is the masked-row sentinel): ivf_select_probes and the
// vector selection kind rank by it.
__device__ __forceinline__ int score_key(float s) {
  const int b = __float_as_int(s);
  const int k = b ^ ((b >> 31) & 0x7fffffff);
  return k < -0x7fffffff ? -0x7fffffff : k;
}

// The batched entries of K8 (vector_scores.cu) and K9 (ivf_probe_select.cu)
// take up to kMaxMembers queries; their norms are passed by value.
constexpr int kMaxMembers = 8;

struct QNorms {
  float v[kMaxMembers];
};

inline bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// Lane li's E elements of row r (zeros when r < 0).
template <int E>
__device__ __forceinline__ void load_lane(const float* __restrict__ mat, long long r, int dim_pad,
                                          int li, float* m) {
  if (r < 0) {
#pragma unroll
    for (int i = 0; i < E; ++i) m[i] = 0.f;
    return;
  }
  const float* p = mat + r * dim_pad + static_cast<long long>(li) * E;
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p)[j];
      m[4 * j] = v.x;
      m[4 * j + 1] = v.y;
      m[4 * j + 2] = v.z;
      m[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) m[i] = p[i];
  }
}

// The (member, row) sums of score_rows: U rows a lane group and M query
// slots give V = U * M dots a lane starts with; after the reduce-scatter
// the K lanes li < K hold distinct ones, T a lane, and TN of the U norms.
template <int L, int U, int M>
struct RowScoreShape {
  static constexpr int V = U * M;
  static constexpr int K = V < L ? V : L;
  static constexpr int T = V / K;
  static constexpr int TN = U < L ? 1 : U / L;
};

// The scores of U rows against nq <= M queries (nq warp-uniform, so
// every lane reaches every shuffle): K8's and K9's one scoring step.
// m[u] holds lane li's E elements of row u (zeros past the end), qs the
// queries' [nq][L * E] floats in shared memory, q_norms[b] query b's
// norm. Each lane sums its slice of every (member, row) product, and of
// every row's square under cosine, as its subtree (the query slice in
// registers up to 16 elements; past that one member at a time, its sums
// placed by compile-time selects, so the tree's code of a 4,096-wide row
// appears once); then one warp_tree_scatter over the U x M dots (sum j =
// b * U + u; slots past nq hold zeros) and one over the U norms replace a
// butterfly a sum. A lane li < K scores each sum it ends with (the
// cosine's root and division once a (member, row)) and calls emit(b, u,
// score) for members b < nq.
template <int L, int E, int U, int M, bool kCos, typename Emit>
__device__ __forceinline__ void score_rows(float (&m)[U][E], const float* qs,
                                           const float* q_norms, int nq, int li, Emit emit) {
  using S = RowScoreShape<L, U, M>;
  constexpr int kDim = L * E;
  float norm2[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    norm2[u] = 0.f;
    if constexpr (kCos) norm2[u] = lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], m[u][i]); });
  }
  float acc[S::V];
  if constexpr (E <= 16) {
#pragma unroll
    for (int b = 0; b < M; ++b) {
      if (b < nq) {
        float qr[E];
        load_lane<E>(qs + b * kDim + li * E, 0, 0, 0, qr);
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[b * U + u] = lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], qr[i]); });
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) acc[b * U + u] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < S::V; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int b = 0; b < nq; ++b) {
      const float* qv = qs + b * kDim + li * E;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float d = lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], qv[i]); });
#pragma unroll
        for (int j = 0; j < S::V; ++j)
          if (j == b * U + u) acc[j] = d;
      }
    }
  }
  warp_tree_scatter<S::V, L>(acc, li);
  if constexpr (kCos) warp_tree_scatter<U, L>(norm2, li);
#pragma unroll
  for (int t = 0; t < S::T; ++t) {
    const int j = (li & (S::K - 1)) + t * S::K;
    const int b = M == 1 ? 0 : j / U, u = M == 1 ? j : j % U;
    if (li < S::K && b < nq)
      emit(b, u, vec_score(acc[t], norm2[t % S::TN], M == 1 ? q_norms[0] : q_norms[b], kCos));
  }
}

}  // namespace pinot

// (L lanes a row, E elements a lane) by dim_pad, and the metric: sets rc
// to CALL(L, E, cosine), or returns -1 for a dim_pad that is not a power of
// two <= kMaxVecDim.
#define PINOT_VEC_DISPATCH_DIM(DIM, CALL)                                     \
  switch (DIM) {                                                              \
    case 1: rc = cosine ? CALL(1, 1, true) : CALL(1, 1, false); break;         \
    case 2: rc = cosine ? CALL(2, 1, true) : CALL(2, 1, false); break;         \
    case 4: rc = cosine ? CALL(4, 1, true) : CALL(4, 1, false); break;         \
    case 8: rc = cosine ? CALL(8, 1, true) : CALL(8, 1, false); break;         \
    case 16: rc = cosine ? CALL(16, 1, true) : CALL(16, 1, false); break;      \
    case 32: rc = cosine ? CALL(32, 1, true) : CALL(32, 1, false); break;      \
    case 64: rc = cosine ? CALL(32, 2, true) : CALL(32, 2, false); break;      \
    case 128: rc = cosine ? CALL(32, 4, true) : CALL(32, 4, false); break;     \
    case 256: rc = cosine ? CALL(32, 8, true) : CALL(32, 8, false); break;     \
    case 512: rc = cosine ? CALL(32, 16, true) : CALL(32, 16, false); break;   \
    case 1024: rc = cosine ? CALL(32, 32, true) : CALL(32, 32, false); break;  \
    case 2048: rc = cosine ? CALL(32, 64, true) : CALL(32, 64, false); break;  \
    case 4096: rc = cosine ? CALL(32, 128, true) : CALL(32, 128, false); break; \
    default: return -1;                                                       \
  }
