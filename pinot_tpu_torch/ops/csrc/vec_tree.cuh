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

}  // namespace pinot
