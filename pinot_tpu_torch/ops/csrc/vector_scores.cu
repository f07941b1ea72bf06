// K8 vector_scores: similarity scores of f32 embedding rows against one
// query, or against up to 8 in one pass over the rows.
//
// K8 replaces pinot_tpu/ops/kernels.py:vec_tree_sum (:1412) and
// _vector_scores (:1430): score[r] = tree(mat[r] * q) ("dot"), or under
// "cosine" tree(mat[r] * q) / (sqrt(tree(mat[r] * mat[r])) * q_norm), -inf
// where that denominator is not > 0 (a zero-norm row never ranks). The
// scores are bit for bit the JAX function's: the same products, the same
// balanced tree of f32 adds, the same sqrt and division, each rounded
// once (vec_tree.cuh). q is zero-padded to dim_pad and q_norm is the
// planner's tree norm of it. The lane is [rows, dim_pad] for one segment
// or the [S * P, dim_pad] view of a stack: a score depends on its row
// only.
//
// What bounds K8: bytes. Each row is read once (dim_pad * 4 bytes: 512 at
// 128 dims) and one f32 written, a few adds per element; 10M rows of 128
// dims read 5.12 GB. What the design does about it: a warp reads a row
// (or 32 / dim_pad rows when dim_pad < 32) with consecutive lanes on
// consecutive 16-byte words, U rows per pass in flight, and reduces it in
// registers and shuffles; q lives in shared memory.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): up to 8
// query vectors of one plan. K8 reads each row once for all of them,
// with the single kernel's coalesced loads (a row over L lanes, E
// contiguous floats a lane, U rows in flight). Each lane sums its slice
// of every (row, member) product as its subtree (lane_tree), then one
// reduce-scatter butterfly over the U x 8 sums (warp_tree_scatter)
// replaces 8 x U separate butterflies: at 128 dims, 31 shuffles for 4 rows
// where they took 160, and every lane ends holding one (row, member) dot.
// The row's norm tree reduces the same way. So the cosine's sqrt and
// division run once per (row, member) and not in every lane, and a
// member's scores leave as runs of U consecutive floats. Each member's
// score is the same sequence of rounded operations as its own launch's,
// so the scores are bit for bit those of B single launches. The queries
// sit in shared memory (past 48 KB at wide dim_pad, under the opt-in
// limit: 8 x 4096 floats take 128 KB). K9 (the IVF probe list, whose
// scoring is K8's) is in ivf_probe_select.cu.

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

// rows in flight per lane group and pass
template <int E>
__host__ __device__ constexpr int rows_unroll() {
  return E <= 4 ? 4 : (E <= 16 ? 2 : 1);
}

// The score of the row whose lane-li elements are m (all L lanes of the
// row call it; the result is valid in every lane).
template <int E, bool kCos>
__device__ __forceinline__ float row_score(const float* m, const float* qv, int L, float q_norm) {
  float dot = pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[i], qv[i]); });
  dot = pinot::warp_tree(dot, L);
  float norm2 = 0.f;
  if constexpr (kCos) {
    norm2 = pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[i], m[i]); });
    norm2 = pinot::warp_tree(norm2, L);
  }
  return pinot::vec_score(dot, norm2, q_norm, kCos);
}

template <int E, bool kCos>
__global__ void __launch_bounds__(pinot::kThreads)
    vector_scores_kernel(const float* __restrict__ mat, long long rows, int dim_pad,
                         const float* __restrict__ q, float q_norm, float* __restrict__ out) {
  extern __shared__ float qs[];
  for (int i = threadIdx.x; i < dim_pad; i += blockDim.x) qs[i] = q[i];
  __syncthreads();
  constexpr int U = rows_unroll<E>();
  const int L = dim_pad / E;             // lanes per row, a power of two <= 32
  const int rpw = 32 / L;                // rows per warp and unrolled step
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const float* qv = qs + li * E;
  // r0 is warp-uniform, so every lane reaches every shuffle
  for (long long r0 = warp * rpw * U; r0 < rows; r0 += n_warps * rpw * U) {
    float m[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * rpw + sub;
      pinot::load_lane<E>(mat, r < rows ? r : -1, dim_pad, li, m[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = row_score<E, kCos>(m[u], qv, L, q_norm);
      const long long r = r0 + u * rpw + sub;
      if (li == 0 && r < rows) out[r] = s;
    }
  }
}

// nq <= 8 query vectors [nq][L * E]: out[b * rows + r] is row r's score
// for query b. The rows' lanes are loaded once; each lane's subtree of
// every (member, row) product and of every row's norm runs in registers
// (the lane's slice of a query read from shared memory once a pass, into
// registers up to 16 elements; past that, one member at a time, which
// keeps the code of a 4,096-wide row's tree to one copy), then
// warp_tree_scatter reduces the U x 8
// dots (sum j = b * U + u; members past nq hold zeros and store nothing)
// and the U norms, and each lane scores the sums it ends with. Rows
// r0 + u * rpw + sub: lanes holding consecutive u of one member store
// consecutive rows.
template <int L, int E, bool kCos>
__global__ void __launch_bounds__(pinot::kThreads)
    vector_scores_batched_kernel(const float* __restrict__ mat, long long rows,
                                 const float* __restrict__ q, pinot::QNorms q_norms, int nq,
                                 float* __restrict__ out) {
  constexpr int kDim = L * E;
  constexpr int U = rows_unroll<E>();
  constexpr int V = U * pinot::kMaxMembers;     // the (member, row) dots a lane starts with
  constexpr int K = V < L ? V : L;       // lanes that end with distinct dots
  constexpr int T = V / K;               // dots a lane ends with
  constexpr int TN = U < L ? 1 : U / L;  // norms a lane ends with
  constexpr int rpw = 32 / L;            // rows per warp and unrolled step
  constexpr bool kRegQ = E <= 16;        // the query slice in registers
  extern __shared__ __align__(16) float qs[];
  __shared__ float s_norms[pinot::kMaxMembers];
  for (int i = threadIdx.x; i < nq * kDim; i += blockDim.x) qs[i] = q[i];
  if (threadIdx.x < pinot::kMaxMembers) {
#pragma unroll
    for (int b = 0; b < pinot::kMaxMembers; ++b)
      if (threadIdx.x == b) s_norms[b] = q_norms.v[b];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // r0 and nq are warp-uniform, so every lane reaches every shuffle
  for (long long r0 = warp * rpw * U; r0 < rows; r0 += n_warps * rpw * U) {
    float m[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * rpw + sub;
      pinot::load_lane<E>(mat, r < rows ? r : -1, kDim, li, m[u]);
    }
    float norm2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      norm2[u] = 0.f;
      if constexpr (kCos)
        norm2[u] = pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], m[u][i]); });
    }
    float acc[V];
    if constexpr (kRegQ) {
#pragma unroll
      for (int b = 0; b < pinot::kMaxMembers; ++b) {
        if (b < nq) {
          float qr[E];
          pinot::load_lane<E>(qs + b * kDim + li * E, 0, 0, 0, qr);
#pragma unroll
          for (int u = 0; u < U; ++u)
            acc[b * U + u] =
                pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], qr[i]); });
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) acc[b * U + u] = 0.f;
        }
      }
    } else {
      // wide rows: a member's tree at a time, its sum placed by
      // compile-time selects, so the tree's code appears once
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 1
      for (int b = 0; b < nq; ++b) {
        const float* qv = qs + b * kDim + li * E;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float d = pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], qv[i]); });
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (j == b * U + u) acc[j] = d;
        }
      }
    }
    pinot::warp_tree_scatter<V, L>(acc, li);
    if constexpr (kCos) pinot::warp_tree_scatter<U, L>(norm2, li);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int j = (li & (K - 1)) + t * K;
      const int b = j / U, u = j % U;
      const long long r = r0 + u * rpw + sub;
      if (li < K && b < nq && r < rows)
        out[b * rows + r] = pinot::vec_score(acc[t], norm2[t % TN], s_norms[b], kCos);
    }
  }
}

// E = dim_pad / min(32, dim_pad) elements per lane
int lane_elems(int dim_pad) { return dim_pad <= 32 ? 1 : dim_pad / 32; }

template <int E, bool kCos>
cudaError_t launch_scores(const float* mat, long long rows, int dim_pad, const float* q,
                          float q_norm, float* out, cudaStream_t stream) {
  const auto kernel = vector_scores_kernel<E, kCos>;
  const size_t smem = static_cast<size_t>(dim_pad) * sizeof(float);
  const int L = dim_pad / E;
  const long long per_warp = static_cast<long long>(32 / L) * rows_unroll<E>();
  const long long threads = (rows + per_warp - 1) / per_warp * 32;
  kernel<<<pinot::grid_for(kernel, threads, smem), pinot::kThreads, smem, stream>>>(
      mat, rows, dim_pad, q, q_norm, out);
  return cudaGetLastError();
}

template <int L, int E, bool kCos>
cudaError_t launch_scores_batched(const float* mat, long long rows, const float* q,
                                  const pinot::QNorms& q_norms, int nq, float* out,
                                  cudaStream_t stream) {
  const auto kernel = vector_scores_batched_kernel<L, E, kCos>;
  const size_t smem = static_cast<size_t>(nq) * L * E * sizeof(float);
  // past 48 KB with the static s_norms the launch needs the opt-in (3
  // queries of 4,096 floats are 48 KB of dynamic memory exactly)
  if (smem + pinot::kMaxMembers * sizeof(float) > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const long long per_warp = static_cast<long long>(32 / L) * rows_unroll<E>();
  const long long threads = (rows + per_warp - 1) / per_warp * 32;
  kernel<<<pinot::grid_for(kernel, threads, smem), pinot::kThreads, smem, stream>>>(
      mat, rows, q, q_norms, nq, out);
  return cudaGetLastError();
}

#define PINOT_VEC_DISPATCH(E_VAL, CALL)                         \
  switch (E_VAL) {                                              \
    case 1: rc = cosine ? CALL(1, true) : CALL(1, false); break;     \
    case 2: rc = cosine ? CALL(2, true) : CALL(2, false); break;     \
    case 4: rc = cosine ? CALL(4, true) : CALL(4, false); break;     \
    case 8: rc = cosine ? CALL(8, true) : CALL(8, false); break;     \
    case 16: rc = cosine ? CALL(16, true) : CALL(16, false); break;  \
    case 32: rc = cosine ? CALL(32, true) : CALL(32, false); break;  \
    case 64: rc = cosine ? CALL(64, true) : CALL(64, false); break;  \
    case 128: rc = cosine ? CALL(128, true) : CALL(128, false); break; \
    default: return -1;                                         \
  }

}  // namespace

// out f32 [rows]; mat f32 [rows][dim_pad], 16-byte aligned; q f32
// [dim_pad] on the card; dim_pad a power of two <= 4096.
extern "C" int pinot_vector_scores(const void* mat, long long rows, int dim_pad, const void* q,
                                   float q_norm, int cosine, void* out, void* stream) {
  if (rows < 0 || !pinot::pow2(dim_pad) || dim_pad > pinot::kMaxVecDim) return -1;
  if (rows == 0) return 0;
  cudaError_t rc = cudaSuccess;
  const float* m = static_cast<const float*>(mat);
  const float* qp = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_SCORES(E, C) launch_scores<E, C>(m, rows, dim_pad, qp, q_norm, o, s)
  PINOT_VEC_DISPATCH(lane_elems(dim_pad), PINOT_SCORES)
#undef PINOT_SCORES
  return static_cast<int>(rc);
}

// out f32 [n_q][rows]: the scores of n_q <= 8 queries q f32 [n_q][dim_pad]
// (on the card) with host norms q_norms[n_q], each row read once.
extern "C" int pinot_vector_scores_batched(const void* mat, long long rows, int dim_pad,
                                           const void* q, const float* q_norms, int n_q,
                                           int cosine, void* out, void* stream) {
  if (rows < 0 || !pinot::pow2(dim_pad) || dim_pad > pinot::kMaxVecDim || n_q < 1 ||
      n_q > pinot::kMaxMembers)
    return -1;
  if (rows == 0) return 0;
  pinot::QNorms norms{};
  for (int b = 0; b < n_q; ++b) norms.v[b] = q_norms[b];
  cudaError_t rc = cudaSuccess;
  const float* m = static_cast<const float*>(mat);
  const float* qp = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_SCORES(L, E, C) launch_scores_batched<L, E, C>(m, rows, qp, norms, n_q, o, s)
  PINOT_VEC_DISPATCH_DIM(dim_pad, PINOT_SCORES)
#undef PINOT_SCORES
  return static_cast<int>(rc);
}
