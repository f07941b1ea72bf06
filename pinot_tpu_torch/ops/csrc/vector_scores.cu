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
// 128 dims) and one f32 written a query, a few adds per element; 10M rows
// of 128 dims read 5.12 GB. What the design does about it: a warp reads a
// row (or 32 / dim_pad rows when dim_pad < 32) with consecutive lanes on
// consecutive 16-byte words, U rows a lane group in flight, and reduces
// them in registers and shuffles; the queries live in shared memory.
//
// One kernel serves one query and the batched members (the vmap over a
// query axis of pinot_tpu/ops/kernels.py:get_batched_segment_kernel,
// :1672): up to 8 query vectors of one plan, each row read once for all
// of them. Its scoring step is vec_tree.cuh:score_rows, which K9
// (ivf_probe_select.cu) shares: each lane sums its slice of every (row,
// member) product as its subtree, then one reduce-scatter butterfly over
// the U x M sums (warp_tree_scatter) replaces M x U separate butterflies
// (at 128 dims and 8 members, 31 shuffles for 4 rows where they took
// 160), and every lane ends holding one (row, member) dot. The row's norm
// tree reduces the same way, so the cosine's sqrt and division run once a
// (row, member) and not in every lane, and a member's scores leave as
// runs of U consecutive floats. The kernel is templated on M, the member
// slots: one query launches M = 1 (U sums a lane, 6 shuffles for 4 rows
// at 128 dims), a batch M = 8. Each member's score is the same sequence
// of rounded operations at every M, so a batch's scores are bit for bit
// those of B single launches. The queries sit in shared memory (past 48
// KB at wide dim_pad, under the opt-in limit: 8 x 4096 floats take 128
// KB).

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

// rows in flight per lane group and pass
template <int E>
__host__ __device__ constexpr int rows_unroll() {
  return E <= 4 ? 4 : (E <= 16 ? 2 : 1);
}

// nq <= M query vectors [nq][L * E]: out[b * rows + r] is row r's score
// for query b. The rows' lanes are loaded once, U rows a lane group and
// pass, and score_rows scores them for every query. Rows r0 + u * rpw +
// sub: lanes holding consecutive u of one member store consecutive rows.
template <int L, int E, int M, bool kCos>
__global__ void __launch_bounds__(pinot::kThreads)
    vector_scores_batched_kernel(const float* __restrict__ mat, long long rows,
                                 const float* __restrict__ q, pinot::QNorms q_norms, int nq,
                                 float* __restrict__ out) {
  constexpr int kDim = L * E;
  constexpr int U = rows_unroll<E>();
  constexpr int rpw = 32 / L;            // rows per warp and unrolled step
  extern __shared__ __align__(16) float qs[];
  __shared__ float s_norms[M];
  for (int i = threadIdx.x; i < nq * kDim; i += blockDim.x) qs[i] = q[i];
  if (threadIdx.x < M) {
#pragma unroll
    for (int b = 0; b < M; ++b)
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
    pinot::score_rows<L, E, U, M, kCos>(m, qs, s_norms, nq, li, [&](int b, int u, float s) {
      const long long r = r0 + u * rpw + sub;
      if (r < rows) out[b * rows + r] = s;
    });
  }
}

template <int L, int E, int M, bool kCos>
cudaError_t launch_scores_batched(const float* mat, long long rows, const float* q,
                                  const pinot::QNorms& q_norms, int nq, float* out,
                                  cudaStream_t stream) {
  const auto kernel = vector_scores_batched_kernel<L, E, M, kCos>;
  const size_t smem = static_cast<size_t>(nq) * L * E * sizeof(float);
  // past 48 KB with the static s_norms the launch needs the opt-in (3
  // queries of 4,096 floats are 48 KB of dynamic memory exactly)
  if (smem + M * sizeof(float) > 48 * 1024) {
    const cudaError_t rc = pinot::allow_dynamic_smem(kernel, smem);
    if (rc != cudaSuccess) return rc;
  }
  const long long per_warp = static_cast<long long>(32 / L) * rows_unroll<E>();
  const long long threads = (rows + per_warp - 1) / per_warp * 32;
  kernel<<<pinot::grid_for(kernel, threads, smem), pinot::kThreads, smem, stream>>>(
      mat, rows, q, q_norms, nq, out);
  return cudaGetLastError();
}

// n_q <= 8 queries: one query takes the kernel's M = 1 form, a batch M =
// kMaxMembers (slots past n_q score zeros and store nothing).
int scores(const void* mat, long long rows, int dim_pad, const void* q,
           const pinot::QNorms& norms, int n_q, int cosine, void* out, void* stream) {
  if (rows < 0 || !pinot::pow2(dim_pad) || dim_pad > pinot::kMaxVecDim || n_q < 1 ||
      n_q > pinot::kMaxMembers)
    return -1;
  if (rows == 0) return 0;
  cudaError_t rc = cudaSuccess;
  const float* m = static_cast<const float*>(mat);
  const float* qp = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_SCORES(L, E, C)                                                    \
  (n_q == 1 ? launch_scores_batched<L, E, 1, C>(m, rows, qp, norms, n_q, o, s)   \
            : launch_scores_batched<L, E, pinot::kMaxMembers, C>(m, rows, qp, norms, n_q, o, s))
  PINOT_VEC_DISPATCH_DIM(dim_pad, PINOT_SCORES)
#undef PINOT_SCORES
  return static_cast<int>(rc);
}

}  // namespace

// out f32 [rows]; mat f32 [rows][dim_pad], 16-byte aligned; q f32
// [dim_pad] on the card; dim_pad a power of two <= 4096.
extern "C" int pinot_vector_scores(const void* mat, long long rows, int dim_pad, const void* q,
                                   float q_norm, int cosine, void* out, void* stream) {
  pinot::QNorms norms{};
  norms.v[0] = q_norm;
  return scores(mat, rows, dim_pad, q, norms, 1, cosine, out, stream);
}

// out f32 [n_q][rows]: the scores of n_q <= 8 queries q f32 [n_q][dim_pad]
// (on the card) with host norms q_norms[n_q], each row read once.
extern "C" int pinot_vector_scores_batched(const void* mat, long long rows, int dim_pad,
                                           const void* q, const float* q_norms, int n_q,
                                           int cosine, void* out, void* stream) {
  if (n_q < 1 || n_q > pinot::kMaxMembers) return -1;
  pinot::QNorms norms{};
  for (int b = 0; b < n_q; ++b) norms.v[b] = q_norms[b];
  return scores(mat, rows, dim_pad, q, norms, n_q, cosine, out, stream);
}
