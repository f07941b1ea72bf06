// K8 vector_scores and K9 ivf_probe_select: similarity scores of f32
// embedding rows against one query, and the IVF probe list of each
// segment's codebook.
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
// K9 replaces ivf_select_probes (:140), the probe list of the
// "ivf_probe" filter predicate (_eval_ivf_probe, :161) and
// pinot_tpu/ops/ivf_kernels.py:build_ivf_probe_kernel (:74). One block per
// segment: it scores the segment's C_pad centroids with K8's arithmetic,
// keys them with the monotone int32 map clamped to >= -INT32_MAX (INT32_MIN
// for a centroid whose cvalid is false), and writes the nprobe best by key
// descending, ties to the lower centroid id, as lax.top_k orders them;
// ok[i] = i < the number of live centroids. The ranking is by counting:
// centroid c's rank is the number of centroids ahead of it in that total
// order, so each rank below nprobe is written by exactly one thread. What
// bounds K9: nothing at these sizes (C_pad <= 8192: C_pad^2 compares in
// shared memory); it is one small launch per query.
//
// Batched members (the vmap over a query axis of
// pinot_tpu/ops/kernels.py:get_batched_segment_kernel, :1672): up to 8
// query vectors of one plan. K8 reads each row once for all of them: the
// row's elements stay in registers while each member's dot tree runs over
// them, and under cosine the row's norm tree runs once and is shared; the
// queries sit in shared memory (past 48 KB at wide dim_pad, under the
// opt-in limit: 8 x 4096 floats take 128 KB). Each member's score is the
// same sequence of rounded operations as its own launch's, so the scores
// are bit for bit those of B single launches. K9's grid gains a member
// axis: block (s, b) ranks codebook s for query b.

#include <limits.h>

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

constexpr int kMaxCentroids = 8192;   // K9: keys in 32 KB of shared memory
constexpr int kMaxMembers = 8;

// the members' query norms, passed by value
struct QNorms {
  float v[kMaxMembers];
};

// rows in flight per lane group and pass
template <int E>
__host__ __device__ constexpr int rows_unroll() {
  return E <= 4 ? 4 : (E <= 16 ? 2 : 1);
}

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
      load_lane<E>(mat, r < rows ? r : -1, dim_pad, li, m[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float s = row_score<E, kCos>(m[u], qv, L, q_norm);
      const long long r = r0 + u * rpw + sub;
      if (li == 0 && r < rows) out[r] = s;
    }
  }
}

// nq query vectors [nq][dim_pad]: out[b * rows + r] is row r's score for
// query b. The rows' lanes are loaded once and their norm trees run once;
// then, query by query, the lane's slice of the query is read from
// shared memory once (16-byte loads; into registers up to 16 elements a
// lane) and scores the U rows in flight.
template <int E, bool kCos>
__global__ void __launch_bounds__(pinot::kThreads)
    vector_scores_batched_kernel(const float* __restrict__ mat, long long rows, int dim_pad,
                                 const float* __restrict__ q, QNorms q_norms, int nq,
                                 float* __restrict__ out) {
  extern __shared__ __align__(16) float qs[];
  __shared__ float s_norms[kMaxMembers];
  for (int i = threadIdx.x; i < nq * dim_pad; i += blockDim.x) qs[i] = q[i];
  if (threadIdx.x < kMaxMembers) {
#pragma unroll
    for (int b = 0; b < kMaxMembers; ++b)
      if (threadIdx.x == b) s_norms[b] = q_norms.v[b];
  }
  __syncthreads();
  constexpr int U = rows_unroll<E>();
  constexpr bool kRegQ = E <= 16;       // the query slice in registers
  const int L = dim_pad / E;
  const int rpw = 32 / L;
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r0 = warp * rpw * U; r0 < rows; r0 += n_warps * rpw * U) {
    float m[U][E];
    float norm2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * rpw + sub;
      load_lane<E>(mat, r < rows ? r : -1, dim_pad, li, m[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      norm2[u] = 0.f;
      if constexpr (kCos) {
        norm2[u] = pinot::lane_tree<E>([&](int i) { return __fmul_rn(m[u][i], m[u][i]); });
        norm2[u] = pinot::warp_tree(norm2[u], L);
      }
    }
    // nq is uniform, so every lane reaches every shuffle
    for (int b = 0; b < nq; ++b) {
      const float* qv = qs + b * dim_pad + li * E;
      float qr[kRegQ ? E : 1];
      if constexpr (kRegQ) load_lane<E>(qv, 0, 0, 0, qr);
      const float q_norm = s_norms[b];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long r = r0 + u * rpw + sub;
        float dot = pinot::lane_tree<E>([&](int i) {
          if constexpr (kRegQ) return __fmul_rn(m[u][i], qr[i]);
          else return __fmul_rn(m[u][i], qv[i]);
        });
        dot = pinot::warp_tree(dot, L);
        const float s = pinot::vec_score(dot, norm2[u], q_norm, kCos);
        if (li == 0 && r < rows) out[b * rows + r] = s;
      }
    }
  }
}

template <int E, bool kCos>
__global__ void __launch_bounds__(pinot::kThreads)
    probe_select_kernel(const float* __restrict__ cent, const uint8_t* __restrict__ cvalid,
                        int c_pad, int dim_pad, const float* __restrict__ q, QNorms q_norms,
                        int nprobe, int* __restrict__ ids, uint8_t* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  int* keys = reinterpret_cast<int*>(qs + dim_pad);
  __shared__ int scratch[32];
  __shared__ int n_valid;
  const long long s = blockIdx.x;
  const float* mat = cent + s * c_pad * dim_pad;
  const uint8_t* valid = cvalid + s * c_pad;
  // member blockIdx.y: its query, its norm, its rows of the outputs
  const float q_norm = q_norms.v[blockIdx.y];
  q += static_cast<long long>(blockIdx.y) * dim_pad;
  ids += static_cast<long long>(blockIdx.y) * gridDim.x * nprobe;
  ok += static_cast<long long>(blockIdx.y) * gridDim.x * nprobe;
  for (int i = threadIdx.x; i < dim_pad; i += blockDim.x) qs[i] = q[i];
  __syncthreads();
  const int L = dim_pad / E, rpw = 32 / L;
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const float* qv = qs + li * E;
  for (int r0 = warp * rpw; r0 < c_pad; r0 += n_warps * rpw) {
    const int r = r0 + sub;
    float m[E];
    load_lane<E>(mat, r < c_pad ? r : -1, dim_pad, li, m);
    const float score = row_score<E, kCos>(m, qv, L, q_norm);
    if (li == 0 && r < c_pad) keys[r] = valid[r] ? pinot::score_key(score) : INT_MIN;
  }
  int v = 0;
  for (int c = threadIdx.x; c < c_pad; c += blockDim.x) v += valid[c] != 0;
  v = pinot::block_sum(v, scratch);
  if (threadIdx.x == 0) n_valid = v;
  __syncthreads();
  for (int c = threadIdx.x; c < c_pad; c += blockDim.x) {
    const int kc = keys[c];
    int rank = 0;
    for (int d = 0; d < c_pad; ++d) {
      const int kd = keys[d];
      rank += (kd > kc) || (kd == kc && d < c);
    }
    if (rank < nprobe) ids[s * nprobe + rank] = c;
  }
  for (int i = threadIdx.x; i < nprobe; i += blockDim.x)
    ok[s * nprobe + i] = i < n_valid ? 1 : 0;
}

// E = dim_pad / min(32, dim_pad) elements per lane
int lane_elems(int dim_pad) { return dim_pad <= 32 ? 1 : dim_pad / 32; }

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

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

template <int E, bool kCos>
cudaError_t launch_scores_batched(const float* mat, long long rows, int dim_pad, const float* q,
                                  const QNorms& q_norms, int nq, float* out,
                                  cudaStream_t stream) {
  const auto kernel = vector_scores_batched_kernel<E, kCos>;
  const size_t smem = static_cast<size_t>(nq) * dim_pad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const int L = dim_pad / E;
  const long long per_warp = static_cast<long long>(32 / L) * rows_unroll<E>();
  const long long threads = (rows + per_warp - 1) / per_warp * 32;
  kernel<<<pinot::grid_for(kernel, threads, smem), pinot::kThreads, smem, stream>>>(
      mat, rows, dim_pad, q, q_norms, nq, out);
  return cudaGetLastError();
}

template <int E, bool kCos>
cudaError_t launch_probes(const float* cent, const uint8_t* cvalid, int n_segs, int c_pad,
                          int dim_pad, const float* q, const QNorms& q_norms, int nq,
                          int nprobe, int* ids, uint8_t* ok, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(dim_pad + c_pad) * sizeof(float);
  const auto kernel = probe_select_kernel<E, kCos>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<dim3(n_segs, nq), pinot::kThreads, smem, stream>>>(cent, cvalid, c_pad, dim_pad, q,
                                                              q_norms, nprobe, ids, ok);
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
  if (rows < 0 || !pow2(dim_pad) || dim_pad > pinot::kMaxVecDim) return -1;
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
  if (rows < 0 || !pow2(dim_pad) || dim_pad > pinot::kMaxVecDim || n_q < 1 ||
      n_q > kMaxMembers)
    return -1;
  if (rows == 0) return 0;
  QNorms norms{};
  for (int b = 0; b < n_q; ++b) norms.v[b] = q_norms[b];
  cudaError_t rc = cudaSuccess;
  const float* m = static_cast<const float*>(mat);
  const float* qp = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_SCORES(E, C) launch_scores_batched<E, C>(m, rows, dim_pad, qp, norms, n_q, o, s)
  PINOT_VEC_DISPATCH(lane_elems(dim_pad), PINOT_SCORES)
#undef PINOT_SCORES
  return static_cast<int>(rc);
}

namespace {

int probes(const void* cent, const void* cvalid, int n_segs, int c_pad, int dim_pad,
           const void* q, const QNorms& norms, int n_q, int cosine, int nprobe, void* ids,
           void* ok, void* stream) {
  if (n_segs < 1 || n_segs > 65535 || !pow2(dim_pad) || dim_pad > pinot::kMaxVecDim ||
      c_pad < 1 || c_pad > kMaxCentroids || nprobe < 1 || nprobe > c_pad || n_q < 1 ||
      n_q > kMaxMembers)
    return -1;
  cudaError_t rc = cudaSuccess;
  const float* c = static_cast<const float*>(cent);
  const uint8_t* v = static_cast<const uint8_t*>(cvalid);
  const float* qp = static_cast<const float*>(q);
  int* out_ids = static_cast<int*>(ids);
  uint8_t* out_ok = static_cast<uint8_t*>(ok);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PINOT_PROBES(E, C) \
  launch_probes<E, C>(c, v, n_segs, c_pad, dim_pad, qp, norms, n_q, nprobe, out_ids, out_ok, s)
  PINOT_VEC_DISPATCH(lane_elems(dim_pad), PINOT_PROBES)
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
  QNorms norms{};
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
  if (n_q < 1 || n_q > kMaxMembers) return -1;
  QNorms norms{};
  for (int b = 0; b < n_q; ++b) norms.v[b] = q_norms[b];
  return probes(cent, cvalid, n_segs, c_pad, dim_pad, q, norms, n_q, cosine, nprobe, ids, ok,
                stream);
}
