// K10 ivf_assign: the nearest live centroid of every row, and the squared
// L2 distance to it.
//
// Replaces pinot_tpu/ops/ivf_kernels.py:build_ivf_assign_kernel (:26), the
// assign half of the Lloyd step (build_ivf_train_kernel, :51) and the
// seal-time sweep of pinot_tpu/index/ivf.py:_assign_all (:244):
//   d2[r][c] = (row_n2[r] - 2 * cross[r][c]) + cen_n2[c]   (c < n_centroids)
//   assign[r] = argmin_c d2[r][c], ties to the lower id;
//   dist[r]   = max(min_c d2[r][c], 0) for r < n_rows, 0 for padding rows.
// row_n2 and cen_n2 are the balanced-tree norms (vec_tree.cuh, the same
// bits as the JAX vec_tree_sum of x * x); cross is this kernel's own dot
// product, f32 with FMAs in its own order. The JAX kernel leaves cross to
// an XLA matmul whose order is its own too, so distances agree to rounding
// and assignments agree wherever the best two distances differ by more
// than that rounding; training has no cross-backend bit contract (the
// JAX module's docstring says so), only a per-backend one: the same inputs
// give the same bits on every run, since nothing here depends on the order
// blocks run in.
//
// What bounds it: operations. n * C_pad * dim_pad * 2 f32 FLOPs (2.5M rows
// x 256 centroids x 128 dims = 164 GFLOP) against n * dim_pad * 4 bytes
// read: about 128 FLOPs a byte, above the card's f32 ridge. What the design
// does about it: a register-tiled product, the classic SGEMM shape without
// tensor cores (f32 in, f32 accumulate): a block takes 64 rows and walks
// the codebook 64 centroids at a time, staging 64 x 16 tiles of rows and
// centroids in shared memory; each of its 256 threads accumulates a 4 x 4
// patch in registers and keeps, per row, the best (distance, id) of the
// centroids it saw; 16 threads share a row and settle it with shuffles.
// The distance matrix is never written. Launch 1 computes the tree norms
// (one warp per row, as K8 does), launch 2 the product and argmin.

#include <math.h>

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

constexpr int kBM = 64;   // rows per block
constexpr int kBN = 64;   // centroids per tile
constexpr int kBK = 16;   // dims per stage

template <int E>
__global__ void __launch_bounds__(pinot::kThreads)
    tree_norms_kernel(const float* __restrict__ mat, long long rows, int dim_pad,
                      float* __restrict__ out) {
  const int L = dim_pad / E, rpw = 32 / L;
  const int lane = threadIdx.x & 31, sub = lane / L, li = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r0 = warp * rpw; r0 < rows; r0 += n_warps * rpw) {
    const long long r = r0 + sub;
    const float* p = mat + (r < rows ? r : 0) * dim_pad + static_cast<long long>(li) * E;
    float v = pinot::lane_tree<E>([&](int i) {
      const float x = r < rows ? p[i] : 0.f;
      return __fmul_rn(x, x);
    });
    v = pinot::warp_tree(v, L);
    if (li == 0 && r < rows) out[r] = v;
  }
}

__global__ void __launch_bounds__(pinot::kThreads)
    assign_kernel(const float* __restrict__ data, long long n, int dim_pad,
                  const float* __restrict__ cent, int c_pad, int n_centroids,
                  long long n_rows, const float* __restrict__ row_n2,
                  const float* __restrict__ cen_n2, int* __restrict__ assign,
                  float* __restrict__ dist) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  float rn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty * 4 + i;
    rn[i] = r < n ? row_n2[r] : 0.f;
  }
  float best_d[4];
  int best_c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_d[i] = INFINITY;
    best_c[i] = 0;
  }
  for (int c0 = 0; c0 < c_pad; c0 += kBN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < dim_pad; k0 += kBK) {
      // each thread stages 4 elements of each tile (rows and dims
      // consecutive across threads), zeros past the edges
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid * 4 + e, rr = idx / kBK, kk = idx % kBK;
        const long long r = row0 + rr;
        const int k = k0 + kk, c = c0 + rr;
        As[kk][rr] = (r < n && k < dim_pad) ? data[r * dim_pad + k] : 0.f;
        Bs[kk][rr] = (c < c_pad && k < dim_pad) ? cent[static_cast<long long>(c) * dim_pad + k]
                                                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c >= n_centroids || c >= c_pad) continue;
      const float cn = cen_n2[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = __fadd_rn(__fsub_rn(rn[i], __fmul_rn(2.f, acc[i][j])), cn);
        if (d < best_d[i]) {     // c ascends: a tie keeps the lower id
          best_d[i] = d;
          best_c[i] = c;
        }
      }
    }
  }
  // the 16 threads of a row (lanes of one half-warp) settle it: the
  // smaller distance, then the lower id
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float d = best_d[i];
    int c = best_c[i];
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, o);
      const int oc = __shfl_xor_sync(0xffffffffu, c, o);
      if (od < d || (od == d && oc < c)) {
        d = od;
        c = oc;
      }
    }
    const long long r = row0 + ty * 4 + i;
    if (tx == 0 && r < n) {
      assign[r] = c;
      dist[r] = r < n_rows ? fmaxf(d, 0.f) : 0.f;
    }
  }
}

template <int E>
cudaError_t launch_norms(const float* mat, long long rows, int dim_pad, float* out,
                         cudaStream_t s) {
  if (rows == 0) return cudaSuccess;
  const auto kernel = tree_norms_kernel<E>;
  const long long threads = (rows + 32 / (dim_pad / E) - 1) / (32 / (dim_pad / E)) * 32;
  kernel<<<pinot::grid_for(kernel, threads, 0), pinot::kThreads, 0, s>>>(mat, rows, dim_pad, out);
  return cudaGetLastError();
}

cudaError_t norms(const float* mat, long long rows, int dim_pad, float* out, cudaStream_t s) {
  switch (dim_pad <= 32 ? 1 : dim_pad / 32) {
    case 1: return launch_norms<1>(mat, rows, dim_pad, out, s);
    case 2: return launch_norms<2>(mat, rows, dim_pad, out, s);
    case 4: return launch_norms<4>(mat, rows, dim_pad, out, s);
    case 8: return launch_norms<8>(mat, rows, dim_pad, out, s);
    case 16: return launch_norms<16>(mat, rows, dim_pad, out, s);
    case 32: return launch_norms<32>(mat, rows, dim_pad, out, s);
    case 64: return launch_norms<64>(mat, rows, dim_pad, out, s);
    default: return launch_norms<128>(mat, rows, dim_pad, out, s);
  }
}

}  // namespace

// data f32 [n][dim_pad], cent f32 [c_pad][dim_pad]; assign int32 [n], dist
// f32 [n]; scratch f32 [n + c_pad] (the tree norms).
extern "C" int pinot_ivf_assign(const void* data, long long n, int dim_pad, const void* cent,
                                int c_pad, int n_centroids, long long n_rows, void* scratch,
                                void* assign, void* dist, void* stream) {
  if (n < 0 || dim_pad < 1 || (dim_pad & (dim_pad - 1)) || dim_pad > pinot::kMaxVecDim ||
      c_pad < 1 || n_centroids < 0 || n_centroids > c_pad || n_rows < 0 || n_rows > n)
    return -1;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(data);
  const float* c = static_cast<const float*>(cent);
  float* row_n2 = static_cast<float*>(scratch);
  float* cen_n2 = row_n2 + n;
  cudaError_t rc = norms(d, n, dim_pad, row_n2, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = norms(c, c_pad, dim_pad, cen_n2, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long blocks = (n + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return -1;
  assign_kernel<<<static_cast<unsigned>(blocks), pinot::kThreads, 0, s>>>(
      d, n, dim_pad, c, c_pad, n_centroids, n_rows, row_n2, cen_n2, static_cast<int*>(assign),
      static_cast<float*>(dist));
  return static_cast<int>(cudaGetLastError());
}
