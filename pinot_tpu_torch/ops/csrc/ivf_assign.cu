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
// read: about 128 FLOPs a byte, far above the card's ridge, so only the
// tensor cores move it. Two routes, picked on the host by shape
// (ops/ivf_kernels.py:ivf_assign_route); launch 1 computes the tree norms
// (one warp per row, as K8 does) on both, launch 2 the product and argmin,
// and neither writes the distance matrix:
// - tensor (assign_tc_kernel), dim_pad >= 8: cross on the tensor cores in
//   3xTF32. Each f32 operand x splits into hi = tf32(x) and
//   lo = tf32(x - hi) (cvt.rna), and cross sums lo*hi + hi*lo + hi*hi:
//   TF32 products are exact in f32, the dropped lo*lo is 2^-22 of a
//   product, so the sum keeps f32's accuracy where one TF32 pass keeps
//   about three digits (tests/test_torch_ivf.py emulates both against
//   chip_smoke's check). The tensor core adds with truncation, so each
//   k-step's three products start from zero, smallest first, and the step
//   is added into the f32 accumulator with a rounded FADD: the truncation
//   then stays at a k-step's magnitude, not the whole dot's. A block of
//   128 threads takes 64 rows and walks the codebook 128 centroids at a
//   time in chunks of 32 dims, rows and centroids staged by 16-byte
//   cp.async copies, the next chunk while this one runs (54 KB, zeros
//   past the ragged edges), two blocks an SM; 4 warps of 32 rows x 64 centroids each run
//   mma.sync m16n8k8 (2 x 8 tiles, 64 f32 accumulators a thread), split
//   both operands in registers as they load them, and issue a k-step's 16
//   tiles pass by pass so that 16 products are in flight. Per centroid
//   tile the epilogue forms d2 and keeps each row's best two (distance,
//   id) and the third's distance with selects (ascending ids, so a tie
//   keeps the lower one), merged across a quad by shuffles and across the
//   two column warps in shared memory.
//   The f32 plain version (cuBLAS on the card, the same bits as the simt
//   route here) sums each dot in sequential FMAs, which at the vecbench
//   scale (|x|^2 ~ 2,048, d2 ~ 11) is itself noisier against the exact
//   dot than 3xTF32 (tests/test_torch_ivf.py emulates both): the two
//   orders part by more than chip_smoke's tolerance in d2, and pick other
//   centroids for near ties. So
//   each row is settled in the simt route's arithmetic (settle_margin
//   below): the best candidate's d2 again as a sequential FMA dot, from
//   L2 (the rows prefetched during the last chunk), and the second's
//   where it lies within a margin of the best, twice the two orders'
//   rounding bound (0.085 at vecbench's scale), the better of the two
//   kept; where a third does too, every live centroid. Those rows are
//   listed and the block scans them together, 16 rows a pass, with the
//   simt route's register tiling (4 rows x 8 centroids a thread, rows
//   and centroids staged in shared memory): a warp scanning each row
//   alone read the whole codebook from L2 for every row and took 108 ms
//   where every row had three equal candidates, 14x the simt route
//   (PERF.md; chip_smoke.py times such codebooks). The route's outputs
//   are the simt route's, bit for bit, and its products run on the
//   tensor cores.
//   mma.sync and not wgmma: wgmma's shared-memory descriptors and
//   swizzled layouts are a second kernel's worth of work that no compiler
//   here can check, where mma.sync's register fragments are plain; it
//   gives up Hopper's asynchronous warpgroup issue, which is left to win;
// - simt (assign_kernel), any dim_pad (the only one below 8: pad_dim
//   allows 1, 2 and 4): a register-tiled f32 product on the CUDA cores,
//   the classic SGEMM shape: a block takes 64 rows and walks the codebook
//   64 centroids at a time, staging 64 x 16 tiles in shared memory; each
//   of its 256 threads accumulates a 4 x 4 patch and keeps, per row, the
//   best (distance, id) of the centroids it saw; 16 threads share a row
//   and settle it with shuffles. It ran at 30% of the CUDA cores' rate.
// Both give the same bits run after run (no atomics, fixed orders).

#include <math.h>
#include <stdint.h>

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


// -- the tensor route ---------------------------------------------------------

constexpr int kTThreads = 128;         // 4 warps: 2 of rows x 2 of centroids
constexpr int kTM = 64;                // rows a block
constexpr int kTN = 128;               // centroids a tile
constexpr int kTK = 32;                // dims a staged chunk, at most
constexpr int kTStride = kTK + 4;      // floats a staged row: conflict-free reads
constexpr int kTStage = (kTM + kTN) * kTStride;   // floats a stage
constexpr int kTStages = 2;            // chunks in flight: this one, one ahead
constexpr int kTSmemBytes = kTStages * kTStage * static_cast<int>(sizeof(float));
constexpr int kScanRows = 16;          // the block's scan: rows a pass,
constexpr int kScanCols = 256;         // centroids a tile,
constexpr int kScanDims = 8;           // dims a step (dim_pad >= 8)
constexpr int kScanStride = kScanCols + 4;   // floats a staged dim of the tile
static_assert(kScanRows * kScanDims == kTThreads && kScanRows == 4 * (kTThreads / 32) &&
                  kScanCols == 8 * 32 && (kScanDims * kScanRows + kScanDims * kScanStride) * 4 <= kTSmemBytes,
              "the scan's tiling");

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ under 2^-22 x): hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b on one m16n8k8 tile (a row-major 16 x 8, b col-major 8 x 8)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b (+ zero) on one tile
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const unsigned (&a)[4],
                                              const unsigned (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// the smaller distance, then the lower id
__device__ __forceinline__ bool better(float d, int c, float bd, int bc) {
  return d < bd || (d == bd && c < bc);
}

// A row's best two candidates by the ranking distance, (d1, c1) and
// (d2, c2), and the third's distance d3, kept with selects (no branch).
struct Best3 {
  float d1, d2, d3;
  int c1, c2;
};

// a candidate of an id above every one seen: a strict compare keeps the
// lower id of a tie
__device__ __forceinline__ void push(Best3& t, float d, int c) {
  const bool lt1 = d < t.d1, lt2 = d < t.d2;
  t.d3 = lt2 ? t.d2 : fminf(t.d3, d);
  t.d2 = lt1 ? t.d1 : (lt2 ? d : t.d2);
  t.c2 = lt1 ? t.c1 : (lt2 ? c : t.c2);
  t.d1 = lt1 ? d : t.d1;
  t.c1 = lt1 ? c : t.c1;
}

// a candidate of any id: ties go to the lower id
__device__ __forceinline__ void push_any(Best3& t, float d, int c) {
  const bool lt1 = better(d, c, t.d1, t.c1), lt2 = better(d, c, t.d2, t.c2);
  t.d3 = lt2 ? t.d2 : fminf(t.d3, d);
  t.d2 = lt1 ? t.d1 : (lt2 ? d : t.d2);
  t.c2 = lt1 ? t.c1 : (lt2 ? c : t.c2);
  t.d1 = lt1 ? d : t.d1;
  t.c1 = lt1 ? c : t.c1;
}

__device__ __forceinline__ void merge(Best3& t, const Best3& u) {
  push_any(t, u.d1, u.c1);
  push_any(t, u.d2, u.c2);
  t.d3 = fminf(t.d3, u.d3);
}

// t and lane (this ^ o)'s, merged
__device__ __forceinline__ void merge_xor(Best3& t, int o) {
  const Best3 u{__shfl_xor_sync(0xffffffffu, t.d1, o), __shfl_xor_sync(0xffffffffu, t.d2, o),
                __shfl_xor_sync(0xffffffffu, t.d3, o), __shfl_xor_sync(0xffffffffu, t.c1, o),
                __shfl_xor_sync(0xffffffffu, t.c2, o)};
  merge(t, u);
}

// d2 of row x against centroid c in the simt route's arithmetic: a dot of
// sequential FMAs, dims ascending, then (|x|^2 - 2 dot) + |c|^2
__device__ __forceinline__ float fma_d2(const float* x, const float* c, int dim_pad, float xn,
                                        float cn) {
  const float4* xr = reinterpret_cast<const float4*>(x);
  const float4* cr = reinterpret_cast<const float4*>(c);
  float dot = 0.f;
#pragma unroll 8
  for (int q = 0; q < dim_pad / 4; ++q) {
    const float4 a = xr[q], b = cr[q];
    dot = fmaf(a.x, b.x, dot);
    dot = fmaf(a.y, b.y, dot);
    dot = fmaf(a.z, b.z, dot);
    dot = fmaf(a.w, b.w, dot);
  }
  return __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, dot)), cn);
}

// A candidate c's ranking distance (3xTF32) and its simt one each lie
// within (dim_pad x 2^-24 + 2^-19) x S_c of the exact d2, where
// S_c = sum |x_k c_k| <= |x| |c| (the sequential dot's rounding bound, and
// the split's and the adds'). A rival within the margin m of the best has
// |c| <= |x| + sqrt(d1 + 1.5 m), so with m0 the margin at |c| <= |x| +
// sqrt(d1), S_c <= |x| (|x| + sqrt(max(d1, 0) + 2 m0)); the margin is
// twice the pair's bound, 4 (dim_pad x 2^-24 + 2^-19) S, plus 2^-20 of
// |x|^2 + d1 for the rounding of d2's own two adds, which the two orders
// meet at different points. Rows with a rival inside it are settled by a
// scan of every live centroid in the simt arithmetic.
__device__ __forceinline__ float settle_margin(float xn, float d1, int dim_pad) {
  const float k = 4.f * (static_cast<float>(dim_pad) * (1.0f / (1 << 24)) + 1.0f / (1 << 19));
  const float x = sqrtf(xn), d = fmaxf(d1, 0.f);
  const float m0 = k * x * (x + sqrtf(d));
  return k * x * (x + sqrtf(d + 2.f * m0)) + (xn + d) * (1.0f / (1 << 20));
}

// warp w: rows wm * 32 .. + 32 of the block (wm = w % 2), centroids
// wn * 64 .. + 64 of each tile (wn = w / 2); lane l: g = l / 4, t = l % 4,
// the m16n8k8 fragments' row group and column pair. Two blocks an SM (the
// registers allow two of 128 threads), so one block's staging waits and
// its settling pass run beside the other's products.
__global__ void __launch_bounds__(kTThreads, 2)
    assign_tc_kernel(const float* __restrict__ data, long long n, int dim_pad,
                     const float* __restrict__ cent, int c_pad, int n_centroids,
                     long long n_rows, const float* __restrict__ row_n2,
                     const float* __restrict__ cen_n2, int* __restrict__ assign,
                     float* __restrict__ dist, int* __restrict__ stats) {
  extern __shared__ __align__(16) float tsm[];
  __shared__ Best3 s_best[2][kTM];
  __shared__ unsigned s_listed[2];                 // warps 0 and 1: rows to scan
  __shared__ int s_rows[kTM];                      // the rows to scan, in order
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;
  const int kc = min(kTK, dim_pad);            // dims a chunk (dim_pad >= 8)
  const int n_k = dim_pad / kc, per_row = kc / 4;
  const int steps = ((c_pad + kTN - 1) / kTN) * n_k;

  // chunk s (centroid tile s / n_k, dims (s % n_k) * kc ..) into stage
  // s % kTStages, as one commit group (empty past the last chunk)
  auto stage = [&](int s) {
    if (s < steps) {
      float* a = tsm + (s % kTStages) * kTStage;
      float* b = a + kTM * kTStride;
      const int c0 = (s / n_k) * kTN, k0 = (s % n_k) * kc;
      for (int i = tid; i < kTM * per_row; i += kTThreads) {
        const int r = i / per_row, q = 4 * (i % per_row);
        const long long gr = row0 + r;
        pinot::cp_async16(a + r * kTStride + q, data + (gr < n ? gr : 0) * dim_pad + k0 + q,
                           gr < n);
      }
      for (int i = tid; i < kTN * per_row; i += kTThreads) {
        const int r = i / per_row, q = 4 * (i % per_row), c = c0 + r;
        pinot::cp_async16(b + r * kTStride + q,
                           cent + static_cast<long long>(c < c_pad ? c : 0) * dim_pad + k0 + q,
                           c < c_pad);
      }
    }
    pinot::cp_async_commit();
  };

  float rn[4];                  // this thread's rows: (mt, h) at 2 mt + h
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + g;
    rn[i] = r < n ? row_n2[r] : 0.f;
  }
  Best3 top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i] = Best3{INFINITY, INFINITY, INFINITY, 0, 0};
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kTStages - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    pinot::cp_async_wait<kTStages - 2>();   // chunk s has landed, this thread's
    __syncthreads();                  // ... and every thread's; stage (s - 1)
    stage(s + kTStages - 1);          // is free for chunk s + kTStages - 1
    if (s == steps - 1) {
      // the block's rows back into L2 for the settling pass below: 128-byte
      // lines, 4 a row at 128 dims, read again only at the block's end
      const int lines = dim_pad / 32 > 0 ? dim_pad / 32 : 1;
      for (int i = tid; i < kTM * lines; i += kTThreads) {
        const long long r = row0 + i / lines;
        if (r < n)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(data + r * dim_pad + (i % lines) * 32));
      }
    }
    const float* a = tsm + (s % kTStages) * kTStage;
    const float* b = a + kTM * kTStride;
    for (int kk = 0; kk < kc; kk += 8) {
      unsigned ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = a + (wm * 32 + mt * 16 + g) * kTStride + kk + t;
        split_tf32(ar[0], ah[mt][0], al[mt][0]);
        split_tf32(ar[8 * kTStride], ah[mt][1], al[mt][1]);
        split_tf32(ar[4], ah[mt][2], al[mt][2]);
        split_tf32(ar[8 * kTStride + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* br = b + (wn * 64 + nt * 8 + g) * kTStride + kk + t;
        split_tf32(br[0], bh[nt][0], bl[nt][0]);
        split_tf32(br[4], bh[nt][1], bl[nt][1]);
      }
      // the k-step's 16 tiles from zero, one pass over all of them at a
      // time (16 independent products in flight), smallest terms first
      float part[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32_zero(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_tf32(part[mt][nt], ah[mt], bh[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);
    }
    if (s % n_k == n_k - 1) {   // the tile's last chunk: its distances
      const int c0 = (s / n_k) * kTN + wn * 64 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = c0 + nt * 8 + j;       // ascending: a tie keeps the lower id
          if (c >= n_centroids) continue;
          const float cn = cen_n2[c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x2 = __fmul_rn(2.f, acc[i >> 1][nt][(i & 1) * 2 + j]);
            push(top[i], __fadd_rn(__fsub_rn(rn[i], x2), cn), c);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  pinot::cp_async_wait<0>();
  // a row's four threads (one quad), then its two column warps
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    merge_xor(top[i], 1);
    merge_xor(top[i], 2);
    if (t == 0) s_best[wn][wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + g] = top[i];
  }
  __syncthreads();
  // warps 0 and 1, a row a thread: settled in the simt route's
  // arithmetic, so that the assignment and its distance are the simt
  // route's bit for bit: the best, and the second where it lies within
  // the margin, as sequential FMA dots; a row where a third does too is
  // listed for the block's scan below
  const long long r = row0 + tid;
  bool scan = false;
  if (tid < kTM) {
    Best3 m = s_best[0][tid];
    merge(m, s_best[1][tid]);
    float d = m.d1;
    int c = m.c1;
    const bool settle = r < n && n_centroids > 0;
    const float xn = settle ? row_n2[r] : 0.f;
    const float bound = settle ? m.d1 + settle_margin(xn, m.d1, dim_pad) : 0.f;
    scan = settle && m.d3 <= bound;
    const unsigned listed = __ballot_sync(0xffffffffu, scan);
    if (stats != nullptr) {     // the rows settled by two dots, and by the scan
      const unsigned two = __ballot_sync(0xffffffffu, settle && !scan && m.d2 <= bound);
      if (lane == 0 && two != 0) atomicAdd(stats, __popc(two));
      if (lane == 0 && listed != 0) atomicAdd(stats + 1, __popc(listed));
    }
    if (lane == 0) s_listed[warp] = listed;
    if (settle && !scan) {
      const float* x = data + r * dim_pad;
      d = fma_d2(x, cent + static_cast<long long>(c) * dim_pad, dim_pad, xn, cen_n2[c]);
      if (m.d2 <= bound) {
        const float d2 =
            fma_d2(x, cent + static_cast<long long>(m.c2) * dim_pad, dim_pad, xn, cen_n2[m.c2]);
        if (better(d2, m.c2, d, c)) {
          d = d2;
          c = m.c2;
        }
      }
    }
    if (r < n && !scan) {
      assign[r] = c;
      dist[r] = r < n_rows ? fmaxf(d, 0.f) : 0.f;
    }
  }
  __syncthreads();
  const unsigned lo = s_listed[0], hi = s_listed[1];
  const int n_scan = __popc(lo) + __popc(hi);
  if (n_scan == 0) return;      // block-uniform
  if (scan) {
    const unsigned below = (1u << lane) - 1u;
    s_rows[(warp ? __popc(lo) : 0) + __popc((warp ? hi : lo) & below)] = tid;
  }
  __syncthreads();
  // The listed rows against every live centroid in the simt arithmetic,
  // kScanRows rows a pass: the simt route's register tiling on the
  // staging area, kScanDims dims of the rows and of kScanCols centroids a
  // step; warp w takes rows 4 w .. 4 w + 3 of the pass and lane l
  // centroids 4 l .. 4 l + 3 and 128 + 4 l .. 128 + 4 l + 3 of each
  // tile, each a sequential FMA dot, dims ascending; then the warp's
  // lanes merge each row's best, ties to the lower id.
  float* const xs = tsm;                               // [kScanDims][kScanRows]
  float* const cs = tsm + kScanDims * kScanRows;       // [kScanDims][kScanStride]
  for (int base = 0; base < n_scan; base += kScanRows) {
    const int j_load = tid / kScanDims, k_load = tid % kScanDims;
    const long long r_load = row0 + s_rows[base + j_load < n_scan ? base + j_load : base];
    float xn[4], bd[4];
    int bc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = base + warp * 4 + i;
      xn[i] = row_n2[row0 + s_rows[idx < n_scan ? idx : base]];
      bd[i] = INFINITY;
      bc[i] = 0;
    }
    for (int c0 = 0; c0 < n_centroids; c0 += kScanCols) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
      for (int k0 = 0; k0 < dim_pad; k0 += kScanDims) {
        __syncthreads();                 // the step before is read
        xs[k_load * kScanRows + j_load] = data[r_load * dim_pad + k0 + k_load];
#pragma unroll
        for (int m = 0; m < kScanCols * kScanDims / 4 / kTThreads; ++m) {
          const int i = tid + m * kTThreads, cl = i >> 1, kq = (i & 1) * 4, c = c0 + cl;
          const float4 v = c < c_pad ? *reinterpret_cast<const float4*>(
                                           cent + static_cast<long long>(c) * dim_pad + k0 + kq)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          cs[(kq + 0) * kScanStride + cl] = v.x;
          cs[(kq + 1) * kScanStride + cl] = v.y;
          cs[(kq + 2) * kScanStride + cl] = v.z;
          cs[(kq + 3) * kScanStride + cl] = v.w;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kScanDims; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(xs + kk * kScanRows + warp * 4);
          const float4 b0 = *reinterpret_cast<const float4*>(cs + kk * kScanStride + lane * 4);
          const float4 b1 =
              *reinterpret_cast<const float4*>(cs + kk * kScanStride + 128 + lane * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {   // ascending: a tie keeps the lower id
        const int c = c0 + (jj < 4 ? lane * 4 + jj : 128 + lane * 4 + jj - 4);
        if (c >= n_centroids) continue;
        const float cn = cen_n2[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dd = __fadd_rn(__fsub_rn(xn[i], __fmul_rn(2.f, acc[i][jj])), cn);
          if (dd < bd[i]) {
            bd[i] = dd;
            bc[i] = c;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int o = 16; o > 0; o >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd[i], o);
        const int oc = __shfl_xor_sync(0xffffffffu, bc[i], o);
        if (better(od, oc, bd[i], bc[i])) {
          bd[i] = od;
          bc[i] = oc;
        }
      }
      const int idx = base + warp * 4 + i;
      if (lane == 0 && idx < n_scan) {
        const long long rr = row0 + s_rows[idx];
        assign[rr] = bc[i];
        dist[rr] = rr < n_rows ? fmaxf(bd[i], 0.f) : 0.f;
      }
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
// f32 [n]; scratch f32 [n + c_pad] (the tree norms). tensor: 1 takes the
// tensor route (dim_pad >= 8, data and cent 16-byte aligned), 0 the simt
// route. stats, null or int32 [2] on the card: the tensor route adds the
// rows it settled with a second candidate's dot and the rows it settled by
// a scan of every centroid (the simt route adds nothing).
extern "C" int pinot_ivf_assign(const void* data, long long n, int dim_pad, const void* cent,
                                int c_pad, int n_centroids, long long n_rows, void* scratch,
                                void* assign, void* dist, int tensor, void* stats,
                                void* stream) {
  if (n < 0 || dim_pad < 1 || (dim_pad & (dim_pad - 1)) || dim_pad > pinot::kMaxVecDim ||
      c_pad < 1 || n_centroids < 0 || n_centroids > c_pad || n_rows < 0 || n_rows > n)
    return -1;
  if (tensor && (dim_pad < 8 || reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(cent) % 16 != 0))
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
  if (tensor) {
    const long long blocks = (n + kTM - 1) / kTM;
    if (blocks > 0x7fffffffLL) return -1;
    rc = cudaFuncSetAttribute(assign_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    assign_tc_kernel<<<static_cast<unsigned>(blocks), kTThreads, kTSmemBytes, s>>>(
        d, n, dim_pad, c, c_pad, n_centroids, n_rows, row_n2, cen_n2, static_cast<int*>(assign),
        static_cast<float*>(dist), static_cast<int*>(stats));
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = (n + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return -1;
  assign_kernel<<<static_cast<unsigned>(blocks), pinot::kThreads, 0, s>>>(
      d, n, dim_pad, c, c_pad, n_centroids, n_rows, row_n2, cen_n2, static_cast<int*>(assign),
      static_cast<float*>(dist));
  return static_cast<int>(cudaGetLastError());
}
