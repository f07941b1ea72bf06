// K11 ivf_recenter: the recentering half of one Lloyd step.
//
// Replaces the one-hot recentering of pinot_tpu/ops/ivf_kernels.py:
// build_ivf_train_kernel (:51-69), which K10's assignments feed (the train
// step is K10 then K11):
//   counts[c] = #{r < n_rows : assign[r] == c}
//   new[c]    = sum_{r < n_rows, assign[r] == c} data[r] / counts[c],
//               or the prior centroid where counts[c] == 0.
// The JAX kernel sums with a one-hot matmul (oh.T @ data) whose order is
// XLA's. Here the order of every add is fixed by the assignments alone, and
// there are no float atomics: the same rows and prior give the same
// codebook bits on every run, which is what makes a sealed codebook
// reproducible (pinot_tpu/index/ivf.py:train). Cross-backend the sums
// differ in the last bits, as the JAX module says training may.
//
// What bounds it: bytes, at the sizes training uses (a sample of at most
// trainSampleSize rows): every live row of data is read once (65,536 x 128
// floats: 32 MB, about 10 µs at the memory rate), and the assignments once.
// The design, five short launches:
//   1. histogram: a block a chunk of rows (1,024 or more) counts its rows
//      per centroid in shared memory (integer atomics, exact), a pass per
//      1,024 centroids, into table[chunk][c];
//   2. scan: one block turns the table, centroid-major, into each (chunk,
//      centroid)'s first position in the ordered row list, writes counts[c]
//      and start[c], and cuts each centroid's rows into pieces of up to 64
//      rows (first position and length a piece);
//   3. scatter: the live rows' ids, stable, by centroid: a block walks its
//      chunk in tiles of 256 rows in order; __match_any_sync groups a warp's
//      rows by centroid, a row's rank is its peers in lower lanes, and each
//      warp's count of a centroid in the tile (tagged with the tile, so the
//      table is never cleared) gives the rows of earlier warps (K12's
//      scatter, sort_window.cu);
//   4. piece sums: a warp sums one piece over 128 dims (a 512-byte row
//      slice, 16 bytes a lane), its 64 row ids loaded once, 8 rows' loads
//      in flight before their adds, which run in ascending row order (8
//      rather than 16 or 32: fewer registers, more warps resident, faster
//      on the card);
//   5. combine: a block a centroid and dim slice adds its pieces in piece
//      order (32 warps take consecutive runs, then warp order), and
//      divides with __fdiv_rn or keeps the prior.
// Work is spread by rows, not by centroids, so one centroid holding every
// row costs what a spread codebook does; only the combine's runs grow (64
// rows a piece).

#include "common.cuh"
#include "vec_tree.cuh"

namespace {

constexpr int kTileRows = pinot::kThreads;   // rows a scatter tile ranks at once
constexpr int kWarps = pinot::kThreads / 32;
constexpr int kPass = 1024;                  // centroids a histogram / scatter pass holds
constexpr int kPieceRows = 64;               // rows a piece sums
constexpr int kMinChunk = 1024;              // rows a histogram / scatter block
constexpr long long kMaxTable = 1LL << 24;   // entries of the chunk x centroid table
constexpr int kScanThreads = 1024;
constexpr int kBatch = 8;                    // a piece's rows loaded before their adds
constexpr int kCombineWarps = 32;            // warps adding one centroid's pieces
constexpr int kCombineUnroll = 8;

// rows a histogram / scatter block takes: at least kMinChunk, doubled until
// the chunk x centroid table fits kMaxTable entries
long long chunk_rows(long long n_rows, int c_pad) {
  long long r = kMinChunk;
  while ((n_rows + r - 1) / r * c_pad > kMaxTable) r *= 2;
  return r;
}

__device__ __forceinline__ int live_centroid(const int* __restrict__ assign, long long r,
                                             long long end, int c_pad) {
  if (r >= end) return -1;
  const int a = assign[r];
  return a >= 0 && a < c_pad ? a : -1;
}

__global__ void __launch_bounds__(pinot::kThreads)
    histogram_kernel(const int* __restrict__ assign, long long n_rows, int c_pad,
                     long long chunk, int* __restrict__ table) {
  __shared__ int hist[kPass];
  const int lane = threadIdx.x & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(r0 + chunk, n_rows);
  for (int c0 = 0; c0 < c_pad; c0 += kPass) {
    const int cn = min(kPass, c_pad - c0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (long long base = r0; base < r1; base += kTileRows) {
      const int a = live_centroid(assign, base + threadIdx.x, r1, c_pad);
      const bool mine = a >= c0 && a < c0 + cn;
      const unsigned peers = __match_any_sync(0xffffffffu, mine ? a : -1);
      if (mine && lane == __ffs(peers) - 1) atomicAdd(hist + (a - c0), __popc(peers));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cn; i += blockDim.x)
      table[static_cast<long long>(blockIdx.x) * c_pad + c0 + i] = hist[i];
    __syncthreads();
  }
}

// One block of kScanThreads. Thread c (a round of kScanThreads centroids at
// a time) sums its column of the table, the block scans (rows, pieces)
// packed in one 64-bit word (rows < 2^31 in the low half), and the thread
// rewrites its column as first positions. Then the block writes the
// round's pieces (first position and rows), a thread a piece, each finding
// its centroid by a binary search over the round's piece starts in shared
// memory: one centroid with every row costs what a spread codebook does.
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ table, int n_chunks, int c_pad, int* __restrict__ counts,
                int* __restrict__ start, int* __restrict__ pstart, int* __restrict__ piece_first,
                int* __restrict__ piece_len) {
  __shared__ unsigned long long warp_sum[kScanThreads / 32];
  __shared__ unsigned long long carry;
  __shared__ int round_pstart[kScanThreads], round_start[kScanThreads],
      round_total[kScanThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0ULL;
  __syncthreads();
  for (int base = 0; base < c_pad; base += kScanThreads) {
    const int c = base + threadIdx.x;
    int total = 0;
    if (c < c_pad)
      for (int b = 0; b < n_chunks; ++b) total += table[static_cast<long long>(b) * c_pad + c];
    const int pieces = (total + kPieceRows - 1) / kPieceRows;
    const unsigned long long x =
        (static_cast<unsigned long long>(pieces) << 32) | static_cast<unsigned>(total);
    unsigned long long inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long up = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += up;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long up = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += up;
      }
      warp_sum[lane] = w;               // inclusive over warps
    }
    __syncthreads();
    const unsigned long long exc = carry + (warp ? warp_sum[warp - 1] : 0ULL) + inc - x;
    const int st = static_cast<int>(exc & 0xffffffffULL);
    const int ps = static_cast<int>(exc >> 32);
    if (c < c_pad) {
      int run = st;
      for (int b = 0; b < n_chunks; ++b) {
        const long long at = static_cast<long long>(b) * c_pad + c;
        const int k = table[at];
        table[at] = run;
        run += k;
      }
      counts[c] = total;
      start[c] = st;
      pstart[c] = ps;
    }
    round_pstart[threadIdx.x] = ps;     // past c_pad: the round's end, no pieces
    round_start[threadIdx.x] = st;
    round_total[threadIdx.x] = total;
    __syncthreads();
    const unsigned long long end = carry + warp_sum[kScanThreads / 32 - 1];
    const int p0 = static_cast<int>(carry >> 32), p1 = static_cast<int>(end >> 32);
    for (int p = p0 + static_cast<int>(threadIdx.x); p < p1; p += kScanThreads) {
      int lo = 0, hi = kScanThreads;    // the last i with round_pstart[i] <= p
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (round_pstart[mid] <= p) lo = mid; else hi = mid;
      }
      const int k = (p - round_pstart[lo]) * kPieceRows;
      piece_first[p] = round_start[lo] + k;
      piece_len[p] = min(kPieceRows, round_total[lo] - k);
    }
    __syncthreads();                    // every thread has read carry and the round
    if (threadIdx.x == 0) carry = end;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    start[c_pad] = static_cast<int>(carry & 0xffffffffULL);
    pstart[c_pad] = static_cast<int>(carry >> 32);
  }
}

__global__ void __launch_bounds__(pinot::kThreads)
    scatter_kernel(const int* __restrict__ assign, long long n_rows, int c_pad, long long chunk,
                   const int* __restrict__ table, int* __restrict__ order) {
  __shared__ int base[kPass];
  // (tile << 6) | rows of warp w on centroid c in that tile
  __shared__ unsigned tagged[kWarps][kPass];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long r1 = min(r0 + chunk, n_rows);
  for (int c0 = 0; c0 < c_pad; c0 += kPass) {
    const int cn = min(kPass, c_pad - c0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      base[i] = table[static_cast<long long>(blockIdx.x) * c_pad + c0 + i];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tagged[w][i] = 0xffffffffu;
    }
    __syncthreads();
    unsigned tile = 0;
    for (long long t0 = r0; t0 < r1; t0 += kTileRows, ++tile) {
      const long long r = t0 + threadIdx.x;
      const int a = live_centroid(assign, r, r1, c_pad);
      const bool mine = a >= c0 && a < c0 + cn;
      const unsigned peers = __match_any_sync(0xffffffffu, mine ? a : -1);
      const bool leader = mine && lane == __ffs(peers) - 1;
      if (leader) tagged[warp][a - c0] = (tile << 6) | __popc(peers);
      __syncthreads();
      if (mine) {
        int pos = base[a - c0] + __popc(peers & lt);
        for (int w = 0; w < warp; ++w) {
          const unsigned t = tagged[w][a - c0];
          if ((t >> 6) == tile) pos += static_cast<int>(t & 63u);
        }
        order[pos] = static_cast<int>(r);
      }
      __syncthreads();
      if (leader) atomicAdd(base + (a - c0), __popc(peers));
    }
    __syncthreads();
  }
}

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vzero(float*) { return 0.f; }
__device__ __forceinline__ float2 vzero(float2*) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ float4 vzero(float4*) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float vdiv(float a, float c) { return __fdiv_rn(a, c); }
__device__ __forceinline__ float2 vdiv(float2 a, float c) {
  return make_float2(__fdiv_rn(a.x, c), __fdiv_rn(a.y, c));
}
__device__ __forceinline__ float4 vdiv(float4 a, float c) {
  return make_float4(__fdiv_rn(a.x, c), __fdiv_rn(a.y, c), __fdiv_rn(a.z, c), __fdiv_rn(a.w, c));
}

// Warp `item` sums piece item / slices over dims [(slice * 32 + lane) * V,
// + V): the piece's (up to 64) row ids are loaded once, two a lane, and
// shuffled to every lane; kBatch rows' loads are in flight before their
// adds, which run in ascending row order.
template <int V>
__global__ void __launch_bounds__(pinot::kThreads)
    piece_sums_kernel(const float* __restrict__ data, int dim_pad, const int* __restrict__ order,
                      const int* __restrict__ piece_first, const int* __restrict__ piece_len,
                      const int* __restrict__ n_pieces, int slices, long long items,
                      float* __restrict__ partial) {
  static_assert(kPieceRows == 64, "a piece's ids are two a lane");
  using T = typename Vec<V>::T;
  const long long item =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = item / slices;
  if (item >= items || p >= *n_pieces) return;      // the whole warp
  const int first = piece_first[p], len = piece_len[p];
  const int d = (static_cast<int>(item % slices) * 32 + lane) * V;
  const bool on = d < dim_pad;
  const int id_lo = lane < len ? order[first + lane] : 0;
  const int id_hi = lane + 32 < len ? order[first + 32 + lane] : 0;
  T acc = vzero(static_cast<T*>(nullptr));
#pragma unroll
  for (int i = 0; i < kPieceRows; i += kBatch) {
    if (i >= len) break;
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = i + u;
      const int id = __shfl_sync(0xffffffffu, j < 32 ? id_lo : id_hi, j & 31);
      if (on && j < len)
        x[u] = *reinterpret_cast<const T*>(data + static_cast<long long>(id) * dim_pad + d);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (on && i + u < len) acc = vadd(acc, x[u]);
  }
  if (on) *reinterpret_cast<T*>(partial + p * dim_pad + d) = acc;
}

// Block (c, slice): warp w adds its run of c's pieces in order, warp 0
// adds the runs in warp order, then the mean or the prior.
template <int V>
__global__ void __launch_bounds__(kCombineWarps * 32)
    combine_kernel(const float* __restrict__ partial, int dim_pad, const int* __restrict__ pstart,
                   const int* __restrict__ counts, const float* __restrict__ prior,
                   float* __restrict__ out, int slices) {
  using T = typename Vec<V>::T;
  __shared__ T runs[kCombineWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x / slices;
  const int d = ((blockIdx.x % slices) * 32 + lane) * V;
  const bool on = d < dim_pad;
  const int p0 = pstart[c], n_p = pstart[c + 1] - p0;
  const int per = (n_p + kCombineWarps - 1) / kCombineWarps;
  const int lo = p0 + min(warp * per, n_p), hi = p0 + min((warp + 1) * per, n_p);
  T acc = vzero(static_cast<T*>(nullptr));
  if (on) {
    for (int p = lo; p < hi; p += kCombineUnroll) {
      T x[kCombineUnroll];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u)
        if (p + u < hi)
          x[u] = *reinterpret_cast<const T*>(partial + static_cast<long long>(p + u) * dim_pad + d);
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u)
        if (p + u < hi) acc = p + u == lo ? x[u] : vadd(acc, x[u]);
    }
  }
  runs[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || !on) return;
  T total = runs[0][lane];
  for (int w = 1; w < kCombineWarps && w * per < n_p; ++w) total = vadd(total, runs[w][lane]);
  const long long at = static_cast<long long>(c) * dim_pad + d;
  const int cnt = counts[c];
  *reinterpret_cast<T*>(out + at) =
      cnt > 0 ? vdiv(total, static_cast<float>(cnt)) : *reinterpret_cast<const T*>(prior + at);
}

struct Layout {
  long long chunk, n_chunks, max_pieces;
  // word offsets
  long long table, start, pstart, order, piece_first, piece_len, partial, words;
};

Layout layout(long long n_rows, int dim_pad, int c_pad) {
  Layout l{};
  l.chunk = chunk_rows(n_rows, c_pad);
  l.n_chunks = (n_rows + l.chunk - 1) / l.chunk;
  l.max_pieces = (n_rows + kPieceRows - 1) / kPieceRows + c_pad;
  l.table = 0;
  l.start = l.table + l.n_chunks * c_pad;
  l.pstart = l.start + c_pad + 1;
  l.order = l.pstart + c_pad + 1;
  l.piece_first = l.order + n_rows;
  l.piece_len = l.piece_first + l.max_pieces;
  l.partial = (l.piece_len + l.max_pieces + 3) / 4 * 4;      // 16-byte aligned
  l.words = l.partial + l.max_pieces * dim_pad;
  return l;
}

template <int V>
void launch_sums(const float* data, int dim_pad, const float* prior, int c_pad, float* out,
                 const int* counts, int* scratch, const Layout& l, cudaStream_t s) {
  const int slices = (dim_pad + 32 * V - 1) / (32 * V);
  const long long items = l.max_pieces * slices;
  const long long grid = (items * 32 + pinot::kThreads - 1) / pinot::kThreads;
  float* partial = reinterpret_cast<float*>(scratch + l.partial);
  piece_sums_kernel<V><<<static_cast<unsigned>(grid), pinot::kThreads, 0, s>>>(
      data, dim_pad, scratch + l.order, scratch + l.piece_first, scratch + l.piece_len,
      scratch + l.pstart + c_pad, slices, items, partial);
  combine_kernel<V><<<static_cast<unsigned>(static_cast<long long>(c_pad) * slices),
                      kCombineWarps * 32, 0, s>>>(partial, dim_pad, scratch + l.pstart, counts,
                                                  prior, out, slices);
}

}  // namespace

// int32 words of scratch pinot_ivf_recenter takes (no zeroing needed).
extern "C" long long pinot_ivf_recenter_scratch_words(long long n_rows, int dim_pad, int c_pad) {
  return layout(n_rows, dim_pad, c_pad).words;
}

// data f32 [n][dim_pad] (16-byte aligned), assign int32 [n] (K10's),
// prior f32 [c_pad][dim_pad]; out f32 [c_pad][dim_pad], counts int32
// [c_pad]; scratch: pinot_ivf_recenter_scratch_words int32 words, 16-byte
// aligned. Rows r >= n_rows are padding and count nowhere.
extern "C" int pinot_ivf_recenter(const void* data, const void* assign, long long n_rows,
                                  int dim_pad, const void* prior, int c_pad, void* out,
                                  void* counts, void* scratch, void* stream) {
  if (n_rows < 0 || n_rows > 0x7fffffffLL || dim_pad < 1 || dim_pad > pinot::kMaxVecDim ||
      (dim_pad & (dim_pad - 1)) || c_pad < 1 || reinterpret_cast<uintptr_t>(data) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 || reinterpret_cast<uintptr_t>(prior) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n_rows, dim_pad, c_pad);
  int* w = static_cast<int*>(scratch);
  const int* a = static_cast<const int*>(assign);
  if (l.n_chunks > 0)
    histogram_kernel<<<static_cast<unsigned>(l.n_chunks), pinot::kThreads, 0, s>>>(
        a, n_rows, c_pad, l.chunk, w + l.table);
  scan_kernel<<<1, kScanThreads, 0, s>>>(w + l.table, static_cast<int>(l.n_chunks), c_pad,
                                         static_cast<int*>(counts), w + l.start, w + l.pstart,
                                         w + l.piece_first, w + l.piece_len);
  if (l.n_chunks > 0)
    scatter_kernel<<<static_cast<unsigned>(l.n_chunks), pinot::kThreads, 0, s>>>(
        a, n_rows, c_pad, l.chunk, w + l.table, w + l.order);
  const float* d = static_cast<const float*>(data);
  const float* p = static_cast<const float*>(prior);
  float* o = static_cast<float*>(out);
  int* cn = static_cast<int*>(counts);
  if (dim_pad >= 4)
    launch_sums<4>(d, dim_pad, p, c_pad, o, cn, w, l, s);
  else if (dim_pad == 2)
    launch_sums<2>(d, dim_pad, p, c_pad, o, cn, w, l, s);
  else
    launch_sums<1>(d, dim_pad, p, c_pad, o, cn, w, l, s);
  return static_cast<int>(cudaGetLastError());
}
