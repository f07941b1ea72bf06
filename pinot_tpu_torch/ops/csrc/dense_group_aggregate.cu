// K3 dense_group_aggregate: per-group count, exact int32 part sums and
// float64 sums over a dense mixed-radix group table.
//
// Replaces pinot_tpu/ops/kernels.py:_group_key (:702, kind "ids"),
// _dense_group_count (:402), _dense_group_part_sums (:407),
// _dense_group_float_sums (:503) and the scatter fallback of
// _group_outputs (:1330-1360) for count / sum / avg.
//
// For every matched row: key = clip(sum_c ids_c * stride_c, 0, g_pad - 1)
// in int32 (as at kernels.py:766-768), then
//   count[key] += 1, psums[l][key] += parts_l[row], csums[j][key] += vals_j[row]
// and the total match count.
//
// What bounds it: bytes, once the matched rows are few: one mask byte per
// row, then for matched rows only their key ids, part bytes and float64
// values, plus the group table written. With many matched rows landing in
// few groups, contention on the atomics in device memory bounds it instead.
//
// What the design does about it: the TPU kernels built one-hot tiles for
// the matrix unit because scatter is slow there; on Hopper an atomicAdd
// into device memory is the natural primitive, so this kernel does one
// pass over the rows and adds matched rows straight into the table
// (int32 atomics for counts and part sums: exact, order-free; float64
// atomicAdd for csums, native on sm_90: the order varies from run to
// run, so float sums are held to a tolerance). Rows that do not match
// cost one mask byte. The int32 bound holds because the planner keeps
// P <= 2^24, so 127 * rows < 2^31. Privatising the table in shared
// memory for small g_pad is later work.

#include "common.cuh"

namespace {

constexpr int kMaxKeys = 8;
constexpr int kMaxParts = 16;
constexpr int kMaxFloats = 8;

struct KeyLanes {
  const void* ptr[kMaxKeys];
  int elem[kMaxKeys];
  int stride[kMaxKeys];
};

struct PartLanes {
  const int8_t* ptr[kMaxParts];
};

struct FloatLanes {
  const double* ptr[kMaxFloats];
};

__global__ void dense_group_aggregate_kernel(
    const uint8_t* __restrict__ mask, KeyLanes keys, int n_keys,
    PartLanes parts, int n_parts, FloatLanes floats, int n_floats,
    long long padded, int g_pad, int* __restrict__ count,
    int* __restrict__ psums, double* __restrict__ csums,
    int* __restrict__ matched) {
  __shared__ int scratch[32];
  int local = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < padded; row += step) {
    if (!mask[row]) continue;
    int key = 0;
    for (int c = 0; c < n_keys; ++c)
      key += pinot::read_id(keys.ptr[c], keys.elem[c], row) * keys.stride[c];
    key = min(max(key, 0), g_pad - 1);
    ++local;
    atomicAdd(count + key, 1);
    for (int l = 0; l < n_parts; ++l) {
      const int p = parts.ptr[l][row];
      if (p != 0) atomicAdd(psums + static_cast<long long>(l) * g_pad + key, p);
    }
    for (int j = 0; j < n_floats; ++j)
      atomicAdd(csums + static_cast<long long>(j) * g_pad + key, floats.ptr[j][row]);
  }
  const int total = pinot::block_sum(local, scratch);
  if (threadIdx.x == 0 && total != 0) atomicAdd(matched, total);
}

}  // namespace

extern "C" int pinot_dense_group_aggregate(
    const void* mask, const void* const* key_ptrs, const int* key_elems,
    const int* key_strides, int n_keys, const void* const* part_ptrs,
    int n_parts, const void* const* float_ptrs, int n_floats,
    long long padded, int g_pad, void* count, void* psums, void* csums,
    void* matched, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || n_parts < 0 || n_parts > kMaxParts ||
      n_floats < 0 || n_floats > kMaxFloats || g_pad < 1)
    return -1;
  KeyLanes keys{};
  for (int c = 0; c < n_keys; ++c) {
    keys.ptr[c] = key_ptrs[c];
    keys.elem[c] = key_elems[c];
    keys.stride[c] = key_strides[c];
  }
  PartLanes parts{};
  for (int l = 0; l < n_parts; ++l)
    parts.ptr[l] = static_cast<const int8_t*>(part_ptrs[l]);
  FloatLanes floats{};
  for (int j = 0; j < n_floats; ++j)
    floats.ptr[j] = static_cast<const double*>(float_ptrs[j]);
  dense_group_aggregate_kernel<<<pinot::grid_for(padded), pinot::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), keys, n_keys, parts, n_parts, floats,
      n_floats, padded, g_pad, static_cast<int*>(count),
      static_cast<int*>(psums), static_cast<double*>(csums),
      static_cast<int*>(matched));
  return static_cast<int>(cudaGetLastError());
}
