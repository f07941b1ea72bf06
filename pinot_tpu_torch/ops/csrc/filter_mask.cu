// K1 filter_mask: the per-row filter of a segment plan as a uint8 mask.
//
// Replaces pinot_tpu/ops/kernels.py:_eval_filter (:175) and _eval_pred
// (:82) for the dictId predicate kinds eq_id, neq_id, range_ids, in_ids,
// notin_ids and member, under and/or nodes of any arity.
//
// What bounds it: bytes. Each row reads one id per distinct leaf lane (1, 2
// or 4 bytes) and writes one mask byte, a handful of integer compares per
// row; at 3.35 TB/s the reads and the write are the whole cost.
//
// What the design does about it: the host flattens the filter tree into a
// postfix program plus its parameters (one small int32 buffer, one copy to
// the card per dispatch). Each block stages that buffer in shared memory,
// so in-lists and member bitsets are read from shared memory, never from
// device memory per row. One thread evaluates one row at a time over a
// grid-stride loop: neighbouring threads read neighbouring ids of each
// lane (coalesced), and the program runs on a bit stack in one register.
// A leaf's lane is read only when that leaf is evaluated.
//
// Program node: 4 int32 {op, lane, param offset, arg}. AND/OR pop `arg`
// bits (arg <= 31) and push one; leaves push one. The host checks that the
// stack never holds more than 32 bits.

#include "common.cuh"

namespace {

constexpr int kMaxLanes = 16;
constexpr int kMaxSmemWords = 12 * 1024;   // 48 KB: no opt-in needed

enum Op : int {
  kTrue = 0, kFalse = 1, kEq = 2, kNeq = 3, kRange = 4, kIn = 5,
  kNotIn = 6, kMember = 7, kAnd = 8, kOr = 9,
};

struct Lanes {
  const void* ptr[kMaxLanes];
  int elem[kMaxLanes];
};

__global__ void filter_mask_kernel(Lanes lanes, const int* __restrict__ prog,
                                   int n_nodes, int n_words, int staged,
                                   long long padded, long long num_docs,
                                   uint8_t* __restrict__ out) {
  extern __shared__ int smem[];
  const int* buf = prog;
  if (staged) {
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) smem[i] = prog[i];
    __syncthreads();
    buf = smem;
  }
  const int* params = buf + 4 * n_nodes;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < padded; row += step) {
    unsigned stack = 0u;
    if (row < num_docs) {
      for (int n = 0; n < n_nodes; ++n) {
        const int op = buf[4 * n], lane = buf[4 * n + 1];
        const int off = buf[4 * n + 2], arg = buf[4 * n + 3];
        unsigned bit;
        if (op == kAnd || op == kOr) {
          const unsigned m = (1u << arg) - 1u;
          const unsigned kids = stack & m;
          stack >>= arg;
          bit = op == kAnd ? (kids == m) : (kids != 0u);
        } else if (op == kTrue) {
          bit = 1u;
        } else if (op == kFalse) {
          bit = 0u;
        } else {
          const int v = pinot::read_id(lanes.ptr[lane], lanes.elem[lane], row);
          switch (op) {
            case kEq: bit = v == params[off]; break;
            case kNeq: bit = v != params[off]; break;
            case kRange: bit = v >= params[off] && v < params[off + 1]; break;
            case kIn:
            case kNotIn: {
              unsigned hit = 0u;
              for (int i = 0; i < arg; ++i) hit |= (v == params[off + i]);
              bit = op == kIn ? hit : (hit ^ 1u);
              break;
            }
            default: {  // kMember: bitset over [0, card_pad), index clipped
              const int idx = min(max(v, 0), arg - 1);
              bit = (static_cast<unsigned>(params[off + (idx >> 5)]) >> (idx & 31)) & 1u;
            }
          }
        }
        stack = (stack << 1) | bit;
      }
    }
    out[row] = static_cast<uint8_t>(stack & 1u);
  }
}

}  // namespace

extern "C" int pinot_filter_mask(const void* const* lane_ptrs,
                                 const int* lane_elems, int n_lanes,
                                 const int* prog, int n_nodes, int n_words,
                                 long long padded, long long num_docs,
                                 void* out, void* stream) {
  if (n_lanes < 0 || n_lanes > kMaxLanes || n_nodes < 1) return -1;
  Lanes lanes{};
  for (int i = 0; i < n_lanes; ++i) {
    lanes.ptr[i] = lane_ptrs[i];
    lanes.elem[i] = lane_elems[i];
  }
  const int staged = n_words <= kMaxSmemWords ? 1 : 0;
  const size_t smem = staged ? static_cast<size_t>(n_words) * sizeof(int) : 0;
  filter_mask_kernel<<<pinot::grid_for(padded), pinot::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lanes, prog, n_nodes, n_words, staged, padded, num_docs,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
