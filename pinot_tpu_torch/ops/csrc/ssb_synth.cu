// K17 ssb_synth: the SSB lineorder lanes of a whole [S, P] stack,
// synthesized on the card, equal to JAX's bit for bit.
//
// Replaces pinot_tpu/tools/datagen.py:make_ssb_device_stack (:538-634):
// eight jax.random.randint draws (lo_quantity, lo_discount, lo_revenue,
// d_weeknuminyear, d_yearmonthnum, c_city, s_city, p_brand1), the derived
// dimensions (d_year = ymn / 12, d_yearmonth = ymn_to_ym[ymn], nation =
// city / 10, region = nation_region[nation], p_category = brand / 40,
// p_mfgr = brand / 200), lo_revenue's 7-bit part lanes (one gather of the
// [n_parts, card] int8 table a revenue id) and lo_supplycost as
// jax.random.uniform float32 x 1e5.
//
// Bit for bit: every draw is JAX's threefry2x32 under
// jax_threefry_partitionable (jax/_src/prng.py:1184-1200). Row i = s * P +
// p of the [S, P] draw is the counter (hi, lo) = (i >> 32, i & 0xffffffff)
// (iota_2x32_shape), its bits threefry2x32(key, hi, lo) folded as b0 ^ b1.
// randint(card) takes two such words under the two halves of its subkey's
// split (jax/_src/random.py:628-657) and reduces them in uint32
// arithmetic that wraps: ((hi % span) * mult + lo % span) % span with
// mult = ((2^16 % span)^2) % span. The float is (bits >> 9) | 0x3F800000
// reinterpreted, minus 1, times 1e5, with __fsub_rn / __fmul_rn so that
// nothing is contracted. The host derives every subkey of JAX's key chain
// (ops/synth.py:ssb_synth_keys) and passes them by value. Padding rows are
// drawn too, as JAX draws them.
//
// What bounds it: operations. A row takes 17 threefry evaluations (two a
// randint, one for the float) of 20 rounds each, about 1,300 integer
// operations, against 27 bytes written; at 100M rows that is some 1.3e11
// integer instructions (at most 128 lanes an SM issue one a clock)
// against 2.7 GB of stores.
//
// What the design does about it: one launch over the whole stack, one row
// a thread step of a grid-stride loop, every lane written by neighbouring
// threads at neighbouring addresses at its own width. The keys ride in the
// kernel's parameters; the part table (n_parts x card int8, 17 KB at the
// SSB revenue pool) and the two small derivation tables are staged in
// shared memory, so a row's only device-memory traffic is its stores.
// Integer % by a runtime span is kept plain (correct first).

#include "common.cuh"

namespace {

constexpr int kDraws = 8;          // randint draws, in JAX's key order
constexpr int kIdLanes = 16;       // id lanes written (draws + derived)
constexpr int kMaxParts = 8;

// Draw indices (JAX's order of key splits) and output lane indices (the
// order ops/synth.py:SYNTH_LANES lists them).
enum Draw { kQty, kDisc, kRev, kWeek, kYmn, kCCity, kSCity, kBrand };
enum Lane {
  oQty, oDisc, oRev, oWeek, oYmn, oYear, oYm, oCCity, oCNation, oCRegion,
  oSCity, oSNation, oSRegion, oBrand, oCategory, oMfgr
};

struct SynthArgs {
  uint32_t key[kDraws][4];   // randint's split halves: (k1a, k1b, k2a, k2b)
  uint32_t span[kDraws];
  uint32_t mult[kDraws];     // ((2^16 % span)^2) % span
  uint32_t ukey[2];          // the uniform's key
  void* out[kIdLanes];
  int elem[kIdLanes];
  float* cost;               // [S, P]
  int8_t* parts;             // [n_parts, S, P]
  const int8_t* part_table;  // [n_parts, rev_card]
  const int8_t* ymn_to_ym;   // [n_ymn]
  const int8_t* nation_region;  // [n_nation]
  int n_parts, rev_card, n_ymn, n_nation;
  long long s_total, padded;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 of counter (x0, x1) under key (k0, k1): JAX's unrolled
// lowering (jax/_src/prng.py:883-935), 20 rounds, a key injection every 4;
// returns x0 ^ x1 (random_bits at 32 bits). All uint32: adds wrap.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define PINOT_TF_ROUND(r) \
  x0 += x1;               \
  x1 = rotl(x1, r);       \
  x1 ^= x0;
#define PINOT_TF_ROT0 PINOT_TF_ROUND(13) PINOT_TF_ROUND(15) PINOT_TF_ROUND(26) PINOT_TF_ROUND(6)
#define PINOT_TF_ROT1 PINOT_TF_ROUND(17) PINOT_TF_ROUND(29) PINOT_TF_ROUND(16) PINOT_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  PINOT_TF_ROT0
  x0 += k1;
  x1 += k2 + 1u;
  PINOT_TF_ROT1
  x0 += k2;
  x1 += k0 + 2u;
  PINOT_TF_ROT0
  x0 += k0;
  x1 += k1 + 3u;
  PINOT_TF_ROT1
  x0 += k1;
  x1 += k2 + 4u;
  PINOT_TF_ROT0
  x0 += k2;
  x1 += k0 + 5u;
#undef PINOT_TF_ROT1
#undef PINOT_TF_ROT0
#undef PINOT_TF_ROUND
  return x0 ^ x1;
}

// jax.random.randint(0, span) at counter (hi, lo) from the halves
// (k0, k1) / (k2, k3) of its subkey's split. Arguments by value: the
// kernel's parameters stay in the constant bank, never copied per thread.
__device__ __forceinline__ int randint(uint32_t k0, uint32_t k1, uint32_t k2,
                                       uint32_t k3, uint32_t span, uint32_t mult,
                                       uint32_t hi, uint32_t lo) {
  const uint32_t higher = threefry_bits(k0, k1, hi, lo);
  const uint32_t lower = threefry_bits(k2, k3, hi, lo);
  // uint32 arithmetic that wraps, as lax.mul / lax.add on uint32 do
  const uint32_t off = (higher % span) * mult + lower % span;
  return static_cast<int>(off % span);
}

#define PINOT_DRAW(d)                                                        \
  randint(a.key[d][0], a.key[d][1], a.key[d][2], a.key[d][3], a.span[d], \
          a.mult[d], hi, lo)

__device__ __forceinline__ void write_id(void* lane, int elem, long long row, int v) {
  switch (elem) {
    case pinot::kI8: static_cast<int8_t*>(lane)[row] = static_cast<int8_t>(v); break;
    case pinot::kI16: static_cast<int16_t*>(lane)[row] = static_cast<int16_t>(v); break;
    default: static_cast<int32_t*>(lane)[row] = v; break;
  }
}

__global__ void ssb_synth_kernel(const SynthArgs a) {
  extern __shared__ int8_t smem[];
  int8_t* table = smem;                                    // part table
  int8_t* ym = table + a.n_parts * a.rev_card;             // ymn -> ym
  int8_t* region = ym + a.n_ymn;                           // nation -> region
  for (int t = threadIdx.x; t < a.n_parts * a.rev_card; t += blockDim.x)
    table[t] = a.part_table[t];
  for (int t = threadIdx.x; t < a.n_ymn; t += blockDim.x) ym[t] = a.ymn_to_ym[t];
  for (int t = threadIdx.x; t < a.n_nation; t += blockDim.x)
    region[t] = a.nation_region[t];
  __syncthreads();

  const long long total = a.s_total * a.padded;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += step) {
    const uint32_t hi = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32);
    const uint32_t lo = static_cast<uint32_t>(i & 0xffffffffLL);
    const int qty = PINOT_DRAW(kQty);
    const int disc = PINOT_DRAW(kDisc);
    const int rev = PINOT_DRAW(kRev);
    const int week = PINOT_DRAW(kWeek);
    const int ymn = PINOT_DRAW(kYmn);
    const int c_city = PINOT_DRAW(kCCity);
    const int s_city = PINOT_DRAW(kSCity);
    const int brand = PINOT_DRAW(kBrand);
    const uint32_t ubits = threefry_bits(a.ukey[0], a.ukey[1], hi, lo);

    write_id(a.out[oQty], a.elem[oQty], i, qty);
    write_id(a.out[oDisc], a.elem[oDisc], i, disc);
    write_id(a.out[oRev], a.elem[oRev], i, rev);
    write_id(a.out[oWeek], a.elem[oWeek], i, week);
    write_id(a.out[oYmn], a.elem[oYmn], i, ymn);
    write_id(a.out[oYear], a.elem[oYear], i, ymn / 12);
    write_id(a.out[oYm], a.elem[oYm], i, ym[ymn]);
    const int c_nation = c_city / 10, s_nation = s_city / 10;
    write_id(a.out[oCCity], a.elem[oCCity], i, c_city);
    write_id(a.out[oCNation], a.elem[oCNation], i, c_nation);
    write_id(a.out[oCRegion], a.elem[oCRegion], i, region[c_nation]);
    write_id(a.out[oSCity], a.elem[oSCity], i, s_city);
    write_id(a.out[oSNation], a.elem[oSNation], i, s_nation);
    write_id(a.out[oSRegion], a.elem[oSRegion], i, region[s_nation]);
    write_id(a.out[oBrand], a.elem[oBrand], i, brand);
    write_id(a.out[oCategory], a.elem[oCategory], i, brand / 40);
    write_id(a.out[oMfgr], a.elem[oMfgr], i, brand / 200);

    const float f = __uint_as_float((ubits >> 9) | 0x3F800000u);
    a.cost[i] = __fmul_rn(__fsub_rn(f, 1.0f), 1.0e5f);

    for (int k = 0; k < a.n_parts; ++k)
      a.parts[k * total + i] = table[k * a.rev_card + rev];
  }
}

#undef PINOT_DRAW

}  // namespace

// keys: uint32 [8][4] (each randint's split halves), spans: uint32 [8],
// ukey: uint32 [2]; outs: the 16 id lanes [S, P] in ops/synth.py's
// SYNTH_LANES order, elems their element codes; cost float32 [S, P];
// parts int8 [n_parts, S, P] (the port's stacked part layout; JAX's
// [S, n_parts, P] is a view of it); the tables int8 on the card.
extern "C" int pinot_ssb_synth(const unsigned* keys, const unsigned* spans,
                               const unsigned* ukey, void** outs, const int* elems,
                               void* cost, void* parts, const void* part_table,
                               int n_parts, int rev_card, const void* ymn_to_ym,
                               int n_ymn, const void* nation_region, int n_nation,
                               long long s_total, long long padded, void* stream) {
  if (s_total < 1 || padded < 1 || n_parts < 1 || n_parts > kMaxParts ||
      rev_card < 1 || n_ymn < 1 || n_nation < 1)
    return -1;
  SynthArgs a;
  for (int d = 0; d < kDraws; ++d) {
    if (spans[d] < 1) return -1;
    for (int w = 0; w < 4; ++w) a.key[d][w] = keys[d * 4 + w];
    a.span[d] = spans[d];
    const uint32_t m = (1u << 16) % spans[d];
    a.mult[d] = (m * m) % spans[d];     // uint32 product, as lax.mul wraps
  }
  a.ukey[0] = ukey[0];
  a.ukey[1] = ukey[1];
  for (int l = 0; l < kIdLanes; ++l) {
    a.out[l] = outs[l];
    a.elem[l] = elems[l];
  }
  a.cost = static_cast<float*>(cost);
  a.parts = static_cast<int8_t*>(parts);
  a.part_table = static_cast<const int8_t*>(part_table);
  a.ymn_to_ym = static_cast<const int8_t*>(ymn_to_ym);
  a.nation_region = static_cast<const int8_t*>(nation_region);
  a.n_parts = n_parts;
  a.rev_card = rev_card;
  a.n_ymn = n_ymn;
  a.n_nation = n_nation;
  a.s_total = s_total;
  a.padded = padded;
  const size_t smem = static_cast<size_t>(n_parts) * rev_card + n_ymn + n_nation;
  if (smem > 48 * 1024) {
    const cudaError_t rc = pinot::allow_dynamic_smem(ssb_synth_kernel, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int grid = pinot::grid_for(ssb_synth_kernel, s_total * padded, smem);
  ssb_synth_kernel<<<grid, pinot::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
