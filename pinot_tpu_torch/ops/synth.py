"""K17 ssb_synth: SSB lineorder lanes synthesized on the card, equal to
JAX's bit for bit.

Counterpart of the device part of pinot_tpu/tools/datagen.py:
make_ssb_device_stack (:538-634). JAX draws the lanes with
jax.random.randint / uniform, whose bits come from threefry2x32 (the
partitionable form, jax/_src/prng.py:1184-1200). This module holds that
function in plain PyTorch (int64 arithmetic masked to 32 bits, on any
device), JAX's key chain derived on the host (`ssb_synth_keys`), the K17
wrapper (`ssb_synth`, ops/csrc/ssb_synth.cu) and its plain version
(`ssb_synth_plain`). The wrapper takes the plain version only for tables
that lie on the CPU; for tables on the card it launches K17 or raises.

The draws, in JAX's order of key splits: lo_quantity, lo_discount,
lo_revenue, d_weeknuminyear, d_yearmonthnum, c_city, s_city, p_brand1
(each a randint over its pool), then lo_supplycost (a uniform float32
times 1e5). From PRNGKey(seed) = (0, seed), each draw splits the running
key into (key, sub); a randint splits sub once more into the keys of its
high and low words. Row i of the [S, P] stack draws with counter
(i >> 32, i & 0xffffffff), padding rows included.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from pinot_tpu_torch.ops import kernels

M32 = 0xFFFFFFFF
#: the randint draws, in JAX's key order
SYNTH_DRAWS = ("lo_quantity", "lo_discount", "lo_revenue",
               "d_weeknuminyear", "d_yearmonthnum", "c_city", "s_city",
               "p_brand1")
#: the id lanes K17 writes, in its output order (csrc/ssb_synth.cu:Lane)
SYNTH_LANES = ("lo_quantity", "lo_discount", "lo_revenue",
               "d_weeknuminyear", "d_yearmonthnum", "d_year", "d_yearmonth",
               "c_city", "c_nation", "c_region", "s_city", "s_nation",
               "s_region", "p_brand1", "p_category", "p_mfgr")
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: rows a chunk of the plain version computes at once (bounds its int64
#: temporaries)
PLAIN_CHUNK_ROWS = 1 << 22
#: part lanes K17 writes at most (csrc/ssb_synth.cu:kMaxParts)
MAX_PARTS = 8


def threefry2x32_plain(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of counters (x0, x1) under key (k0, k1), as JAX's
    unrolled lowering (jax/_src/prng.py:883-935) computes it: int64
    tensors holding uint32 values, every sum masked back to 32 bits."""
    k0, k1 = int(k0) & M32, int(k1) & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & M32
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & M32
    return x0, x1


def _host_threefry(key: Tuple[int, int], x0: int, x1: int
                   ) -> Tuple[int, int]:
    y0, y1 = threefry2x32_plain(key[0], key[1],
                                torch.tensor(x0, dtype=torch.int64),
                                torch.tensor(x1, dtype=torch.int64))
    return int(y0), int(y1)


def split_key(key: Tuple[int, int]) -> Tuple[Tuple[int, int],
                                              Tuple[int, int]]:
    """jax.random.split(key) under jax_threefry_partitionable: the two
    keys hash the counters (0, 0) and (0, 1)."""
    return _host_threefry(key, 0, 0), _host_threefry(key, 0, 1)


def random_bits_plain(key: Tuple[int, int], index: torch.Tensor
                      ) -> torch.Tensor:
    """32 random bits per flat row index (int64): b0 ^ b1 of the row's
    counter (index >> 32, index & 0xffffffff)."""
    y0, y1 = threefry2x32_plain(key[0], key[1], index >> 32, index & M32)
    return y0 ^ y1


def randint_mult(span: int) -> int:
    """jax.random.randint's multiplier 2^32 mod span, as ((2^16 % span)^2)
    % span in uint32 arithmetic that wraps."""
    m = (1 << 16) % span
    return ((m * m) & M32) % span


def randint_plain(keys: Tuple[int, int, int, int], span: int,
                  index: torch.Tensor) -> torch.Tensor:
    """jax.random.randint(0, span) at the given flat rows (int64 [n]),
    from the two halves (k1, k2) of its subkey's split: ((hi % span) *
    mult + lo % span) % span, wrapping at 32 bits."""
    hi = random_bits_plain(keys[:2], index)
    lo = random_bits_plain(keys[2:], index)
    off = ((hi % span) * randint_mult(span) + lo % span) & M32
    return off % span


def uniform_plain(key: Tuple[int, int], index: torch.Tensor
                  ) -> torch.Tensor:
    """jax.random.uniform float32 in [0, 1) at the given flat rows."""
    bits = (random_bits_plain(key, index) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


@dataclasses.dataclass(frozen=True)
class SynthKeys:
    """JAX's key chain for one seed: per randint draw the halves of its
    subkey's split (k1a, k1b, k2a, k2b) and its span; the uniform's key."""
    randint: Tuple[Tuple[int, int, int, int], ...]
    spans: Tuple[int, ...]
    uniform: Tuple[int, int]


def ssb_synth_keys(seed: int, spans: Sequence[int]) -> SynthKeys:
    """Every subkey make_ssb_device_stack's draws use, in JAX's order:
    PRNGKey(seed) = (seed >> 32, seed & 0xffffffff); each draw splits the
    running key into (key, sub); a randint splits sub into (k1, k2)."""
    key = ((int(seed) >> 32) & M32, int(seed) & M32)
    draws = []
    for _ in SYNTH_DRAWS:
        key, sub = split_key(key)
        k1, k2 = split_key(sub)
        draws.append(k1 + k2)
    key, sub = split_key(key)
    return SynthKeys(tuple(draws), tuple(int(s) for s in spans), sub)


@dataclasses.dataclass
class SynthTables:
    """The small tables K17 reads, int8 on one device: the d_yearmonthnum
    id → d_yearmonth id map, the nation id → region id map and
    lo_revenue's 7-bit part table [n_parts, card]."""
    ymn_to_ym: torch.Tensor
    nation_region: torch.Tensor
    part_table: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.part_table.device


def synth_rows_plain(keys: SynthKeys, tables: SynthTables,
                     index: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain PyTorch K17 at the given flat rows (int64 [n], on the tables'
    device): {lane: int64 ids [n]}, "lo_supplycost" float32 [n] and
    "parts" int8 [n_parts, n]."""
    out: Dict[str, torch.Tensor] = {}
    for name, k, span in zip(SYNTH_DRAWS, keys.randint, keys.spans):
        out[name] = randint_plain(k, span, index)
    ymn = out["d_yearmonthnum"]
    out["d_year"] = ymn // 12
    out["d_yearmonth"] = tables.ymn_to_ym.long()[ymn]
    for side in ("c", "s"):
        nation = out[f"{side}_city"] // 10
        out[f"{side}_nation"] = nation
        out[f"{side}_region"] = tables.nation_region.long()[nation]
    brand = out["p_brand1"]
    out["p_category"] = brand // 40
    out["p_mfgr"] = brand // 200
    out["lo_supplycost"] = uniform_plain(keys.uniform, index) * 1e5
    out["parts"] = tables.part_table[:, out["lo_revenue"]]
    return out


def _alloc(s_total: int, padded: int, dtypes: Dict[str, torch.dtype],
           n_parts: int, device) -> Dict[str, torch.Tensor]:
    out = {name: torch.empty((s_total, padded), dtype=dtypes[name],
                             device=device) for name in SYNTH_LANES}
    out["lo_supplycost"] = torch.empty((s_total, padded),
                                       dtype=torch.float32, device=device)
    out["parts"] = torch.empty((n_parts, s_total, padded), dtype=torch.int8,
                               device=device)
    return out


def _check(keys: SynthKeys, tables: SynthTables, s_total: int, padded: int,
           dtypes: Dict[str, torch.dtype]) -> None:
    if len(keys.randint) != len(SYNTH_DRAWS) or \
            len(keys.spans) != len(SYNTH_DRAWS):
        raise ValueError(f"{len(keys.randint)} keys for "
                         f"{len(SYNTH_DRAWS)} draws")
    if min(keys.spans) < 1 or max(keys.spans) > kernels.INT32_MAX:
        raise ValueError(f"spans {keys.spans} outside [1, 2^31)")
    if s_total < 1 or padded < 1:
        raise ValueError(f"stack [{s_total}, {padded}] is empty")
    for name, t in (("ymn_to_ym", tables.ymn_to_ym),
                    ("nation_region", tables.nation_region),
                    ("part_table", tables.part_table)):
        if t.dtype != torch.int8 or not t.is_contiguous() or \
                t.device != tables.device:
            raise ValueError(f"{name}: expected a contiguous int8 tensor "
                             f"on {tables.device}")
    if tables.part_table.dim() != 2 or not 1 <= tables.part_table.shape[0] \
            <= MAX_PARTS:
        raise ValueError(f"part table of shape "
                         f"{tuple(tables.part_table.shape)}")
    for name in SYNTH_LANES:
        if dtypes.get(name) not in kernels._ID_DTYPES:
            raise ValueError(f"{name}: lane dtype {dtypes.get(name)}")


def ssb_synth(keys: SynthKeys, tables: SynthTables, s_total: int,
              padded: int, dtypes: Dict[str, torch.dtype]
              ) -> Dict[str, torch.Tensor]:
    """K17: the [S, P] SSB lanes on the tables' device, {lane: ids at
    dtypes[lane]} for SYNTH_LANES, "lo_supplycost" float32 [S, P] and
    "parts" int8 [n_parts, S, P] (lo_revenue's part lanes in the port's
    stacked layout)."""
    _check(keys, tables, s_total, padded, dtypes)
    device = tables.device
    if device.type == "cpu":
        return ssb_synth_plain(keys, tables, s_total, padded, dtypes)
    n_parts, rev_card = tables.part_table.shape
    out = _alloc(s_total, padded, dtypes, n_parts, device)
    words = (ctypes.c_uint * (4 * len(SYNTH_DRAWS)))(
        *[w for k in keys.randint for w in k])
    spans = (ctypes.c_uint * len(SYNTH_DRAWS))(*keys.spans)
    ukey = (ctypes.c_uint * 2)(*keys.uniform)
    lanes = [out[name] for name in SYNTH_LANES]
    kernels._launch(
        "ssb_synth", device, words, spans, ukey, kernels._ptrs(lanes),
        kernels._ints([kernels._ELEM[t.dtype] for t in lanes]),
        out["lo_supplycost"].data_ptr(), out["parts"].data_ptr(),
        tables.part_table.data_ptr(), n_parts, rev_card,
        tables.ymn_to_ym.data_ptr(), tables.ymn_to_ym.numel(),
        tables.nation_region.data_ptr(), tables.nation_region.numel(),
        s_total, padded)
    return out


def ssb_synth_plain(keys: SynthKeys, tables: SynthTables, s_total: int,
                    padded: int, dtypes: Dict[str, torch.dtype]
                    ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch K17 on the tables' device, in chunks of
    PLAIN_CHUNK_ROWS rows: the same outputs as ssb_synth."""
    _check(keys, tables, s_total, padded, dtypes)
    device = tables.device
    out = _alloc(s_total, padded, dtypes, tables.part_table.shape[0],
                 device)
    flat = {name: t.view(-1) for name, t in out.items() if name != "parts"}
    parts = out["parts"].view(out["parts"].shape[0], -1)
    total = s_total * padded
    for start in range(0, total, PLAIN_CHUNK_ROWS):
        stop = min(total, start + PLAIN_CHUNK_ROWS)
        rows = synth_rows_plain(keys, tables, torch.arange(
            start, stop, dtype=torch.int64, device=device))
        for name, t in flat.items():
            t[start:stop] = rows[name].to(t.dtype)
        parts[:, start:stop] = rows["parts"]
    return out
