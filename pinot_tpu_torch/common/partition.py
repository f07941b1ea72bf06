"""Partition functions (parity: core/data/partition/).

Java-compatible hash semantics so data partitioned by the reference's
functions (Kafka-producer murmur2, Java String.hashCode, modulo) maps to
the same partition ids here — partition-aware routing/pruning depends on
cross-system agreement.
"""
from __future__ import annotations

from typing import Dict, List, Optional

_I32 = 0xFFFFFFFF


def _i32(x: int) -> int:
    """Wrap to Java int (signed 32-bit) semantics."""
    x &= _I32
    return x - (1 << 32) if x >= (1 << 31) else x


def murmur2(data: bytes) -> int:
    """Kafka's murmur2 (MurmurPartitionFunction.java:66-105), exact."""
    length = len(data)
    seed = 0x9747B28C
    m = 0x5BD1E995
    r = 24
    h = _i32(seed ^ length)
    length4 = length // 4
    for i in range(length4):
        i4 = i * 4
        k = (data[i4] & 0xFF) + ((data[i4 + 1] & 0xFF) << 8) + \
            ((data[i4 + 2] & 0xFF) << 16) + ((data[i4 + 3] & 0xFF) << 24)
        k = _i32(k * m)
        k = _i32(k ^ ((k & _I32) >> r))
        k = _i32(k * m)
        h = _i32(h * m)
        h = _i32(h ^ k)
    rem = length % 4
    base = length & ~3
    if rem == 3:
        h = _i32(h ^ ((data[base + 2] & 0xFF) << 16))
    if rem >= 2:
        h = _i32(h ^ ((data[base + 1] & 0xFF) << 8))
    if rem >= 1:
        h = _i32(h ^ (data[base] & 0xFF))
        h = _i32(h * m)
    h = _i32(h ^ ((h & _I32) >> 13))
    h = _i32(h * m)
    h = _i32(h ^ ((h & _I32) >> 15))
    return h


def java_string_hash(s: str) -> int:
    """Java String.hashCode, exact."""
    h = 0
    for ch in s:
        h = _i32(h * 31 + ord(ch))
    return h


def java_bytes_hash(data: bytes) -> int:
    """Java Arrays.hashCode(byte[]), exact (signed bytes)."""
    h = 1
    for b in data:
        sb = b - 256 if b >= 128 else b
        h = _i32(h * 31 + sb)
    return h


class PartitionFunction:
    name = ""

    def __init__(self, num_partitions: int):
        assert num_partitions > 0, "Number of partitions must be > 0"
        self.num_partitions = num_partitions

    def get_partition(self, value) -> int:
        raise NotImplementedError

    def __str__(self):
        return self.name


class MurmurPartitionFunction(PartitionFunction):
    name = "Murmur"

    def get_partition(self, value) -> int:
        s = value if isinstance(value, str) else str(value)
        return (murmur2(s.encode("utf-8")) & 0x7FFFFFFF) % \
            self.num_partitions


class ModuloPartitionFunction(PartitionFunction):
    name = "Modulo"

    def get_partition(self, value) -> int:
        # parity: ModuloPartitionFunction — integer value % N (Java %
        # keeps the dividend's sign; ids here are parsed longs)
        v = int(value)
        r = abs(v) % self.num_partitions
        return -r if v < 0 else r


class HashCodePartitionFunction(PartitionFunction):
    name = "HashCode"

    def get_partition(self, value) -> int:
        h = java_string_hash(value) if isinstance(value, str) \
            else _i32(int(value))
        return abs(h) % self.num_partitions


class ByteArrayPartitionFunction(PartitionFunction):
    name = "ByteArray"

    def get_partition(self, value) -> int:
        s = value if isinstance(value, str) else str(value)
        return abs(java_bytes_hash(s.encode("utf-8"))) % self.num_partitions


_FUNCTIONS = {
    "murmur": MurmurPartitionFunction,
    "modulo": ModuloPartitionFunction,
    "hashcode": HashCodePartitionFunction,
    "bytearray": ByteArrayPartitionFunction,
}


def make_partition_function(name: str, num_partitions: int
                            ) -> PartitionFunction:
    """Parity: PartitionFunctionFactory.getPartitionFunction."""
    cls = _FUNCTIONS.get(name.lower())
    if cls is None:
        raise ValueError(f"unknown partition function {name}")
    return cls(num_partitions)


class ColumnPartitionConfig:
    """Per-column partitioning in the table config (parity:
    SegmentPartitionConfig entries)."""

    def __init__(self, function_name: str, num_partitions: int):
        self.function_name = function_name
        self.num_partitions = num_partitions

    def to_json(self) -> dict:
        return {"functionName": self.function_name,
                "numPartitions": self.num_partitions}

    @classmethod
    def from_json(cls, d: dict) -> "ColumnPartitionConfig":
        return cls(d["functionName"], int(d["numPartitions"]))


def coerce_partition_value(np_dtype, value):
    """Canonical hashing representation for one partition-column value.

    BOTH the segment builder and the query-side pruners must hash the
    same string for the same logical value (str(np.float32(0.1)) is
    '0.1' but str(float(np.float32(0.1))) is '0.10000000149011612'), so
    everything funnels through the column's numpy scalar type — the same
    normalization the bloom-filter key uses.
    """
    if np_dtype is None:
        return value
    try:
        if np_dtype.kind in "iu":
            return np_dtype.type(int(str(value)))
        if np_dtype.kind == "f":
            return np_dtype.type(float(value))
    except (ValueError, OverflowError):
        pass
    return value


def partition_of_value(function_name: str, num_partitions: int,
                       np_dtype, value) -> int:
    """Shared build/query partition mapping (single source of truth for
    the coercion + hash, used by the creator and both pruners)."""
    fn = make_partition_function(function_name, num_partitions)
    return fn.get_partition(coerce_partition_value(np_dtype, value))
