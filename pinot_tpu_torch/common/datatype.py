"""Column data types and their host/device dtype mappings.

Parity: org.apache.pinot.common.data.FieldSpec.DataType
(reference: pinot-common/src/main/java/org/apache/pinot/common/data/FieldSpec.java).

TPU note: device compute runs on int32/float32 (TPU-native widths). LONG and
DOUBLE columns keep full-width numpy arrays host-side for exact oracle-grade
results; on-device copies are downcast unless x64 is enabled (tests run on the
CPU backend with x64 on, so correctness tests are exact).
"""
from __future__ import annotations

import enum

import numpy as np


class DataType(enum.Enum):
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOLEAN = "BOOLEAN"
    STRING = "STRING"
    BYTES = "BYTES"
    # dense embedding column: each row is a fixed-dimension float32
    # vector (FieldSpec.vector_dimension). Stored as a packed [n, dim]
    # forward block; served by the batched top-k similarity kernels.
    # The index SPI's TPU-native family (SURVEY §2.5) — no 2019-era
    # Pinot analogue.
    VECTOR = "VECTOR"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def np_dtype(self):
        """Host-side storage dtype (exact width)."""
        return _NP_DTYPES[self]

    @property
    def device_dtype(self):
        """Device compute dtype (TPU-native width)."""
        return _DEVICE_DTYPES[self]

    @property
    def default_null_value(self):
        """Default padding value for missing fields.

        Parity: FieldSpec.getDefaultNullValue (dimension defaults; metrics
        default to 0).
        """
        return _NULL_DIM[self]

    def convert(self, value):
        """Coerce a raw ingestion value to this type's python value."""
        if value is None:
            return self.default_null_value
        if self is DataType.INT:
            return int(value)
        if self is DataType.LONG:
            return int(value)
        if self is DataType.FLOAT:
            return float(value)
        if self is DataType.DOUBLE:
            return float(value)
        if self is DataType.BOOLEAN:
            # reference stores booleans as strings "true"/"false"
            if isinstance(value, bool):
                return "true" if value else "false"
            return str(value)
        if self is DataType.STRING:
            return str(value)
        if self is DataType.BYTES:
            if isinstance(value, (bytes, bytearray)):
                return bytes(value)
            return bytes.fromhex(str(value))
        if self is DataType.VECTOR:
            # dimension validation lives in FieldSpec.convert (the field
            # knows its dimension); this is the dimension-less coercion
            return np.asarray(value, dtype=np.float32)
        raise ValueError(f"unsupported type {self}")


_NUMERIC = {DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE}

_NP_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.BOOLEAN: np.dtype(object),
    DataType.STRING: np.dtype(object),
    DataType.BYTES: np.dtype(object),
    DataType.VECTOR: np.dtype(np.float32),
}

_DEVICE_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    # non-numeric columns live on device as dictionary ids only
    DataType.BOOLEAN: np.dtype(np.int32),
    DataType.STRING: np.dtype(np.int32),
    DataType.BYTES: np.dtype(np.int32),
    DataType.VECTOR: np.dtype(np.float32),
}

_NULL_DIM = {
    DataType.INT: -(2**31) + 1,  # Integer.MIN_VALUE + 1? reference uses MIN_VALUE
    DataType.LONG: -(2**63) + 1,
    DataType.FLOAT: float(np.finfo(np.float32).min),
    DataType.DOUBLE: float(np.finfo(np.float64).min),
    DataType.BOOLEAN: "null",
    DataType.STRING: "null",
    DataType.BYTES: b"",
    DataType.VECTOR: None,   # FieldSpec.convert substitutes a zero vector
}
