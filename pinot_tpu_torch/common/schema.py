"""Table schema model: field specs for dimensions, metrics and time columns.

Parity: pinot-common/src/main/java/org/apache/pinot/common/data/
{Schema,FieldSpec,DimensionFieldSpec,MetricFieldSpec,TimeFieldSpec,
DateTimeFieldSpec}.java — same JSON shape, same semantics (single/multi value,
default null values, time granularity).
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional

from pinot_tpu_torch.common.datatype import DataType


class FieldType(enum.Enum):
    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    TIME = "TIME"
    DATE_TIME = "DATE_TIME"


class TimeUnit(enum.Enum):
    MILLISECONDS = 1
    SECONDS = 1000
    MINUTES = 60_000
    HOURS = 3_600_000
    DAYS = 86_400_000

    def to_millis(self, value: int) -> int:
        return int(value) * self.value


#: hard cap on VECTOR dimensions (1024 f32 lanes x 4 bytes = 4KB/row is
#: already generous; anything wider should be a modeling question, not a
#: silent multi-GB segment)
MAX_VECTOR_DIMENSION = 4096


@dataclasses.dataclass
class FieldSpec:
    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    default_null_value: object = None
    # TIME fields only:
    time_unit: Optional[TimeUnit] = None
    time_unit_size: int = 1
    # VECTOR fields only: fixed embedding dimension (every row carries
    # exactly this many float32 lanes; validated at controller
    # schema-create and again at segment build/ingest)
    vector_dimension: int = 0

    def __post_init__(self):
        if self.default_null_value is None:
            if self.field_type == FieldType.METRIC:
                self.default_null_value = 0 if self.data_type in (
                    DataType.INT, DataType.LONG) else 0.0
            else:
                self.default_null_value = self.data_type.default_null_value

    @property
    def is_numeric(self) -> bool:
        return self.data_type.is_numeric

    def convert(self, value):
        if self.data_type == DataType.VECTOR:
            import numpy as np
            if value is None:
                return np.zeros(self.vector_dimension, np.float32)
            arr = np.asarray(value, dtype=np.float32)
            if arr.shape != (self.vector_dimension,):
                raise ValueError(
                    f"column '{self.name}' expects a {self.vector_dimension}"
                    f"-dimension vector, got shape {arr.shape}")
            # NaN/Inf rejected at ingest: they would contaminate every
            # score tree they touch and poison trained IVF centroids
            if not np.isfinite(arr).all():
                raise ValueError(
                    f"column '{self.name}': NaN/Inf embedding values")
            return arr
        if value is None:
            return self.default_null_value
        return self.data_type.convert(value)

    def validate(self) -> None:
        """Structural validation (parity: Schema.validate — reject at
        controller schema-create, not at first segment build)."""
        if self.data_type == DataType.VECTOR:
            if self.field_type != FieldType.DIMENSION:
                raise ValueError(
                    f"VECTOR column '{self.name}' must be a DIMENSION "
                    f"field, not {self.field_type.value}")
            if not self.single_value:
                raise ValueError(
                    f"VECTOR column '{self.name}' must be single-value "
                    "(each row is ONE fixed-width embedding)")
            if not (0 < self.vector_dimension <= MAX_VECTOR_DIMENSION):
                raise ValueError(
                    f"VECTOR column '{self.name}' needs a dimension in "
                    f"[1, {MAX_VECTOR_DIMENSION}], got "
                    f"{self.vector_dimension}")
        elif self.vector_dimension:
            raise ValueError(
                f"column '{self.name}' carries vectorDimension but is "
                f"{self.data_type.value}, not VECTOR")

    def to_json(self) -> dict:
        default = self.default_null_value
        d = {
            "name": self.name,
            "dataType": self.data_type.value,
            "singleValueField": self.single_value,
        }
        if isinstance(default, bytes):
            # hex-encode like ColumnMetadata.to_json does for bytes
            d["defaultNullValueHex"] = default.hex()
        else:
            d["defaultNullValue"] = default
        if self.time_unit is not None:
            d["timeUnit"] = self.time_unit.name
            d["timeUnitSize"] = self.time_unit_size
        if self.data_type == DataType.VECTOR:
            d["vectorDimension"] = self.vector_dimension
        return d


def dimension(name: str, data_type: DataType, single_value: bool = True) -> FieldSpec:
    return FieldSpec(name, data_type, FieldType.DIMENSION, single_value)


def metric(name: str, data_type: DataType) -> FieldSpec:
    return FieldSpec(name, data_type, FieldType.METRIC)


def vector(name: str, dimension: int) -> FieldSpec:
    """Fixed-dimension float32 embedding column."""
    return FieldSpec(name, DataType.VECTOR, FieldType.DIMENSION,
                     vector_dimension=dimension)


def time_field(name: str, data_type: DataType, unit: TimeUnit = TimeUnit.DAYS,
               unit_size: int = 1) -> FieldSpec:
    return FieldSpec(name, data_type, FieldType.TIME, time_unit=unit,
                     time_unit_size=unit_size)


@dataclasses.dataclass
class Schema:
    schema_name: str
    fields: List[FieldSpec] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._by_name: Dict[str, FieldSpec] = {f.name: f for f in self.fields}

    # -- accessors ---------------------------------------------------------
    def field(self, name: str) -> FieldSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"column '{name}' not in schema '{self.schema_name}'")

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def dimension_names(self) -> List[str]:
        return [f.name for f in self.fields if f.field_type == FieldType.DIMENSION]

    @property
    def metric_names(self) -> List[str]:
        return [f.name for f in self.fields if f.field_type == FieldType.METRIC]

    @property
    def time_column(self) -> Optional[FieldSpec]:
        for f in self.fields:
            if f.field_type == FieldType.TIME:
                return f
        return None

    @property
    def vector_columns(self) -> List[str]:
        return [f.name for f in self.fields
                if f.data_type == DataType.VECTOR]

    def validate(self) -> None:
        """Per-field structural validation (VECTOR dimension bounds)."""
        for f in self.fields:
            f.validate()

    # -- serde -------------------------------------------------------------
    def to_json(self) -> dict:
        out = {"schemaName": self.schema_name, "dimensionFieldSpecs": [],
               "metricFieldSpecs": [], "dateTimeFieldSpecs": []}
        for f in self.fields:
            if f.field_type == FieldType.DIMENSION:
                out["dimensionFieldSpecs"].append(f.to_json())
            elif f.field_type == FieldType.METRIC:
                out["metricFieldSpecs"].append(f.to_json())
            elif f.field_type == FieldType.TIME:
                out["timeFieldSpec"] = {"incomingGranularitySpec": f.to_json()}
            else:
                out["dateTimeFieldSpecs"].append(f.to_json())
        return out

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @classmethod
    def from_json(cls, d: dict) -> "Schema":
        fields: List[FieldSpec] = []
        def _default(fs):
            if "defaultNullValueHex" in fs:
                return bytes.fromhex(fs["defaultNullValueHex"])
            return fs.get("defaultNullValue")

        for fs in d.get("dimensionFieldSpecs", []) or []:
            fields.append(FieldSpec(fs["name"], DataType(fs["dataType"]),
                                    FieldType.DIMENSION,
                                    fs.get("singleValueField", True),
                                    _default(fs),
                                    vector_dimension=fs.get(
                                        "vectorDimension", 0)))
        for fs in d.get("metricFieldSpecs", []) or []:
            fields.append(FieldSpec(fs["name"], DataType(fs["dataType"]),
                                    FieldType.METRIC,
                                    default_null_value=_default(fs)))
        tf = d.get("timeFieldSpec")
        if tf:
            g = tf.get("incomingGranularitySpec", tf)
            fields.append(FieldSpec(
                g["name"], DataType(g["dataType"]), FieldType.TIME,
                time_unit=TimeUnit[g.get("timeUnit", "DAYS")],
                time_unit_size=g.get("timeUnitSize", 1)))
        for fs in d.get("dateTimeFieldSpecs", []) or []:
            fields.append(FieldSpec(fs["name"], DataType(fs["dataType"]),
                                    FieldType.DATE_TIME))
        return cls(d["schemaName"], fields)

    @classmethod
    def from_json_str(cls, s: str) -> "Schema":
        return cls.from_json(json.loads(s))
