"""Record transformer chain: raw reader rows → schema-conformant rows.

Parity: pinot-core/.../core/data/recordtransformer/ — CompoundTransformer
composing ExpressionTransformer (derived columns), TimeTransformer
(incoming → schema time granularity), DataTypeTransformer (type coercion,
SV/MV normalization), NullValueTransformer (default fill) and
SanitationTransformer (string cleanup), in that order.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common import expression as expr_mod
from pinot_tpu_torch.common.schema import FieldType, Schema, TimeUnit

MAX_STRING_LENGTH = 512          # parity: SanitationTransformer trim length


class RecordTransformer:
    def transform(self, row: dict) -> Optional[dict]:
        """Returns the transformed row, or None to drop the record."""
        raise NotImplementedError


class ExpressionTransformer(RecordTransformer):
    """Derive columns from transform expressions over other fields.

    Parity: ExpressionTransformer / FunctionExpressionEvaluator — the
    reference evaluates Groovy-ish expressions per record; here the shared
    transform-function registry (common/expression.py) is used.
    """

    def __init__(self, expressions: Dict[str, str]):
        self.expressions = {col: expr_mod.parse_expression(text)
                            for col, text in expressions.items()}

    def transform(self, row: dict) -> Optional[dict]:
        for out_col, expr in self.expressions.items():
            if row.get(out_col) is not None:
                continue        # already provided by the source
            try:
                val = expr_mod.evaluate(
                    expr, lambda c: np.asarray([row[c]]))
                if isinstance(val, np.ndarray):
                    val = val.ravel()[0]
                row[out_col] = val.item() if hasattr(val, "item") else val
            except (KeyError, TypeError, ValueError):
                row[out_col] = None
        return row


class TimeTransformer(RecordTransformer):
    """Convert the incoming time value to the schema's time unit."""

    def __init__(self, schema: Schema,
                 incoming_unit: Optional[TimeUnit] = None):
        tc = schema.time_column
        self.column = tc.name if tc else None
        self.out_ms = (tc.time_unit.value * max(tc.time_unit_size, 1)
                       ) if tc and tc.time_unit else None
        self.in_unit = incoming_unit

    def transform(self, row: dict) -> Optional[dict]:
        if self.column is None or self.in_unit is None or \
                self.out_ms is None or self.in_unit.value == self.out_ms:
            return row
        v = row.get(self.column)
        if v is None:
            return row
        ms = self.in_unit.to_millis(int(v))
        row[self.column] = int(ms // self.out_ms)
        return row


class DataTypeTransformer(RecordTransformer):
    """Coerce every schema column to its declared type; normalize SV/MV
    shapes (scalars wrapped into lists for MV fields, singleton lists
    unwrapped for SV fields)."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def transform(self, row: dict) -> Optional[dict]:
        from pinot_tpu_torch.common.datatype import DataType
        for f in self.schema.fields:
            v = row.get(f.name)
            if v is None:
                continue
            if f.data_type == DataType.VECTOR:
                # the list payload IS the embedding — never unwrap it
                # like an accidentally-listed scalar
                row[f.name] = f.convert(v)
            elif f.single_value:
                if isinstance(v, (list, tuple)):
                    v = v[0] if v else None
                row[f.name] = None if v is None else f.convert(v)
            else:
                vs = v if isinstance(v, (list, tuple)) else [v]
                row[f.name] = [f.convert(x) for x in vs if x is not None]
        return row


class NullValueTransformer(RecordTransformer):
    """Fill missing/None values with the field's default null value."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def transform(self, row: dict) -> Optional[dict]:
        for f in self.schema.fields:
            v = row.get(f.name)
            if f.single_value:
                if v is None:
                    row[f.name] = f.default_null_value
            else:
                if not v:
                    row[f.name] = [f.default_null_value]
        return row


class SanitationTransformer(RecordTransformer):
    """Clean string values: strip NUL characters, clamp length."""

    def __init__(self, schema: Schema,
                 max_length: int = MAX_STRING_LENGTH):
        self.schema = schema
        self.max_length = max_length

    def _clean(self, v):
        if isinstance(v, str):
            if "\x00" in v:
                v = v.replace("\x00", "")
            if len(v) > self.max_length:
                v = v[: self.max_length]
        return v

    def transform(self, row: dict) -> Optional[dict]:
        for f in self.schema.fields:
            v = row.get(f.name)
            if isinstance(v, list):
                row[f.name] = [self._clean(x) for x in v]
            else:
                row[f.name] = self._clean(v)
        return row


class CompoundTransformer(RecordTransformer):
    """The standard chain, in the reference's order."""

    def __init__(self, schema: Schema,
                 expressions: Optional[Dict[str, str]] = None,
                 incoming_time_unit: Optional[TimeUnit] = None):
        self.chain: List[RecordTransformer] = []
        if expressions:
            self.chain.append(ExpressionTransformer(expressions))
        self.chain.append(TimeTransformer(schema, incoming_time_unit))
        self.chain.append(DataTypeTransformer(schema))
        self.chain.append(NullValueTransformer(schema))
        self.chain.append(SanitationTransformer(schema))

    def transform(self, row: dict) -> Optional[dict]:
        for t in self.chain:
            row = t.transform(row)
            if row is None:
                return None
        return row
