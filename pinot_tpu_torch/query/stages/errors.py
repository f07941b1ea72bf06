"""Typed multi-stage errors (copy of pinot_tpu/query/stages/errors.py).

A StageCompileError is a property of the QUERY against the current
schemas/data contracts (unknown dim table, non-integer join keys,
duplicate dim join keys, window sum overflow): the broker surfaces it as
a 4xx-class error code — clients must not retry — and the server stamps
it as a structured DataTable metadata marker
(common/datatable.STAGE_ERROR_KEY) so classification never depends on
exception message wording.
"""
from __future__ import annotations

#: errorCode the broker attaches to stage compile errors (4xx class —
#: distinct from 425 server faults and 503 overload sheds)
STAGE_COMPILE_ERROR_CODE = 422


class StageCompileError(ValueError):
    """The multi-stage query cannot execute against the current tables —
    a deterministic property of the query, never a transient fault."""


class ExchangeError(RuntimeError):
    """A stage-1 block could not be fetched (expired, peer gone) — a
    transient execution fault, retriable like any server error."""


def stage_error_datatable(request_id, kind: str, message: str):
    """Typed stage-error reply: STAGE_ERROR_KEY carries the machine
    kind, exceptions the human message."""
    from pinot_tpu_torch.common.datatable import DataTable, STAGE_ERROR_KEY
    dt = DataTable()
    dt.metadata["requestId"] = str(request_id)
    dt.metadata[STAGE_ERROR_KEY] = kind
    dt.exceptions.append(f"StageCompileError: {message}")
    return dt

