"""Table naming: raw name <-> type-suffixed physical table names.

Parity: pinot-common TableNameBuilder / CommonConstants.Helix.TableType —
"myTable" resolves to physical tables "myTable_OFFLINE" / "myTable_REALTIME";
hybrid tables have both.
"""
from __future__ import annotations

OFFLINE_SUFFIX = "_OFFLINE"
REALTIME_SUFFIX = "_REALTIME"


def offline_table(raw: str) -> str:
    return raw if raw.endswith(OFFLINE_SUFFIX) else raw + OFFLINE_SUFFIX


def realtime_table(raw: str) -> str:
    return raw if raw.endswith(REALTIME_SUFFIX) else raw + REALTIME_SUFFIX


def raw_table(name: str) -> str:
    for sfx in (OFFLINE_SUFFIX, REALTIME_SUFFIX):
        if name.endswith(sfx):
            return name[: -len(sfx)]
    return name


def table_type(name: str) -> str:
    if name.endswith(OFFLINE_SUFFIX):
        return "OFFLINE"
    if name.endswith(REALTIME_SUFFIX):
        return "REALTIME"
    return "NONE"
