"""Low-level-consumer segment naming.

Parity: pinot-common LLCSegmentName — `{table}__{partition}__{sequence}`
(the reference appends a creation timestamp; offsets and ordering only ever
use table/partition/sequence, so the name here is the minimal deterministic
triple — nicer for tests and idempotent repair).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class LLCSegmentName:
    table: str          # raw table name (no type suffix)
    partition: int
    sequence: int

    @property
    def name(self) -> str:
        return f"{self.table}__{self.partition}__{self.sequence}"

    def next(self) -> "LLCSegmentName":
        return LLCSegmentName(self.table, self.partition, self.sequence + 1)

    @classmethod
    def parse(cls, name: str) -> "LLCSegmentName":
        parts = name.split("__")
        if len(parts) < 3:
            raise ValueError(f"not an LLC segment name: {name!r}")
        return cls(parts[0], int(parts[1]), int(parts[2]))

    @classmethod
    def is_llc(cls, name: str) -> bool:
        try:
            cls.parse(name)
            return True
        except ValueError:
            return False


def latest_llc_sequences(names) -> dict:
    """partition -> max sequence over the LLC names in `names`. The
    newest sequence per partition anchors the successor / restart-
    offset chain, so retention and merge generation must never touch
    it — shared here so both exemptions stay in sync."""
    latest: dict = {}
    for name in names:
        if not LLCSegmentName.is_llc(name):
            continue
        llc = LLCSegmentName.parse(name)
        latest[llc.partition] = max(latest.get(llc.partition, -1),
                                    llc.sequence)
    return latest
