"""Time-unit arithmetic shared by retention and time-boundary logic.

Parity: java TimeUnit conversions as used in RetentionManager and
HelixExternalViewBasedTimeBoundaryService.
"""
from __future__ import annotations

UNIT_MS = {
    "MILLISECONDS": 1, "SECONDS": 1000, "MINUTES": 60_000,
    "HOURS": 3_600_000, "DAYS": 86_400_000,
}


def unit_ms(unit, default: str = "DAYS") -> int:
    return UNIT_MS.get((unit or default).upper(), UNIT_MS[default])
