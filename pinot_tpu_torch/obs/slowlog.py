"""Sampling JSONL slow-query log.

Copy of pinot_tpu/obs/slowlog.py (JAX-free), its imports rebased onto
pinot_tpu_torch.

Parity: the reference broker logs every query's summary line
(BaseBrokerRequestHandler's requestId/table/timeMs log) and operators
grep for the slow ones; here the broker writes a structured JSONL
record for queries over a latency threshold, with deterministic
sampling so a pathological workload can't turn the log into the
bottleneck it is diagnosing.

Config (constructor args, env-overridable via `from_env`):

- ``PINOT_TPU_SLOWLOG``          — log file path (enables the log)
- ``PINOT_TPU_SLOWLOG_MS``       — threshold, default 500 ms
- ``PINOT_TPU_SLOWLOG_SAMPLE``   — fraction of over-threshold queries
  kept, default 1.0; sampling is counter-based (`floor(n*rate)`
  crossings), so it is deterministic and exactly rate-proportional.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional


class SlowQueryLog:
    def __init__(self, path: str, threshold_ms: float = 500.0,
                 sample_rate: float = 1.0):
        self.path = path
        self.threshold_ms = float(threshold_ms)
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self._lock = threading.Lock()       # sampling counters only
        self._io_lock = threading.Lock()    # the append handle
        self._fh = None                     # opened lazily, kept open
        self._seen = 0          # queries over threshold (sampling input)
        self._logged = 0

    @classmethod
    def from_env(cls) -> Optional["SlowQueryLog"]:
        path = os.environ.get("PINOT_TPU_SLOWLOG")
        if not path:
            return None
        return cls(path,
                   threshold_ms=float(
                       os.environ.get("PINOT_TPU_SLOWLOG_MS", "500")),
                   sample_rate=float(
                       os.environ.get("PINOT_TPU_SLOWLOG_SAMPLE", "1")))

    def _sampled(self) -> bool:
        """Counter-based sampling: keep the n-th slow query iff
        floor(n*rate) > floor((n-1)*rate) — deterministic, and over any
        window the kept fraction is exactly the configured rate."""
        self._seen += 1
        n = self._seen
        return math.floor(n * self.sample_rate) > \
            math.floor((n - 1) * self.sample_rate)

    def maybe_log(self, time_used_ms: float, entry: dict) -> bool:
        """Append `entry` when the query is slow AND sampled. Returns
        whether a record was written.

        The sampling decision and the write hold different locks: a
        slow-query storm (exactly what this log diagnoses) must not
        serialize every caller thread's _finish on disk I/O just to
        bump a counter, and the record is formatted outside both."""
        if time_used_ms < self.threshold_ms:
            return False
        with self._lock:
            if not self._sampled():
                return False
            self._logged += 1
        record = {"ts": round(time.time(), 3),
                  "timeUsedMs": round(time_used_ms, 3)}
        record.update(entry)
        line = json.dumps(record) + "\n"
        with self._io_lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")  # tpulint: disable=lock-blocking -- lazy one-shot open of the append handle; steady-state logging only pays the in-memory write under this lock
            self._fh.write(line)
            self._fh.flush()
        return True

    def close(self) -> None:
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def stats(self) -> dict:
        with self._lock:
            return {"path": self.path, "thresholdMs": self.threshold_ms,
                    "sampleRate": self.sample_rate,
                    "slowSeen": self._seen, "logged": self._logged}
