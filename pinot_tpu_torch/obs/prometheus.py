"""Prometheus text exposition for a MetricsRegistry.

Copy of pinot_tpu/obs/prometheus.py (JAX-free), its imports rebased onto
pinot_tpu_torch.

Parity: the reference exports its Yammer registry through
JmxReporterMetricsRegistryRegistrationListener (operators scrape JMX →
Prometheus); PAPERS.md's Monarch/Prometheus lineage is the pull model
this module implements directly — every component (broker, server,
controller) serves `GET /metrics` in the text exposition format
(version 0.0.4).

Naming: ``pinot_<component>_<snake_case_metric>`` with the registry's
table/server suffix emitted as a ``table`` label (the reference's
addMeteredTableValue table-suffix convention becomes a proper label).
Meters render as counters (``_total``), gauges as gauges, timers as
histograms over the registry's bounded log-scale millisecond buckets
plus ``_sum``/``_count``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from pinot_tpu_torch.common.metrics import MetricsRegistry, Timer

_INVALID = re.compile(r"[^a-zA-Z0-9_]")
_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def _snake(name: str) -> str:
    return _INVALID.sub("_", _CAMEL.sub("_", name)).lower()


def _split_key(key: str) -> Tuple[Optional[str], str]:
    """Registry keys are ``<table>.<metric>`` or bare ``<metric>``
    (MetricsRegistry._get); metric names never contain dots."""
    if "." in key:
        table, name = key.rsplit(".", 1)
        return table, name
    return None, key


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_pairs(table: Optional[str]) -> List[str]:
    """Label assignments for a registry table suffix. A plain suffix is
    the reference's table-level convention (→ ``table`` label); a
    ``<table>|<kind>`` suffix (the residency gauges) splits into
    ``table`` + ``kind`` labels, empty parts omitted. A ``tier:<tier>``
    kind part (the residency manager's per-tier twins) renders as a
    ``tier`` label instead of a kind."""
    if table is None:
        return []
    if "|" in table:
        tbl, kind = table.split("|", 1)
        pairs = []
        if tbl:
            pairs.append(f'table="{_escape_label(tbl)}"')
        if kind.startswith("tier:"):
            pairs.append(f'tier="{_escape_label(kind[5:])}"')
        elif kind:
            pairs.append(f'kind="{_escape_label(kind)}"')
        return pairs
    return [f'table="{_escape_label(table)}"']


def _labels(table: Optional[str]) -> str:
    pairs = _label_pairs(table)
    return "{%s}" % ",".join(pairs) if pairs else ""


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: MetricsRegistry,
                      namespace: str = "pinot") -> str:
    """The full registry as Prometheus text exposition."""
    component = _snake(registry.component or "component")
    prefix = f"{namespace}_{component}"
    meters, gauges, timers = registry.metric_maps()

    # group series sharing a metric name under ONE # TYPE header
    by_name: Dict[str, dict] = {}

    def series(name: str, mtype: str):
        e = by_name.get(name)
        if e is None:
            e = by_name[name] = {"type": mtype, "lines": []}
        return e["lines"]

    for key, m in sorted(meters.items()):
        table, name = _split_key(key)
        full = f"{prefix}_{_snake(name)}_total"
        series(full, "counter").append(
            f"{full}{_labels(table)} {m.count}")
    for key, g in sorted(gauges.items()):
        table, name = _split_key(key)
        full = f"{prefix}_{_snake(name)}"
        series(full, "gauge").append(
            f"{full}{_labels(table)} {_fmt(float(g.value))}")
    for key, t in sorted(timers.items()):
        table, name = _split_key(key)
        full = f"{prefix}_{_snake(name)}_ms"
        lines = series(full, "histogram")
        pairs = _label_pairs(table)
        tl = "".join(p + "," for p in pairs)
        cumulative = 0
        counts = t.bucket_counts()          # len(BOUNDS) + 1 (overflow)
        bounds = [_fmt(b) for b in Timer.BUCKET_BOUNDS_MS] + ["+Inf"]
        for le, n in zip(bounds, counts):
            cumulative += n
            lines.append(f'{full}_bucket{{{tl}le="{le}"}} {cumulative}')
        suffix = _labels(table)
        lines.append(f"{full}_sum{suffix} {_fmt(round(t.total_ms, 3))}")
        lines.append(f"{full}_count{suffix} {t.count}")

    out: List[str] = []
    for name, entry in by_name.items():
        out.append(f"# TYPE {name} {entry['type']}")
        out.extend(entry["lines"])
    return "\n".join(out) + ("\n" if out else "")


#: the content type Prometheus scrapers expect for 0.0.4 exposition
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
