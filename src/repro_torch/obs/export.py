"""repro_torch.obs.export — render a Recorder snapshot for external consumers.

Two formats, both stdlib-only:

* :func:`prometheus_text` — Prometheus text exposition (v0.0.4): counters
  as ``<name>_total``, gauges plain, histograms as cumulative ``_bucket``
  series with ``le`` labels plus ``_sum``/``_count``.  Metric names have
  dots rewritten to underscores (``engine.tick`` -> ``engine_tick``);
  label values are escaped per the spec.
* :func:`spans_jsonl` / :func:`render_snapshot` — JSONL span dump and a
  compact human-readable table used by ``scripts/obs_top.py``.

These functions read a recorder (or a ``snapshot()`` dict fetched over
the gateway METRICS verb) and never mutate it.
"""

from __future__ import annotations

import json
import math

from repro_torch.obs.core import Recorder, bucket_le


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_value(v) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _prom_labels(labels: tuple, extra: tuple = ()) -> str:
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(
            k,
            str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n"),
        )
        for k, v in items
    )
    return "{" + body + "}"


def prometheus_text(rec: Recorder) -> str:
    """Render every series of ``rec`` in Prometheus text format."""
    lines: list[str] = []
    with rec._lock:
        counters = sorted(rec._counters.items())
        gauges = sorted(rec._gauges.items())
        hists = sorted(rec._hists.items())

    seen_types: set = set()

    for (name, labels), c in counters:
        pn = _prom_name(name) + "_total"
        if pn not in seen_types:
            seen_types.add(pn)
            lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn}{_prom_labels(labels)} {_prom_value(c.value)}")

    for (name, labels), g in gauges:
        pn = _prom_name(name)
        if pn not in seen_types:
            seen_types.add(pn)
            lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn}{_prom_labels(labels)} {_prom_value(g.value)}")

    for (name, labels), h in hists:
        pn = _prom_name(name)
        if pn not in seen_types:
            seen_types.add(pn)
            lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for i, n in enumerate(h.buckets[:-1]):  # last bucket == the +Inf line
            if n == 0:
                continue
            cum += n
            le = _prom_value(bucket_le(i))
            lines.append(
                f"{pn}_bucket{_prom_labels(labels, (('le', le),))} {cum}"
            )
        lines.append(
            f"{pn}_bucket{_prom_labels(labels, (('le', '+Inf'),))} {h.count}"
        )
        lines.append(f"{pn}_sum{_prom_labels(labels)} {_prom_value(h.sum)}")
        lines.append(f"{pn}_count{_prom_labels(labels)} {h.count}")

    lines.append(f"obs_spans_dropped_total {rec.spans_dropped}")
    return "\n".join(lines) + "\n"


def spans_jsonl(rec: Recorder, name: str | None = None) -> str:
    """Span ring as a JSON Lines string (oldest first)."""
    return "".join(
        json.dumps(s.to_dict(), sort_keys=True) + "\n" for s in rec.spans(name)
    )


def render_snapshot(snap: dict, width: int = 78) -> str:
    """Compact console table from a ``Recorder.snapshot()`` dict — the
    ``scripts/obs_top.py`` body.  Works on the JSON fetched over the
    gateway METRICS verb (no live Recorder needed)."""
    lines: list[str] = []

    def sec(title: str) -> None:
        lines.append(title)
        lines.append("-" * min(width, len(title)))

    if not snap.get("enabled", False):
        return "observability disabled (obs.enable() not called)\n"

    sec(f"counters  (uptime {snap.get('uptime_s', 0.0):.1f}s)")
    for key in sorted(snap.get("counters", {})):
        lines.append(f"  {key:<48} {snap['counters'][key]}")
    if snap.get("gauges"):
        sec("gauges")
        for key in sorted(snap["gauges"]):
            lines.append(f"  {key:<48} {snap['gauges'][key]}")
    if snap.get("histograms"):
        sec("histograms  (count / mean / p50<= / p99<= / max)")
        for key in sorted(snap["histograms"]):
            h = snap["histograms"][key]
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            lines.append(
                f"  {key:<40} {h['count']:>7} {mean:>10.3g}"
                f" {h['p50_le']:>10.3g} {h['p99_le']:>10.3g}"
                f" {(h['max'] if h['max'] is not None else 0.0):>10.3g}"
            )
    lines.append(
        f"spans: {snap.get('spans', 0)}/{snap.get('span_capacity', 0)}"
        f"  dropped: {snap.get('spans_dropped', 0)}"
    )
    return "\n".join(lines) + "\n"
