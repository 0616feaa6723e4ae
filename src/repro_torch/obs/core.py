"""repro_torch.obs core — counters, gauges, histograms, spans (DESIGN.md §15).

One process-global recorder slot, ``CURRENT``, holds either the no-op
:data:`NULL` recorder (the default — observability off) or a live
:class:`Recorder`.  Instrumented call sites across the engine, gateway,
comm and session layers read the slot fresh each time::

    from repro_torch.obs import core as obs

    rec = obs.CURRENT
    if rec.enabled:
        rec.add("engine.spills")              # counter
    with rec.span("engine.tick") as sp:       # timed span -> ring buffer
        ...
        sp.set(slots=n)                       # fields attached at exit

Disabled cost: ``obs.CURRENT`` is one module-attribute lookup and
``rec.enabled`` is a class attribute (False on :class:`NullRecorder`), so
an instrumented hot path that never fires costs a lookup and a branch.
The no-op recorder's methods allocate nothing — ``NULL.span()`` returns a
process-wide singleton — which tests/test_obs.py pins with a gc object
census.

Metric model (stdlib only, no deps):

* **Counter** — monotone float/int ``add``.
* **Gauge** — last-write-wins ``set``.
* **Histogram** — fixed log2 buckets (``HIST_BUCKETS`` of them, bucket
  ``i`` spanning ``[2**(HIST_LO_EXP+i-1), 2**(HIST_LO_EXP+i))``) plus
  exact ``count``/``sum``/``min``/``max``.  The hot path is one
  ``math.frexp``, one clamp and five scalar updates — no per-sample
  storage, so an instrumented loop never grows memory.
* **Span** — a context manager recording ``(name, start, duration,
  depth, parent, labels)`` into a bounded ring (``deque(maxlen=...)``,
  drop-oldest with a counted ``spans_dropped``).  Span exit also feeds
  the duration into the *label-free* histogram of the same name: spans
  may carry unbounded labels (tenant ids, round indices), metrics must
  not (the §15 cardinality rule), so the labels stay on the ring record.

Label cardinality rule: metric labels (``add``/``gauge``/``observe``
kwargs) must come from bounded sets — priority class, RPC verb, frame
type, backend, lane.  Tenant ids and round indices belong on spans.

The never-touch-numerics invariant: nothing in this module imports jax
or numpy, and no instrumented call site feeds a recorded value back into
computation — scripts/smoke_obs.py CI-gates that obs-on trajectories are
bit-identical to obs-off.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Any

# the sanctioned clocks: migration rule 8 (scripts/check_api_migration.py)
# confines raw time.perf_counter()/time.monotonic() instrumentation in
# src/repro/{serve_fednl,gateway,comm} to these aliases
now = time.perf_counter
monotonic = time.monotonic

# --- histogram geometry (pinned by tests/test_obs.py) ----------------------

HIST_BUCKETS = 64
HIST_LO_EXP = -30  # bucket 0 upper bound = 2**HIST_LO_EXP (~9.3e-10)


def bucket_index(value: float) -> int:
    """Log2 bucket of ``value``: the index ``i`` with
    ``2**(HIST_LO_EXP+i-1) <= value < 2**(HIST_LO_EXP+i)``, clamped to
    ``[0, HIST_BUCKETS)``; values <= 0 land in bucket 0."""
    if value <= 0.0:
        return 0
    i = math.frexp(value)[1] - HIST_LO_EXP  # frexp: 2**(e-1) <= v < 2**e
    if i < 0:
        return 0
    if i >= HIST_BUCKETS:
        return HIST_BUCKETS - 1
    return i


def bucket_le(i: int) -> float:
    """Upper bound of bucket ``i`` (inf for the overflow bucket)."""
    if i >= HIST_BUCKETS - 1:
        return math.inf
    return 2.0 ** (HIST_LO_EXP + i)


# --- instruments -----------------------------------------------------------


class Counter:
    """Monotone counter (one (name, labels) series)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins gauge (one (name, labels) series)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed log2-bucket histogram (module docstring); O(1) per sample."""

    __slots__ = ("name", "labels", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str, labels: tuple):
        self.name = name
        self.labels = labels
        self.buckets = [0] * HIST_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.buckets[bucket_index(value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def quantile_le(self, q: float) -> float:
        """Upper bound of the bucket holding the ``q``-quantile sample —
        a factor-2-resolution percentile (log buckets; the exact mean is
        ``sum / count``)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                return bucket_le(i)
        return bucket_le(HIST_BUCKETS - 1)  # pragma: no cover - q > 1


class SpanRecord:
    """One completed span in the ring buffer (JSONL-serializable)."""

    __slots__ = ("name", "start_s", "dur_s", "depth", "parent", "labels")

    def __init__(self, name, start_s, dur_s, depth, parent, labels):
        self.name = name
        self.start_s = start_s
        self.dur_s = dur_s
        self.depth = depth
        self.parent = parent
        self.labels = labels

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_s": self.start_s,
            "dur_s": self.dur_s,
            "depth": self.depth,
            "parent": self.parent,
            "labels": self.labels,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SpanRecord":
        return cls(
            d["name"], d["start_s"], d["dur_s"], d["depth"], d["parent"],
            dict(d["labels"]),
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, SpanRecord) and self.to_dict() == other.to_dict()

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"SpanRecord({self.to_dict()!r})"


class _Span:
    """Live span context manager (created by :meth:`Recorder.span`)."""

    __slots__ = ("_rec", "name", "labels", "_t0", "_depth", "_parent")

    def __init__(self, rec: "Recorder", name: str, labels: dict):
        self._rec = rec
        self.name = name
        self.labels = labels

    def set(self, **fields) -> "_Span":
        """Attach fields to the span record (merged into its labels)."""
        self.labels.update(fields)
        return self

    def __enter__(self) -> "_Span":
        stack = self._rec._span_stack()
        self._parent = stack[-1].name if stack else None
        self._depth = len(stack)
        stack.append(self)
        self._t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        dur = now() - self._t0
        stack = self._rec._span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._rec._finish_span(
            SpanRecord(self.name, self._t0, dur, self._depth, self._parent,
                       self.labels)
        )
        return False


class _NullSpan:
    """Reusable no-op span: one process-wide instance, zero allocation."""

    __slots__ = ()

    def set(self, **fields) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _NullInstrument:
    """Reusable no-op counter/gauge/histogram handle."""

    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0

    def add(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRecorder:
    """The disabled default: every method is a no-op returning a shared
    singleton, so instrumentation left in place costs an attribute lookup
    and a call that allocates nothing."""

    __slots__ = ()
    enabled = False

    def add(self, name, value=1, **labels) -> None:
        pass

    def gauge(self, name, value, **labels) -> None:
        pass

    def observe(self, name, value, **labels) -> None:
        pass

    def span(self, name, **labels) -> _NullSpan:
        return _NULL_SPAN

    def counter(self, name, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name, **labels) -> _NullInstrument:
        return _NULL_INSTRUMENT


NULL = NullRecorder()


class Recorder:
    """A live metric/span recorder (module docstring for the model).

    Series creation (first sight of a (name, labels) pair) takes a lock;
    subsequent updates are plain attribute writes on the instrument —
    GIL-safe for the engine's single tick thread plus the gateway loop.
    ``span_capacity`` bounds the span ring; overflow drops the *oldest*
    record and counts it in ``spans_dropped``.
    """

    enabled = True

    def __init__(self, span_capacity: int = 8192):
        if span_capacity < 1:
            raise ValueError("span_capacity must be >= 1")
        self.span_capacity = span_capacity
        self.spans_dropped = 0
        self.started_at = now()
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._spans: deque[SpanRecord] = deque(maxlen=span_capacity)
        self._tls = threading.local()

    # --- series lookup ----------------------------------------------------

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())) if labels else ())

    def _series(self, table: dict, cls, name: str, labels: dict):
        key = self._key(name, labels)
        inst = table.get(key)
        if inst is None:
            with self._lock:
                inst = table.setdefault(key, cls(name, key[1]))
        return inst

    def counter(self, name: str, **labels) -> Counter:
        """Bound counter handle (pre-resolve once, ``add`` in the loop)."""
        return self._series(self._counters, Counter, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        """Bound histogram handle for hot loops."""
        return self._series(self._hists, Histogram, name, labels)

    # --- direct updates ---------------------------------------------------

    def add(self, name: str, value=1, **labels) -> None:
        self._series(self._counters, Counter, name, labels).add(value)

    def gauge(self, name: str, value, **labels) -> None:
        self._series(self._gauges, Gauge, name, labels).set(value)

    def observe(self, name: str, value: float, **labels) -> None:
        self._series(self._hists, Histogram, name, labels).observe(value)

    # --- spans ------------------------------------------------------------

    def span(self, name: str, **labels) -> _Span:
        return _Span(self, name, labels)

    def _span_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _finish_span(self, rec: SpanRecord) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.spans_dropped += 1
        self._spans.append(rec)
        # label-free duration histogram (the §15 cardinality rule)
        self.observe(rec.name, rec.dur_s)

    def spans(self, name: str | None = None) -> list[SpanRecord]:
        """Ring-buffer contents, oldest first (optionally one span name)."""
        out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    # --- introspection / reset --------------------------------------------

    def value(self, name: str, **labels):
        """Current value of one counter/gauge series (None if unseen)."""
        key = self._key(name, labels)
        inst = self._counters.get(key) or self._gauges.get(key)
        return None if inst is None else inst.value

    def hist(self, name: str, **labels) -> Histogram | None:
        return self._hists.get(self._key(name, labels))

    def hists(self, name: str) -> list[Histogram]:
        """Every histogram series with this name (one per label set)."""
        with self._lock:
            return [h for (n, _), h in self._hists.items() if n == name]

    def snapshot(self) -> dict:
        """JSON-able view of every series (the METRICS RPC payload).
        Series keys render as ``name{k=v,...}``."""

        def fmt(key: tuple) -> str:
            name, labels = key
            if not labels:
                return name
            inner = ",".join(f"{k}={v}" for k, v in labels)
            return f"{name}{{{inner}}}"

        with self._lock:
            counters = {fmt(k): c.value for k, c in self._counters.items()}
            gauges = {fmt(k): g.value for k, g in self._gauges.items()}
            hists = {
                fmt(k): {
                    "count": h.count,
                    "sum": h.sum,
                    "min": h.min if h.count else None,
                    "max": h.max if h.count else None,
                    "p50_le": h.quantile_le(0.5),
                    "p99_le": h.quantile_le(0.99),
                    "buckets": [
                        [i, n] for i, n in enumerate(h.buckets) if n
                    ],
                }
                for k, h in self._hists.items()
            }
        return {
            "enabled": True,
            "uptime_s": now() - self.started_at,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "spans": len(self._spans),
            "span_capacity": self.span_capacity,
            "spans_dropped": self.spans_dropped,
        }

    def dump_spans_jsonl(self, path) -> int:
        """Write the span ring as JSON Lines; returns the record count."""
        spans = self.spans()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.to_dict(), sort_keys=True))
                f.write("\n")
        return len(spans)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._spans.clear()
            self.spans_dropped = 0
            self.started_at = now()


def load_spans_jsonl(path) -> list[SpanRecord]:
    """Read a :meth:`Recorder.dump_spans_jsonl` file back."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(SpanRecord.from_dict(json.loads(line)))
    return out


# --- the process-global slot ------------------------------------------------

CURRENT: NullRecorder | Recorder = NULL


def get() -> NullRecorder | Recorder:
    return CURRENT


def set_current(rec: NullRecorder | Recorder):
    """Swap the process-global recorder (also refreshes the ``repro_torch.obs``
    package attribute so both spellings stay in sync)."""
    global CURRENT
    CURRENT = rec
    import sys

    pkg = sys.modules.get("repro_torch.obs")
    if pkg is not None:
        pkg.CURRENT = rec
    return rec


def enable(span_capacity: int = 8192) -> Recorder:
    """Install (and return) a fresh live :class:`Recorder`."""
    return set_current(Recorder(span_capacity=span_capacity))


def disable() -> NullRecorder:
    """Restore the no-op default."""
    set_current(NULL)
    return NULL
