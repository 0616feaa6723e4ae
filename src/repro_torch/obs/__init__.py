"""repro_torch.obs — zero-overhead observability: counters, gauges, histograms,
spans, and export surfaces (Prometheus text, JSONL spans, gateway METRICS).

Quickstart::

    from repro import obs

    rec = obs.enable()                 # install a live Recorder
    ... run the engine / gateway ...
    print(obs.export.prometheus_text(rec))
    rec.dump_spans_jsonl("spans.jsonl")
    obs.disable()                      # restore the no-op default

The disabled default (``obs.core.NULL``) makes every instrumented call
site a no-op costing one attribute lookup; see ``repro_torch/obs/core.py`` and
DESIGN.md §15 for the contract.  Instrumented modules must read the slot
via ``from repro_torch.obs import core as obs`` + ``obs.CURRENT`` (always
fresh); ``repro_torch.obs.CURRENT`` is kept in sync for interactive use.
"""

from repro_torch.obs import core, export
from repro_torch.obs.core import (
    CURRENT,
    HIST_BUCKETS,
    HIST_LO_EXP,
    NULL,
    Histogram,
    NullRecorder,
    Recorder,
    SpanRecord,
    bucket_index,
    bucket_le,
    disable,
    enable,
    get,
    load_spans_jsonl,
    set_current,
)

__all__ = [
    "CURRENT",
    "HIST_BUCKETS",
    "HIST_LO_EXP",
    "NULL",
    "Histogram",
    "NullRecorder",
    "Recorder",
    "SpanRecord",
    "bucket_index",
    "bucket_le",
    "core",
    "disable",
    "enable",
    "export",
    "get",
    "load_spans_jsonl",
    "set_current",
]
