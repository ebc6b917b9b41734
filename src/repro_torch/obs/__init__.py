"""Observability for the port (the port of ``repro.obs``): spans
(:mod:`.trace`), the metrics registry (:mod:`.metrics`), Chrome-trace /
JSONL / manifest exporters (:mod:`.export`), run summaries with the
span-derived overlap and the resilience pairing (:mod:`.report`), and
peak-memory probes (:mod:`.probe`).

Quick start::

    from repro_torch import obs

    obs.enable()                      # or: REPRO_TRACE=1 / =trace.json
    result = cp_als(tensor, rank=8)
    obs.write_chrome_trace("trace.json")   # load in ui.perfetto.dev
    print(obs.render_report())
"""
from .export import (chrome_trace, run_manifest, validate_chrome_trace,
                     write_chrome_trace, write_jsonl)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      counter, gauge, histogram)
from .probe import device_peak_bytes, memory_probe
from .report import (render_report, resilience_report,
                     stream_overlap_from_chrome, stream_overlap_from_spans,
                     time_tree)
from .trace import (ENV_VAR, NULL_SPAN, SpanRecord, Tracer, disable, enable,
                    get_tracer, is_enabled, span, traced)

__all__ = [
    "span", "traced", "Tracer", "SpanRecord", "NULL_SPAN", "enable",
    "disable", "is_enabled", "get_tracer", "ENV_VAR",
    "REGISTRY", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "chrome_trace", "write_chrome_trace", "write_jsonl", "run_manifest",
    "validate_chrome_trace",
    "render_report", "resilience_report", "time_tree",
    "stream_overlap_from_spans", "stream_overlap_from_chrome",
    "memory_probe", "device_peak_bytes",
]
