"""Observability for the port: spans (:mod:`.trace`), the metrics
registry (:mod:`.metrics`) and peak-memory probes (:mod:`.probe`)."""
from .metrics import REGISTRY, counter, gauge, histogram
from .probe import device_peak_bytes, memory_probe
from .trace import Tracer, disable, enable, get_tracer, span, traced

__all__ = ["REGISTRY", "counter", "gauge", "histogram", "Tracer", "span",
           "traced", "enable", "disable", "get_tracer", "memory_probe",
           "device_peak_bytes"]
