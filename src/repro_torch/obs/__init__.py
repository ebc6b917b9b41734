"""Observability for the port: spans (:mod:`.trace`) and the metrics
registry (:mod:`.metrics`)."""
from .metrics import REGISTRY, counter, gauge, histogram
from .trace import Tracer, disable, enable, get_tracer, span, traced

__all__ = ["REGISTRY", "counter", "gauge", "histogram", "Tracer", "span",
           "traced", "enable", "disable", "get_tracer"]
