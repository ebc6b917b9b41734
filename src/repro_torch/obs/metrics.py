"""Labeled counter/gauge/histogram registry: the metrics layer of
``repro_torch.obs``.

A copy of ``repro.obs.metrics`` (the port imports nothing of the JAX
package).  The registry keeps every subsystem's tallies behind one
uniform surface:

* :class:`Counter` — monotonically increasing tallies, keyed by a label
  (``DISPATCHES.inc("all_modes")``).  Counters double as dict-like
  tallies (``c["all_modes"] += 1``, ``c.clear()``, ``dict(c)``) so the
  engine's legacy ``TRACE_COUNTS`` / ``DISPATCH_COUNTS`` module globals
  migrate onto the registry without breaking a single callsite.
* :class:`Gauge` — last-value-wins samples (``fit`` per ALS sweep, peak
  ring bytes).
* :class:`Histogram` — streaming summaries (count/sum/min/max) for
  timings and sizes where the full distribution is not worth keeping.

Everything is process-global by default (:data:`REGISTRY`) but
instantiable (:class:`MetricsRegistry`) for tests; all mutation is
lock-protected.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram"]


class _Metric:
    """Shared keyed-value plumbing; ``key`` is any hashable label (the
    common case is a short string)."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------- mapping surface
    def __getitem__(self, key):
        with self._lock:
            return self._values.get(key, 0)

    def __contains__(self, key):
        with self._lock:
            return key in self._values

    def __iter__(self):
        with self._lock:
            return iter(list(self._values))

    def __len__(self):
        with self._lock:
            return len(self._values)

    def keys(self):
        with self._lock:
            return list(self._values.keys())

    def items(self):
        with self._lock:
            return list(self._values.items())

    def get(self, key, default=0):
        with self._lock:
            return self._values.get(key, default)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def as_dict(self) -> dict:
        with self._lock:
            return dict(self._values)

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r}, {self.as_dict()!r})"


class Counter(_Metric):
    """Monotonic tally per label; dict-style mutation kept for back-compat
    with the engine's legacy ``collections.Counter`` globals."""

    kind = "counter"

    def inc(self, key, amount=1):
        with self._lock:
            value = self._values.get(key, 0) + amount
            self._values[key] = value
            return value

    def __setitem__(self, key, value):
        # legacy `c[k] += 1` path (getitem + setitem); also absolute sets
        with self._lock:
            self._values[key] = value

    def total(self):
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    """Last-value-wins sample per label."""

    kind = "gauge"

    def set(self, key, value):
        with self._lock:
            self._values[key] = value

    def __setitem__(self, key, value):
        self.set(key, value)

    def max(self, key, value):
        """Keep the running maximum (peak trackers)."""
        with self._lock:
            cur = self._values.get(key)
            if cur is None or value > cur:
                self._values[key] = value


class Histogram(_Metric):
    """Streaming summary per label: count / sum / min / max (and the
    derived mean).  Full distributions stay with the caller when they
    matter (``benchmarks.common.time_fn`` records p10/p90 itself)."""

    kind = "histogram"

    def observe(self, key, value):
        value = float(value)
        with self._lock:
            cur = self._values.get(key)
            if cur is None:
                self._values[key] = {"count": 1, "sum": value,
                                     "min": value, "max": value}
            else:
                cur["count"] += 1
                cur["sum"] += value
                if value < cur["min"]:
                    cur["min"] = value
                if value > cur["max"]:
                    cur["max"] = value

    def summary(self, key) -> dict | None:
        with self._lock:
            cur = self._values.get(key)
            if cur is None:
                return None
            out = dict(cur)
        out["mean"] = out["sum"] / max(out["count"], 1)
        return out


class MetricsRegistry:
    """Name -> metric registry; ``counter/gauge/histogram`` get-or-create
    (re-registration with a different kind is an error)."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, kind: str, name: str, help: str) -> _Metric:
        cls = self._KINDS[kind]
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create("counter", name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create("gauge", name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create("histogram", name, help)

    def metrics(self) -> dict[str, _Metric]:
        with self._lock:
            return dict(self._metrics)

    def collect(self) -> list[dict]:
        """Snapshot every metric as plain JSON-able records (the export
        and report layers' input)."""
        out = []
        for name, m in sorted(self.metrics().items()):
            out.append({"name": name, "kind": m.kind, "help": m.help,
                        "values": {_label(k): v
                                   for k, v in m.as_dict().items()}})
        return out

    def reset(self) -> None:
        """Clear every metric's values (registrations survive)."""
        for m in self.metrics().values():
            m.clear()


def _label(key) -> str:
    return key if isinstance(key, str) else repr(key)


#: Process-wide default registry — library instrumentation lands here.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter on the default registry."""
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-create a gauge on the default registry."""
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "") -> Histogram:
    """Get-or-create a histogram on the default registry."""
    return REGISTRY.histogram(name, help)
