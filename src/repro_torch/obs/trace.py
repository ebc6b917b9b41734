"""Hierarchical wall-clock tracing: the span layer of ``repro_torch.obs``.

The port's copy of ``repro.obs.trace``.  A span records a monotonic
``perf_counter_ns`` interval, its thread, its parent (spans nest
per-thread) and a small dict of attributes.  Where the reference mirrors
each span into ``jax.profiler.TraceAnnotation``, the port enters
``torch.profiler.record_function`` of the same name, so the engine's
phases line up inside a ``torch.profiler`` timeline next to the CUDA
kernels they launch.

Tracing is off by default; the module-level :func:`span` is then one
global load and one ``is None`` test returning a shared no-op context
manager.  Enable it from the environment, as the reference does::

    REPRO_TRACE=1 python ...            # collect spans (export manually)
    REPRO_TRACE=out/trace.json python … # collect, and write a Chrome
                                        # trace there at exit
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import threading
import time

__all__ = ["SpanRecord", "Tracer", "span", "traced", "enable", "disable",
           "is_enabled", "get_tracer", "ENV_VAR"]

ENV_VAR = "REPRO_TRACE"


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (immutable once recorded)."""

    name: str
    span_id: int
    parent_id: int | None
    thread_id: int
    thread_name: str
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _NullSpan:
    """Shared reentrant no-op span: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):  # matches _Span.set
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """Live span context manager (one per ``with span(...)`` entry)."""

    __slots__ = ("_tracer", "name", "attrs", "_span_id", "_parent_id",
                 "_start_ns", "_ann")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._ann = None

    def set(self, key, value) -> None:
        """Attach/overwrite an attribute while the span is open."""
        self.attrs[key] = value

    def __enter__(self):
        t = self._tracer
        stack = t._stack()
        self._parent_id = stack[-1] if stack else None
        self._span_id = next(t._ids)
        stack.append(self._span_id)
        if t.profiler_annotations:
            from torch.profiler import record_function

            self._ann = record_function(self.name)
            self._ann.__enter__()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        t = self._tracer
        stack = t._stack()
        if stack and stack[-1] == self._span_id:
            stack.pop()
        cur = threading.current_thread()
        t._record(SpanRecord(
            name=self.name, span_id=self._span_id,
            parent_id=self._parent_id, thread_id=cur.ident or 0,
            thread_name=cur.name, start_ns=self._start_ns, end_ns=end_ns,
            attrs=self.attrs))
        return False


class Tracer:
    """Collects :class:`SpanRecord`s; thread-safe, instantiable for tests.

    ``profiler_annotations=True`` additionally wraps every span in a
    ``torch.profiler.record_function`` (a no-op when no profile is being
    taken).
    """

    def __init__(self, *, profiler_annotations: bool = True):
        self.profiler_annotations = profiler_annotations
        self._records: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self.epoch_ns = time.perf_counter_ns()

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def spans(self) -> tuple[SpanRecord, ...]:
        """All completed spans, in start order."""
        with self._lock:
            records = list(self._records)
        return tuple(sorted(records, key=lambda r: (r.start_ns, r.span_id)))

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
        self.epoch_ns = time.perf_counter_ns()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


_ACTIVE: Tracer | None = None


def span(name: str, **attrs):
    """Open a span on the global tracer; hard no-op while disabled."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def traced(name: str | None = None, **attrs):
    """Decorator form of :func:`span` (span named after the function)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = _ACTIVE
            if t is None:
                return fn(*args, **kwargs)
            with t.span(label, **attrs):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def enable(tracer: Tracer | None = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the global tracer."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer()
    return _ACTIVE


def disable() -> Tracer | None:
    """Remove the global tracer (spans become no-ops); returns it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, None
    return prev


def is_enabled() -> bool:
    return _ACTIVE is not None


def get_tracer() -> Tracer | None:
    """The global tracer, or ``None`` while tracing is disabled."""
    return _ACTIVE


def _init_from_env() -> None:
    """``REPRO_TRACE`` opt-in: any non-empty value other than
    ``0/false/off`` enables tracing at import; a value other than
    ``1/true/on`` is a path, where a Chrome trace is written at
    interpreter exit (:func:`repro_torch.obs.export.write_chrome_trace`)."""
    val = os.environ.get(ENV_VAR, "").strip()
    if not val or val.lower() in ("0", "false", "off"):
        return
    enable()
    if val.lower() in ("1", "true", "on"):
        return
    import atexit

    def _dump(path=val):
        from .export import write_chrome_trace

        if _ACTIVE is not None and len(_ACTIVE):
            write_chrome_trace(path)

    atexit.register(_dump)


_init_from_env()
