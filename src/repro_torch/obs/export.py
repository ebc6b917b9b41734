"""Trace and metrics exporters: Chrome-trace JSON, JSONL span log, run
manifest (the port of ``repro.obs.export``).

The Chrome trace (``chrome_trace`` / ``write_chrome_trace``) follows the
Trace Event Format's "JSON object" flavor: a ``traceEvents`` list of
complete (``"ph": "X"``) duration events plus thread-name metadata and one
``"C"`` counter sample per counter metric. It loads into Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``. Extra top-level keys
carry the run manifest and a metrics snapshot, so the overlap and the
resilience pairing can be read back from the file alone.

``write_jsonl`` is the flat log (one JSON object a span);
``run_manifest`` records what produced the trace: torch and CUDA
versions, the card's name and power limit, the PlanSpec knobs and the
dataset's signature.
"""
from __future__ import annotations

import json
import os
import time

from .metrics import REGISTRY, MetricsRegistry
from .trace import SpanRecord, Tracer, get_tracer

__all__ = ["chrome_trace", "write_chrome_trace", "write_jsonl",
           "run_manifest", "validate_chrome_trace"]


def _jsonable(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    # numpy scalars and friends
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return _jsonable(item())
        except Exception:
            pass
    return repr(value)


def _power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    ``None`` where it does not run."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_manifest(spec=None, dataset_signature=None, extra=None) -> dict:
    """What produced this trace: runtime versions, the card (name, count,
    power limit) where there is one, the PlanSpec/ExecutionConfig knobs,
    and the dataset's sparsity signature (each optional)."""
    import platform
    import sys

    import torch

    manifest: dict = {
        "unix_time": time.time(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        manifest["devices"] = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
        manifest["device_name"] = manifest["devices"][0]
        manifest["power_limit"] = _power_limit()
    if spec is not None:
        import dataclasses

        manifest["plan_spec"] = (
            dataclasses.asdict(spec) if dataclasses.is_dataclass(spec)
            else _jsonable(spec))
    if dataset_signature is not None:
        manifest["dataset_signature"] = _jsonable(dataset_signature)
    if extra:
        manifest.update({str(k): _jsonable(v) for k, v in extra.items()})
    return manifest


def chrome_trace(tracer: Tracer | None = None,
                 registry: MetricsRegistry | None = None,
                 manifest: dict | None = None) -> dict:
    """Render spans (+ a metrics snapshot) as a Chrome-trace JSON object.

    Timestamps are microseconds relative to the tracer's epoch; span
    attrs, ids, and parent ids ride in each event's ``args`` so the
    trace is self-contained (the overlap-validation gate reconstructs
    span relationships from the file alone).
    """
    tracer = tracer or get_tracer()
    registry = registry or REGISTRY
    spans: tuple[SpanRecord, ...] = tracer.spans() if tracer else ()
    epoch = min((s.start_ns for s in spans), default=0)

    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
        "args": {"name": "repro_torch"},
    }]
    tids: dict[int, int] = {}
    for s in spans:
        tid = tids.get(s.thread_id)
        if tid is None:
            tid = tids[s.thread_id] = len(tids)
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": s.thread_name}})
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "pid": 0,
            "tid": tid,
            "ts": (s.start_ns - epoch) / 1e3,
            "dur": s.duration_ns / 1e3,
            "args": {"span_id": s.span_id, "parent_id": s.parent_id,
                     **{str(k): _jsonable(v) for k, v in s.attrs.items()}},
        })
    end_ts = max(((s.end_ns - epoch) / 1e3 for s in spans), default=0.0)
    metrics = registry.collect()
    for m in metrics:
        if m["kind"] != "counter" or not m["values"]:
            continue
        events.append({
            "name": m["name"], "ph": "C", "pid": 0, "tid": 0, "ts": end_ts,
            "args": {k: v for k, v in m["values"].items()
                     if isinstance(v, (int, float))},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "manifest": manifest if manifest is not None else run_manifest(),
            "metrics": metrics,
            "span_count": len(spans),
        },
    }


def validate_chrome_trace(trace: dict) -> list[str]:
    """Schema check for the traces we emit (and that Perfetto loads):
    returns a list of problems, empty when the trace is well-formed."""
    errors: list[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a JSON object, got {type(trace).__name__}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                errors.append(f"{where}: missing {field!r}")
        ph = e.get("ph")
        if ph not in ("X", "M", "C", "B", "E", "i"):
            errors.append(f"{where}: unknown phase {ph!r}")
        if ph == "X":
            ts, dur = e.get("ts"), e.get("dur")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
            args = e.get("args", {})
            if "span_id" not in args:
                errors.append(f"{where}: X event missing args.span_id")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as err:
        errors.append(f"not JSON-serializable: {err}")
    return errors


def write_chrome_trace(path: str, tracer: Tracer | None = None,
                       registry: MetricsRegistry | None = None,
                       manifest: dict | None = None) -> dict:
    """Validate + atomically write the Chrome trace; returns the object."""
    trace = chrome_trace(tracer, registry, manifest)
    errors = validate_chrome_trace(trace)
    if errors:  # our own exporter must never emit an invalid trace
        raise ValueError(f"invalid chrome trace: {errors[:5]}")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-trace-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    os.replace(tmp, path)
    return trace


def write_jsonl(path: str, tracer: Tracer | None = None) -> int:
    """Flat span log: one JSON object per span, start-ordered. Returns
    the number of spans written."""
    tracer = tracer or get_tracer()
    spans = tracer.spans() if tracer else ()
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-jsonl-{os.getpid()}")
    with open(tmp, "w") as f:
        for s in spans:
            f.write(json.dumps({
                "name": s.name, "span_id": s.span_id,
                "parent_id": s.parent_id, "thread": s.thread_name,
                "start_ns": s.start_ns, "dur_ns": s.duration_ns,
                "attrs": {str(k): _jsonable(v) for k, v in s.attrs.items()},
            }))
            f.write("\n")
    os.replace(tmp, path)
    return len(spans)
