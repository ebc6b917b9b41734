"""Run summaries over collected spans and metrics (the port of
``repro.obs.report``).

:func:`render_report` turns a tracer and a registry into a text or
markdown summary: the per-phase wall-time tree (aggregated over span
paths, with self time), the plan-cache outcomes, and the streamed
transfer-versus-compute split. :func:`resilience_report` pairs every
injected fault with the event that answered it.

This module also owns the **span-derived overlap efficiency**, the
timeline cross-check of ``StreamStats.overlap_efficiency`` (which counts
uploads issued ahead). It reads the port's stream spans:
``stream.upload`` (attr ``chunk``: the chunk uploaded) and
``stream.compute`` (attr ``chunk``), both opened by
``engine.stream.stream_mttkrp`` as children of one ``stream.mode`` span a
mode pass. An upload counts as *overlapped* when some ``stream.compute``
span of an **earlier** chunk under the same ``stream.mode`` parent
starts after the upload starts: the upload was issued ahead of the
compute frontier, while earlier chunks were still to run. The spans
time the host's issue of each copy and launch (both are asynchronous on
the card); the copy-stream and compute-stream CUDA events of
``StreamStats.timeline`` time the device. The rule needs only span
timestamps and ``chunk`` attrs, so it applies alike to live
:class:`SpanRecord` s (:func:`stream_overlap_from_spans`) and to an
exported Chrome trace (:func:`stream_overlap_from_chrome`).
"""
from __future__ import annotations

from .metrics import REGISTRY, MetricsRegistry
from .trace import Tracer, get_tracer

__all__ = ["time_tree", "render_report", "stream_overlap_from_spans",
           "stream_overlap_from_chrome", "resilience_report"]


# --------------------------------------------------------------------------
# Per-phase time tree.
# --------------------------------------------------------------------------
class _Node:
    __slots__ = ("name", "count", "total_ns", "child_ns", "children")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_ns = 0
        self.child_ns = 0
        self.children: dict[str, _Node] = {}

    @property
    def self_ns(self) -> int:
        return max(self.total_ns - self.child_ns, 0)


def time_tree(spans) -> dict[str, _Node]:
    """Aggregate spans into a tree keyed by span *path* (the stack of
    names from a root span down), merging repeats: each node carries its
    invocation count, total wall time, and self time (total minus the
    time attributed to child spans)."""
    by_id = {s.span_id: s for s in spans}
    roots: dict[str, _Node] = {}

    def path_of(s):
        names = [s.name]
        seen = {s.span_id}
        while s.parent_id is not None:
            s = by_id.get(s.parent_id)
            if s is None or s.span_id in seen:  # cross-thread / partial
                break
            seen.add(s.span_id)
            names.append(s.name)
        return tuple(reversed(names))

    for s in spans:
        path = path_of(s)
        level = roots
        node = None
        for name in path:
            node = level.get(name)
            if node is None:
                node = level[name] = _Node(name)
            level = node.children
        node.count += 1
        node.total_ns += s.duration_ns
        if s.parent_id is not None:
            parent = by_id.get(s.parent_id)
            if parent is not None:
                # attribute child time to the parent node
                pnode = roots
                target = None
                for name in path[:-1]:
                    target = pnode.get(name)
                    if target is None:
                        break
                    pnode = target.children
                if target is not None:
                    target.child_ns += s.duration_ns
    return roots


def _render_tree(roots: dict[str, _Node], indent: str = "  ") -> list[str]:
    lines: list[str] = []

    def fmt_ms(ns: int) -> str:
        return f"{ns / 1e6:10.3f}ms"

    def walk(nodes: dict[str, _Node], depth: int):
        for node in sorted(nodes.values(), key=lambda n: -n.total_ns):
            lines.append(
                f"{indent * depth}{node.name:<{max(34 - depth * 2, 8)}}"
                f" x{node.count:<5d} total {fmt_ms(node.total_ns)}"
                f"  self {fmt_ms(node.self_ns)}")
            walk(node.children, depth + 1)

    walk(roots, 0)
    return lines


# --------------------------------------------------------------------------
# Span-derived overlap efficiency (the profiler-timeline cross-check).
# --------------------------------------------------------------------------
def _overlap_from_events(events) -> float | None:
    """``events``: iterables of ``(name, parent_id, start, chunk)``.
    Applies the module-docstring rule; returns ``None`` with no uploads."""
    uploads: dict[object, list] = {}
    computes: dict[object, list] = {}
    for name, parent, start, chunk in events:
        if chunk is None:
            continue
        if name == "stream.upload":
            uploads.setdefault(parent, []).append((start, chunk))
        elif name == "stream.compute":
            computes.setdefault(parent, []).append((start, chunk))
    total = overlapped = 0
    for parent, ups in uploads.items():
        comps = computes.get(parent, [])
        for u_start, u_chunk in ups:
            total += 1
            if any(c_start > u_start and c_chunk < u_chunk
                   for c_start, c_chunk in comps):
                overlapped += 1
    if total == 0:
        return None
    return overlapped / total


def stream_overlap_from_spans(spans) -> float | None:
    """Span-derived ``overlap_efficiency`` over live span records (see
    module docstring for the rule); ``None`` when no ``stream.upload``
    spans were recorded."""
    return _overlap_from_events(
        (s.name, s.parent_id, s.start_ns, s.attrs.get("chunk"))
        for s in spans)


def stream_overlap_from_chrome(trace: dict) -> float | None:
    """Span-derived ``overlap_efficiency`` recomputed from an exported
    Chrome trace (the CI ``obs-smoke`` gate's input)."""
    events = []
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        events.append((e.get("name"), args.get("parent_id"), e.get("ts"),
                       args.get("chunk")))
    return _overlap_from_events(events)


# --------------------------------------------------------------------------
# Resilience pairing: every injected fault must leave an answering event.
# --------------------------------------------------------------------------
def resilience_report(registry: MetricsRegistry | None = None) -> dict:
    """Pair each ``chaos_injections`` site with the resilience event that
    should have answered it — the machine-checkable form of the *no
    silent degradation* invariant (the CI ``chaos-smoke`` gate asserts
    ``unanswered == []``).

    The pairing table (see :mod:`repro_torch.resilience.chaos` for the
    fault model): ``upload_fail`` -> an upload retry; ``oom_chunk`` -> a
    chunk-budget degradation; ``oom_resident`` -> the ``full->stream``
    residency rung; ``compile_fail`` -> a backend rung; ``nan_burst`` ->
    a NaN rollback recovery; ``corrupt_blob`` -> a quarantined
    plan-cache blob; ``kill_sweep`` -> a snapshot load (only observable
    in the *resumed* process — the injection itself dies with the killed
    one). Distributed sites: ``exchange_fail`` -> the ``permute ->
    all_gather`` exchange rung; ``device_lost`` -> a mesh-shrink
    degradation; ``dist_transient`` -> a ``dist.dispatch`` retry.
    """
    registry = registry or REGISTRY
    metrics = {m["name"]: m.get("values", {}) for m in registry.collect()}
    degr = metrics.get("resilience_degradations", {})
    retries = metrics.get("resilience_retries", {})
    recov = metrics.get("resilience_recoveries", {})
    cache = metrics.get("plan_cache_outcomes", {})
    snap = metrics.get("snapshot_events", {})
    injections = dict(metrics.get("chaos_injections", {}))

    def answered(site: str) -> bool:
        if site == "upload_fail":
            return retries.get("stream.upload", 0) > 0
        if site == "oom_chunk":
            return any(k.startswith("oom:") and k != "oom:full->stream"
                       for k in degr)
        if site == "oom_resident":
            return degr.get("oom:full->stream", 0) > 0
        if site == "compile_fail":
            return any(k.startswith("compile:") for k in degr)
        if site == "nan_burst":
            return recov.get("nan_rollback", 0) > 0
        if site == "corrupt_blob":
            return cache.get("disk_corrupt", 0) > 0
        if site == "kill_sweep":
            return snap.get("load", 0) > 0
        if site == "exchange_fail":
            return any(k.startswith("exchange:") for k in degr)
        if site == "device_lost":
            return any(k.startswith("device_lost:") for k in degr)
        if site == "dist_transient":
            return retries.get("dist.dispatch", 0) > 0
        return False

    return {
        "injections": injections,
        "answered": sorted(s for s in injections if answered(s)),
        "unanswered": sorted(s for s in injections if not answered(s)),
        "degradations": dict(degr),
        "retries": dict(retries),
        "recoveries": dict(recov),
        "snapshot_events": dict(snap),
        "cache_quarantines": cache.get("disk_corrupt", 0),
    }


# --------------------------------------------------------------------------
# The report.
# --------------------------------------------------------------------------
def render_report(tracer: Tracer | None = None,
                  registry: MetricsRegistry | None = None,
                  fmt: str = "text") -> str:
    """Text/markdown run summary: phase time tree, cache hit taxonomy,
    transfer vs compute, and the raw metrics dump."""
    if fmt not in ("text", "markdown"):
        raise ValueError(f"fmt must be 'text' or 'markdown', got {fmt!r}")
    tracer = tracer or get_tracer()
    registry = registry or REGISTRY
    spans = tracer.spans() if tracer else ()
    md = fmt == "markdown"

    def header(title: str) -> list[str]:
        return [f"## {title}", ""] if md else [title, "-" * len(title)]

    lines: list[str] = []
    lines += ["# repro_torch run report", ""] if md else \
        ["repro_torch run report", "=" * 22]

    lines += header(f"Phase time tree ({len(spans)} spans)")
    tree_lines = _render_tree(time_tree(spans)) or ["(no spans recorded — "
                                                    "set REPRO_TRACE=1)"]
    lines += ["```", *tree_lines, "```", ""] if md else tree_lines + [""]

    metrics = {m["name"]: m for m in registry.collect()}

    cache = metrics.get("plan_cache_outcomes", {}).get("values", {})
    if cache:
        lines += header("Plan cache taxonomy")
        total = sum(cache.values())
        for outcome, n in sorted(cache.items()):
            lines.append(f"  {outcome:<12} {n:>8}  "
                         f"({100.0 * n / max(total, 1):.1f}%)")
        lines.append("")

    stream = metrics.get("stream_bytes", {}).get("values", {})
    if stream:
        lines += header("Streaming transfer vs compute")
        h2d = stream.get("h2d", 0)
        frag = stream.get("fragment", 0)
        compute_ns = sum(s.duration_ns for s in spans
                         if s.name == "stream.compute")
        upload_ns = sum(s.duration_ns for s in spans
                        if s.name == "stream.upload")
        lines.append(f"  h2d bytes      {h2d:>14,}")
        lines.append(f"  fragment bytes {frag:>14,}")
        lines.append(f"  upload wall    {upload_ns / 1e6:>12.3f}ms")
        lines.append(f"  compute wall   {compute_ns / 1e6:>12.3f}ms "
                     "(dispatch; device time overlaps uploads)")
        span_eff = stream_overlap_from_spans(spans)
        if span_eff is not None:
            lines.append(f"  overlap (span-derived) {span_eff:>7.3f}")
        counts = metrics.get("stream_counts", {}).get("values", {})
        ups = counts.get("uploads", 0)
        if ups:
            lines.append(f"  overlap (count-derived)"
                         f" {counts.get('overlapped_uploads', 0) / ups:>7.3f}")
        lines.append("")

    lines += header("Metrics")
    if not metrics:
        lines.append("  (none recorded)")
    for name, m in sorted(metrics.items()):
        lines.append(f"  {name} ({m['kind']})")
        for key, value in sorted(m["values"].items()):
            if isinstance(value, dict):  # histogram summary
                mean = value["sum"] / max(value["count"], 1)
                value = (f"count={value['count']} mean={mean:.6g} "
                         f"min={value['min']:.6g} max={value['max']:.6g}")
            lines.append(f"    {key:<28} {value}")
    return "\n".join(lines) + "\n"
