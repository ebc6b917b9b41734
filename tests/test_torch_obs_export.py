"""The port's trace exporters and run reports (``repro_torch.obs.export``
and ``repro_torch.obs.report``) against the reference's
(``repro.obs.export``, ``repro.obs.report``) on the same span records
and metric values: the Chrome trace's events (all but the process
name), its validation, the JSONL log, ``time_tree``, the span-derived
overlap from live spans and from an exported trace, the resilience
pairing, and the text report. Exact equality throughout: the two are
the same host code over the same numbers.

The live part drives the port's streaming tier on the CPU and checks
that its ``stream.upload`` / ``stream.compute`` spans give the overlap
the ``StreamStats`` counts give.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs import export as rexport
from repro.obs import metrics as rmetrics
from repro.obs import report as rreport
from repro.obs import trace as rtrace
from repro_torch import obs
from repro_torch.core import build_flycoo
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.stream import stream_all_modes, stream_init
from repro_torch.obs import export, metrics, report, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(mod):
    """A small nested run in ``mod``'s ``SpanRecord``: a sweep with two
    stream modes of three chunks each (uploads issued ahead of computes),
    a retry and a degradation, on two threads."""
    R = mod.SpanRecord
    recs = [R("cpd.sweep", 1, None, 11, "MainThread", 1000, 90000,
              {"sweep": 0, "fit": 0.5}),
            R("resilience.retry", 20, None, 12, "copy", 3000, 3500,
              {"what": "stream.upload", "attempt": 0})]
    sid = 2
    # each mode as the port's stream issues it: uploads 0 and 1, compute
    # 0, upload 2, computes 1 and 2
    order = (("stream.upload", 0), ("stream.upload", 1),
             ("stream.compute", 0), ("stream.upload", 2),
             ("stream.compute", 1), ("stream.compute", 2))
    for m, base in enumerate((2000, 40000)):
        mode_id = sid
        recs.append(R("stream.mode", mode_id, 1, 11, "MainThread", base,
                      base + 30000, {"mode": m, "nchunks": 3}))
        sid += 1
        t = base + 100
        for name, c in order:
            attrs = {"chunk": c}
            if name == "stream.upload":
                attrs.update(prefetch=c > 0, bytes=np.int64(64 * (c + 1)))
            recs.append(R(name, sid, mode_id, 11, "MainThread", t,
                          t + 500, attrs))
            sid += 1
            t += 600
    recs.append(R("resilience.degrade", 99, 1, 11, "MainThread", 85000,
                  85001, {"kind": "oom", "frm": "512", "to": "256"}))
    return recs


def _tracer(mod, recs):
    t = mod.Tracer(**({"xla_annotations": False} if mod is rtrace
                      else {"profiler_annotations": False}))
    for r in recs:
        t._record(r)
    return t


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("chaos_injections").inc("upload_fail", 2)
    reg.counter("chaos_injections").inc("oom_chunk")
    reg.counter("chaos_injections").inc("nan_burst")
    reg.counter("resilience_retries").inc("stream.upload", 2)
    reg.counter("resilience_degradations").inc("oom:512->256")
    reg.counter("plan_cache_outcomes").inc("miss")
    reg.counter("plan_cache_outcomes").inc("hit", 3)
    reg.counter("stream_bytes").inc("h2d", 4096)
    reg.counter("stream_bytes").inc("fragment", 1024)
    reg.counter("stream_counts").inc("uploads", 6)
    reg.counter("stream_counts").inc("overlapped_uploads", 4)
    reg.gauge("stream_peaks").max("ring_bytes", 777)
    reg.histogram("sweep_s").observe("resident", 0.25)
    return reg


@pytest.fixture
def both():
    return ((_tracer(trace, _records(trace)), _registry(metrics)),
            (_tracer(rtrace, _records(rtrace)), _registry(rmetrics)))


def _strip(events):
    return [e for e in events if e.get("name") != "process_name"]


def test_chrome_trace_equals_the_reference(both):
    (t, reg), (rt, rreg) = both
    manifest = {"run": "x"}
    got = export.chrome_trace(t, reg, manifest)
    want = rexport.chrome_trace(rt, rreg, manifest)
    assert _strip(got["traceEvents"]) == _strip(want["traceEvents"])
    assert got["metadata"] == want["metadata"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    names = {e["args"]["name"] for e in got["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {"repro_torch"}
    assert export.validate_chrome_trace(got) == []
    assert rexport.validate_chrome_trace(got) == []


def test_validate_chrome_trace_equals_the_reference():
    bad = [None, {}, {"traceEvents": "x"},
           {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0,
                             "ts": -1, "dur": "x", "args": {}},
                            {"ph": "Q"}, 3]}]
    for trace_obj in bad:
        got = export.validate_chrome_trace(trace_obj)
        assert got and got == rexport.validate_chrome_trace(trace_obj)


def test_write_chrome_trace_and_jsonl(both, tmp_path):
    (t, reg), (rt, rreg) = both
    path = tmp_path / "sub" / "trace.json"
    written = export.write_chrome_trace(str(path), t, reg,
                                        manifest={"run": "x"})
    assert json.loads(path.read_text()) == json.loads(json.dumps(written))
    n = export.write_jsonl(str(tmp_path / "spans.jsonl"), t)
    rn = rexport.write_jsonl(str(tmp_path / "rspans.jsonl"), rt)
    assert n == rn == len(t)
    got = (tmp_path / "spans.jsonl").read_text().splitlines()
    want = (tmp_path / "rspans.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in got] == [json.loads(x) for x in want]
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]


def test_run_manifest_keys():
    from repro_torch.engine import PlanSpec

    m = export.run_manifest(spec=PlanSpec(device="cpu"),
                            dataset_signature=((3, 4), 5, ((1,),)),
                            extra={"seed": np.int64(3)})
    r = rexport.run_manifest()
    common = {"unix_time", "python", "platform", "argv", "pid"}
    assert common <= set(m) and common <= set(r)
    assert {"torch_version", "cuda_version", "cuda_available"} <= set(m)
    assert not any(k.startswith("jax") for k in m)
    assert m["cuda_available"] is False and "device_name" not in m
    assert m["plan_spec"]["device"] == "cpu" and m["seed"] == 3
    assert m["dataset_signature"] == [[3, 4], 5, [[1]]]
    json.dumps(m)


def _tree(nodes):
    return {name: (n.count, n.total_ns, n.self_ns, _tree(n.children))
            for name, n in nodes.items()}


def test_time_tree_equals_the_reference(both):
    (t, _), (rt, _) = both
    got = _tree(report.time_tree(t.spans()))
    assert got == _tree(rreport.time_tree(rt.spans()))
    sweep = got["cpd.sweep"]
    assert sweep[0] == 1 and sweep[3]["stream.mode"][0] == 2


def test_overlap_from_spans_and_chrome_equals_the_reference(both):
    (t, reg), (rt, rreg) = both
    got = report.stream_overlap_from_spans(t.spans())
    assert got == rreport.stream_overlap_from_spans(rt.spans())
    assert got == pytest.approx(2 / 3)
    chrome = export.chrome_trace(t, reg, {})
    assert report.stream_overlap_from_chrome(chrome) == \
        rreport.stream_overlap_from_chrome(chrome) == got
    assert report.stream_overlap_from_spans(()) is None


def test_resilience_report_and_render_equal_the_reference(both):
    (t, reg), (rt, rreg) = both
    assert report.resilience_report(reg) == rreport.resilience_report(rreg)
    rep = report.resilience_report(reg)
    assert rep["unanswered"] == ["nan_burst"]
    for fmt in ("text", "markdown"):
        got = report.render_report(t, reg, fmt=fmt)
        want = rreport.render_report(rt, rreg, fmt=fmt)
        assert got.replace("repro_torch run report", "repro run report") \
            .replace("=" * 22, "=" * 16) == want
    with pytest.raises(ValueError):
        report.render_report(t, reg, fmt="html")


def test_stream_spans_give_the_counted_overlap():
    """The port's live stream spans: the span-derived overlap equals
    ``StreamStats.overlap_efficiency`` (uploads issued ahead), and the
    exported trace gives the same."""
    rng = np.random.default_rng(0)
    dims = (29, 23, 19)
    idx = np.unique(np.stack([rng.integers(0, d, 400) for d in dims], 1),
                    axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=8)
    cfg = ExecutionConfig(device="cpu", rows_pp=8, block_p=8, chunk_nnz=64)
    factors = [torch.ones(d, 4) for d in dims]
    tracer = trace.enable(trace.Tracer(profiler_annotations=False))
    try:
        ss = stream_init(t, cfg)
        _, ss = stream_all_modes(ss, factors)
    finally:
        trace.disable()
    assert min(cs.nchunks for cs in ss.plan.chunks) >= 2
    spans = tracer.spans()
    eff = report.stream_overlap_from_spans(spans)
    assert eff == pytest.approx(ss.stats.overlap_efficiency)
    chrome = export.chrome_trace(tracer, metrics.MetricsRegistry(), {})
    assert export.validate_chrome_trace(chrome) == []
    assert report.stream_overlap_from_chrome(chrome) == pytest.approx(eff)


def test_repro_trace_env_writes_a_trace_at_exit(tmp_path):
    out = tmp_path / "t" / "trace.json"
    code = ("from repro_torch.obs.trace import span\n"
            "with span('outer', k=1):\n"
            "    with span('inner'):\n"
            "        pass\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TRACE=str(out))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(out.read_text())
    assert export.validate_chrome_trace(got) == []
    assert {e["name"] for e in got["traceEvents"] if e["ph"] == "X"} == \
        {"outer", "inner"}
    assert obs.ENV_VAR == "REPRO_TRACE"
