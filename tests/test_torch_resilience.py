"""The port's resilience layer (``repro_torch.resilience`` and its wiring
into ``cp_als``, the stream, the factory and the plan cache) on the CPU,
case by case after the reference's ``tests/test_resilience.py``, and held
against the reference (``repro.resilience``) on the same inputs.

Held exactly equal to the reference: ``classify`` on the reference's
cases, ``backoff_delay``, both ``from_env`` parsers, ``fingerprint`` and
``payload_digest``; snapshot blobs cross over both ways (the reference's
v1 and sharded v2 load in the port, the port's v1 loads in the
reference).

Bitwise on the port's ``torch`` backend (the plain versions sum each row
in slot order): resume of ``cp_als`` and ``cp_als_stream`` in process
and after a SIGKILL in a subprocess, the stream's OOM halving against
the unhalved stream, the upload retry against a clean stream.

The ROADMAP gate of item 9: a snapshot the reference wrote after 3 sweeps
(under the port's fingerprint, through the reference's store) resumes in
the port, and the port's factors and fits after 6 sweeps agree with an
uninterrupted reference run within ``rtol 1e-5, atol 1e-6`` (factors)
and ``atol 1e-6`` (fits), float32: the port runs sweeps 4-6 with float32
sums in another order than XLA's.

Every config here has ``device="cpu"``: the default device is the card.
"""
import dataclasses
import os
import pathlib
import re
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import build_flycoo as rbuild
from repro.core.cpd import cp_als as rcp_als
from repro.core.cpd import init_factors as rinit_factors
from repro.engine import ExecutionConfig as RConfig
from repro.resilience import chaos as rchaos
from repro.resilience import ladder as rladder
from repro.resilience import snapshot as rsnapshot
from repro_torch import obs
from repro_torch.core import PlanCache, build_flycoo, cp_als
from repro_torch.core.cpd import init_key
from repro_torch.engine import (ExecutionConfig, PlanSpec, StreamState,
                                make_engine)
from repro_torch.engine import api as engine_api
from repro_torch.engine.config import BACKEND_LADDER, CARD_LADDER
from repro_torch.engine.stream import (cp_als_stream, plan_stream_cached,
                                       stream_all_modes, stream_init)
from repro_torch.kernels.build import KernelBuildError
from repro_torch.resilience import (DEFAULT_POLICY, ChaosCompileError,
                                    ChaosDeviceLost, ChaosExchangeError,
                                    ChaosOOM, ChaosSpec, ChaosUploadError,
                                    LadderPolicy, Snapshot, SnapshotStore,
                                    backoff_delay, chaos, classify,
                                    factor_shards, fingerprint, install,
                                    install_ambient, ladder, next_backend,
                                    payload_digest, resolve_policy,
                                    uninstall, uninstall_ambient)

REPO = pathlib.Path(__file__).resolve().parents[1]
FACTOR_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = 1e-6


def _coo(nmodes=3, nnz=300, seed=0):
    dims = (29, 23, 19, 13, 11, 7)[:nmodes]
    rng = np.random.default_rng(seed)
    idx = np.unique(
        np.stack([rng.integers(0, d, nnz) for d in dims], 1)
        .astype(np.int64), axis=0)
    return idx, rng.standard_normal(len(idx)).astype(np.float32), dims


def _factors(dims, rank=5, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((d, rank))
                             .astype(np.float32)) for d in dims]


def _cfg(**kw):
    return ExecutionConfig(device="cpu", rows_pp=8, **kw)


def _tensor(**kw):
    idx, val, dims = _coo(**kw)
    return build_flycoo(idx, val, dims, rows_pp=8)


def _degradations():
    return obs.REGISTRY.counter("resilience_degradations").as_dict()


def _equal(xs, ys):
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    """Every test starts and ends with chaos uninstalled in both
    packages."""
    uninstall()
    rchaos.uninstall()
    yield
    uninstall()
    rchaos.uninstall()


# --------------------------------------------------------------------------
# Pure pieces against the reference.
# --------------------------------------------------------------------------
REFERENCE_CASES = [
    ChaosOOM("x"), ChaosUploadError("x"), ChaosCompileError("x"),
    ChaosDeviceLost("gone", lost=2), ChaosExchangeError("x"),
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    RuntimeError("Mosaic lowering failed"),
    RuntimeError("transfer failed: connection reset"),
    RuntimeError("INTERNAL: device lost"),
    RuntimeError("collective_permute deadline exceeded"),
    RuntimeError("DEADLINE_EXCEEDED: UNAVAILABLE"), MemoryError(),
    ValueError("bad rank")]


def test_classify_gives_the_reference_answers():
    ref = {type(e): getattr(rchaos, type(e).__name__, None)
           for e in REFERENCE_CASES}
    for exc in REFERENCE_CASES:
        rtype = ref[type(exc)]
        rexc = (rtype(str(exc)) if rtype is not None else exc)
        assert classify(exc) == rladder.classify(rexc), exc
    assert classify(ChaosOOM("x")) == "oom"
    assert classify(ValueError("bad rank")) == "fatal"


@pytest.mark.parametrize("exc,kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "oom"),
    (RuntimeError("mttkrp_balanced launch failed: cudaError 2"), "oom"),
    (KernelBuildError("nvcc mttkrp_balanced.cu exited 1: error"),
     "compile"),
    (KernelBuildError("loading libwkv6-0.so failed: undefined symbol"),
     "compile"),
    (RuntimeError("wkv6 launch failed: cudaError 209"), "compile"),
    (RuntimeError("lru_scan launch failed: cudaError 218"), "compile"),
    (RuntimeError("second pass launch failed: cudaError 222"), "compile"),
    (RuntimeError("mttkrp_gather launch failed: cudaError 700"), "fatal"),
    (RuntimeError("mttkrp_balanced launch failed: cudaError 710"),
     "fatal"),
    (RuntimeError("second pass launch failed: cudaError 719"), "fatal"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal")])
def test_classify_the_cards_failures(exc, kind):
    """The card's OOM and build failures are rungs; a sticky error (the
    CUDA context is gone) is never stepped over."""
    assert classify(exc) == kind


def test_ladder_order_deterministic():
    assert BACKEND_LADDER == ("cuda_fused", "cuda", "torch")
    chain, b = [], "cuda_fused"
    while b is not None:
        chain.append(b)
        b = next_backend(b, "cpu")
    assert chain == list(BACKEND_LADDER)
    assert next_backend("ref", "cpu") is None
    assert next_backend("pallas_fused", "cpu") is None


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda")])
def test_card_ladder_ends_at_the_last_kernel_backend(device):
    """On the card no rung hands the tensors to plain PyTorch: the ladder
    is ``CARD_LADDER`` and ends at ``cuda``."""
    assert CARD_LADDER == ("cuda_fused", "cuda")
    assert next_backend("cuda_fused", device) == "cuda"
    assert next_backend("cuda", device) is None
    assert next_backend("torch", device) is None


def test_backoff_bitwise_the_reference():
    for kw in (dict(), dict(backoff_base_s=0.01, backoff_cap_s=0.05,
                            jitter=0.5, seed=3),
               dict(jitter=0.0), dict(seed=11, jitter=1.0)):
        p, rp = LadderPolicy(**kw), rladder.LadderPolicy(**kw)
        for token in ("t", ("upload", 1, 2), ""):
            got = [backoff_delay(p, a, token=token) for a in range(8)]
            want = [rladder.backoff_delay(rp, a, token=token)
                    for a in range(8)]
            assert got == want
            assert all(0 <= d <= p.backoff_cap_s for d in got)
    p = LadderPolicy(seed=3)
    assert backoff_delay(p, 0, token="other") != backoff_delay(p, 0, "t")


def test_resolve_policy_and_ambient():
    assert resolve_policy(None) is None
    assert resolve_policy(False) is None
    assert resolve_policy(True) is DEFAULT_POLICY
    p = LadderPolicy(max_retries=7)
    assert resolve_policy(p) is p
    with pytest.raises(TypeError):
        resolve_policy("yes")
    try:
        install_ambient(p)
        assert ladder.ambient() is p
        assert resolve_policy(None) is p
        assert resolve_policy(False) is None
    finally:
        uninstall_ambient()
    assert resolve_policy(None) is None


@pytest.mark.parametrize("value", [
    "upload_fail=1,oom_chunk=3,kill_sweep=2,compile_fail=cuda_fused|cuda,"
    "corrupt_blob,seed=7",
    "oom_resident,nan_sweep=4,upload_fail_times=3",
    "corrupt_blob=0,oom_resident=false",
    "exchange_fail=0,device_lost=2,device_lost_n=2,dist_transient=1,"
    "dist_transient_times=3"])
def test_chaos_from_env_bitwise_the_reference(value):
    spec = chaos.from_env(value)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        rchaos.from_env(value))
    with pytest.raises(ValueError):
        chaos.from_env("explode=1")


@pytest.mark.parametrize("value", [
    "1", "default", "max_retries=7,backoff_base_s=0.001",
    "seed=5,jitter=0.25,max_budget_halvings=2"])
def test_ladder_from_env_bitwise_the_reference(value):
    assert dataclasses.asdict(ladder.from_env(value)) == \
        dataclasses.asdict(rladder.from_env(value))
    with pytest.raises(ValueError):
        ladder.from_env("not_a_knob=1")


def test_fingerprint_and_digest_bitwise_the_reference():
    idx, val, dims = _coo()
    key = np.arange(8, dtype=np.uint32)
    for kw in (dict(), dict(config="cfg", key=key, start_mode=2,
                            extra="stream")):
        assert fingerprint(idx, val, dims, 5, **kw) == \
            rsnapshot.fingerprint(idx, val, dims, 5, **kw)
    arrays = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
              "a": np.ones(4, np.int64), "m": np.frombuffer(b"{}", np.uint8)}
    assert payload_digest(arrays) == rsnapshot.payload_digest(arrays)
    assert payload_digest(dict(reversed(arrays.items()))) != \
        payload_digest(arrays)


def test_chaos_hooks_fire_once_and_count():
    install(ChaosSpec(oom_chunk=1, upload_fail=0, upload_fail_times=2,
                      compile_fail=("cuda",), nan_sweep=0))
    cz = chaos.active()
    cz.on_chunk_compute(0, 0)
    with pytest.raises(ChaosOOM):
        cz.on_chunk_compute(0, 1)
    cz.on_chunk_compute(0, 1)                 # fired once
    for attempt in range(2):
        with pytest.raises(ChaosUploadError):
            cz.on_upload(0, 0, attempt)
    cz.on_upload(0, 0, 2)                     # failures used up
    cz.on_upload(0, 1, 0)                     # another ordinal
    cz.on_dispatch("cuda_fused")
    with pytest.raises(ChaosCompileError):
        cz.on_dispatch("cuda")
    f = [torch.ones(3, 2), torch.ones(2, 2)]
    out = cz.mangle_factors(0, f)
    assert torch.isnan(out[0][0, 0]) and not torch.isnan(f[0]).any()
    assert cz.mangle_factors(0, f) is f       # once
    inj = obs.REGISTRY.metrics()["chaos_injections"].as_dict()
    assert inj["oom_chunk"] >= 1 and inj["upload_fail"] >= 2


# --------------------------------------------------------------------------
# Snapshot store: round trip, crossover with the reference, quarantine.
# --------------------------------------------------------------------------
def test_snapshot_roundtrip_and_gc(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=2)
    idx, val, dims = _coo()
    fp = fingerprint(idx, val, dims, 5)
    factors = _factors(dims)
    lam = torch.ones(5)
    for sweep in (1, 2, 3):
        store.save(fp, sweep, factors, lam, fits=[0.1] * sweep)
    snap = store.latest(fp)
    assert snap is not None and snap.sweep == 3 and snap.fingerprint == fp
    for a, b in zip(snap.factors, factors):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(snap.lam, lam.numpy())
    assert snap.fits == [0.1, 0.1, 0.1]
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".npz")]) == 2
    assert store.latest(fingerprint(idx, val, dims, 6)) is None
    (row0, data), = factor_shards(factors[0])
    assert row0 == 0 and np.array_equal(data, factors[0].numpy())


def test_reference_blobs_v1_and_v2_load_in_the_port(tmp_path):
    from repro.engine.dist import DistConfig
    from repro.launch.mesh import make_mesh

    idx, val, dims = _coo()
    fp = fingerprint(idx, val, dims, 5)
    factors = [f.numpy() for f in _factors(dims)]
    lam = np.linspace(1, 2, 5).astype(np.float32)
    rstore = rsnapshot.SnapshotStore(str(tmp_path))
    rstore.save(fp, 1, factors, lam, fits=[0.25])
    dist = DistConfig(exchange="all_gather")
    rstore.save(fp, 2, factors, lam, fits=[0.25, 0.5],
                mesh=make_mesh((1,), ("data",)), dist=dist)
    store = SnapshotStore(str(tmp_path))
    v2 = store.latest(fp)
    assert v2.sweep == 2 and v2.fits == [0.25, 0.5]
    assert v2.mesh == {"n_dev": 1, "axes": {"data": 1}, "platform": "cpu"}
    assert v2.dist == repr(dist)
    v1 = store.load(str(tmp_path / sorted(
        n for n in os.listdir(tmp_path) if "sweep000001" in n)[0]))
    for snap in (v1, v2):
        for a, b in zip(snap.factors, factors):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(snap.lam, lam)
    assert v1.mesh is None and v1.dist is None


def test_reference_multi_shard_v2_reassembles_in_the_port(tmp_path):
    full = np.arange(48, dtype=np.float32).reshape(12, 4)

    class _Shard:
        def __init__(self, row0, row1):
            self.index = (slice(row0, row1), slice(None))
            self.data = full[row0:row1]

    class _Sharded:
        shape, dtype = full.shape, full.dtype
        addressable_shards = [_Shard(6, 12), _Shard(0, 6), _Shard(6, 12)]

    class _Mesh:
        devices = np.array(jax.devices()[:1])
        shape = {"data": 1}

    fp = "ab" * 32
    rsnapshot.SnapshotStore(str(tmp_path)).save(
        fp, 1, [_Sharded()], np.ones(4, np.float32), mesh=_Mesh())
    snap = SnapshotStore(str(tmp_path)).latest(fp)
    np.testing.assert_array_equal(snap.factors[0], full)


def test_port_blob_loads_in_the_reference(tmp_path):
    idx, val, dims = _coo()
    fp = fingerprint(idx, val, dims, 4)
    factors = _factors(dims, rank=4)
    SnapshotStore(str(tmp_path)).save(fp, 3, factors, torch.ones(4),
                                      fits=[0.1, 0.2, 0.3])
    snap = rsnapshot.SnapshotStore(str(tmp_path)).latest(fp)
    assert snap.sweep == 3 and snap.fits == [0.1, 0.2, 0.3]
    for a, b in zip(snap.factors, factors):
        np.testing.assert_array_equal(a, b.numpy())


def test_snapshot_corrupt_quarantine_falls_back(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=3)
    idx, val, dims = _coo()
    fp = fingerprint(idx, val, dims, 5)
    factors = _factors(dims)
    store.save(fp, 1, factors, torch.ones(5))
    newest = store.save(fp, 2, factors, torch.ones(5))
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    snap = store.latest(fp)
    assert snap is not None and snap.sweep == 1
    assert store.corrupt == 1
    assert os.path.exists(newest + ".corrupt")
    events = obs.REGISTRY.metrics()["snapshot_events"].as_dict()
    assert events["corrupt"] >= 1


# --------------------------------------------------------------------------
# Checkpoint/resume, resident and streamed.
# --------------------------------------------------------------------------
def test_cp_als_resume_bitwise(tmp_path):
    t = _tensor()
    full = cp_als(t, 4, iters=6, config=_cfg())
    half = cp_als(t, 4, iters=3, config=_cfg(), checkpoint=str(tmp_path))
    resumed = cp_als(t, 4, iters=6, config=_cfg(), checkpoint=str(tmp_path),
                     resume=True)
    assert resumed.fits[:3] == half.fits
    assert _equal(full.factors, resumed.factors)
    assert torch.equal(full.lam, resumed.lam)
    assert full.fits == resumed.fits
    # another start (other initial factors) never resumes from these
    other = cp_als(t, 4, iters=6, config=_cfg(), checkpoint=str(tmp_path),
                   resume=True, generator=torch.Generator().manual_seed(9))
    assert len(other.fits) == 6 and other.fits != full.fits


def test_cp_als_stream_resume_bitwise(tmp_path):
    t = _tensor()
    config = _cfg(chunk_nnz=128)
    full = cp_als_stream(t, 4, iters=6, config=config)
    cp_als_stream(t, 4, iters=3, config=config, checkpoint=str(tmp_path),
                  checkpoint_every=2)
    resumed = cp_als_stream(t, 4, iters=6, config=config,
                            checkpoint=SnapshotStore(str(tmp_path)),
                            resume=True)
    assert _equal(full.factors, resumed.factors)
    assert full.fits == resumed.fits


def test_reference_snapshot_resumes_in_the_port(tmp_path):
    """The ROADMAP gate of item 9 (tolerance in the module docstring)."""
    idx, val, dims = _coo()
    rank = 4
    rt = rbuild(idx, val, dims, rows_pp=8)
    rcfg = RConfig(backend="xla")
    init = [np.asarray(f) for f in
            rinit_factors(jax.random.PRNGKey(0), dims, rank)]
    ref3 = rcp_als(rt, rank, iters=3, config=rcfg)
    ref6 = rcp_als(rt, rank, iters=6, config=rcfg)
    t = build_flycoo(idx, val, dims, rows_pp=8)
    cfg = _cfg()
    fp = fingerprint(t.indices, t.values, t.dims, rank, config=cfg,
                     key=init_key(init), extra="resident")
    rsnapshot.SnapshotStore(str(tmp_path)).save(
        fp, 3, [np.asarray(f) for f in ref3.factors], np.asarray(ref3.lam),
        ref3.fits)
    got = cp_als(t, rank, iters=6, config=cfg, factors=init,
                 checkpoint=str(tmp_path), resume=True)
    assert got.fits[:3] == [float(f) for f in ref3.fits]
    np.testing.assert_allclose(got.fits, ref6.fits, rtol=0, atol=FIT_TOL)
    for a, b in zip(got.factors, ref6.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FACTOR_TOL)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(ref6.lam),
                               **FACTOR_TOL)
    assert obs.REGISTRY.metrics()["snapshot_events"]["load"] >= 1


def test_make_engine_resume_shape_guard():
    idx, val, dims = _coo()
    wrong = Snapshot(fingerprint="0" * 64, sweep=1,
                     factors=[np.zeros((d + 1, 4), np.float32)
                              for d in dims],
                     lam=np.ones(4, np.float32), fits=[], path="x")
    with pytest.raises(ValueError, match="does not match this problem"):
        make_engine((idx, val, dims), PlanSpec(device="cpu"), resume=wrong)
    ok = Snapshot(fingerprint="0" * 64, sweep=1,
                  factors=[np.zeros((d, 4), np.float32) for d in dims],
                  lam=np.ones(4, np.float32), fits=[], path="x")
    assert make_engine((idx, val, dims), PlanSpec(device="cpu"),
                       resume=ok) is not None


_KILL_SCRIPT = """
import sys
import numpy as np
import torch
from repro_torch.core import build_flycoo, cp_als
from repro_torch.engine import ExecutionConfig

dims = (29, 23, 19)
rng = np.random.default_rng(0)
idx = np.unique(np.stack([rng.integers(0, d, 300) for d in dims], 1)
                .astype(np.int64), axis=0)
val = rng.standard_normal(len(idx)).astype(np.float32)
t = build_flycoo(idx, val, dims, rows_pp=8)
r = cp_als(t, 4, iters=6, config=ExecutionConfig(device="cpu", rows_pp=8),
           checkpoint=sys.argv[1], resume=(sys.argv[2] == "resume"))
np.savez(sys.argv[3], *[f.numpy() for f in r.factors],
         lam=r.lam.numpy(), fits=np.asarray(r.fits))
"""


def _run_als_subprocess(ckpt_dir, out, mode, chaos_env=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop(chaos.ENV_VAR, None)
    env.pop(ladder.ENV_VAR, None)
    if chaos_env:
        env[chaos.ENV_VAR] = chaos_env
    return subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT, ckpt_dir, mode, out],
        env=env, capture_output=True, text=True, timeout=300)


def test_kill_sweep_resume_bitwise(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    clean = str(tmp_path / "clean.npz")
    resumed = str(tmp_path / "resumed.npz")
    r = _run_als_subprocess(ckpt + "_unused", clean, "fresh")
    assert r.returncode == 0, r.stderr
    r = _run_als_subprocess(ckpt, os.devnull, "fresh",
                            chaos_env="kill_sweep=3")
    assert r.returncode == -signal.SIGKILL
    assert os.listdir(ckpt), "no snapshot survived the kill"
    r = _run_als_subprocess(ckpt, resumed, "resume")
    assert r.returncode == 0, r.stderr
    with np.load(clean) as a, np.load(resumed) as b:
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# --------------------------------------------------------------------------
# The stream's rungs.
# --------------------------------------------------------------------------
def test_stream_oom_halves_chunk_budget_bitwise():
    t = _tensor()
    factors = _factors(t.dims)
    config = _cfg(chunk_nnz=512)
    outs_clean, _ = stream_all_modes(stream_init(t, config), factors)
    install(ChaosSpec(oom_chunk=2))
    outs, ss = stream_all_modes(stream_init(t, config), factors,
                                policy=DEFAULT_POLICY)
    assert _equal(outs_clean, outs)
    assert ss.config.chunk_nnz is not None and ss.config.chunk_nnz < 512
    assert ss.stats.budget_halvings == 1
    assert ss.stats.as_row()["budget_halvings"] == 1
    assert any(k.startswith("oom:") and k != "oom:full->stream"
               for k in _degradations())
    # the replanned chunks carry their own tables at the resident cap
    assert ss.plan.target_slots == ss.config.chunk_nnz
    assert sum(len(c) for c in ss.chunks) == ss.plan.total_chunks


def test_stream_oom_without_policy_raises():
    t = _tensor()
    install(ChaosSpec(oom_chunk=0))
    with pytest.raises(ChaosOOM):
        stream_all_modes(stream_init(t, _cfg(chunk_nnz=512)),
                         _factors(t.dims))


def test_stream_replan_goes_through_plan_cache():
    t = _tensor()
    cache = PlanCache()
    cfg = _cfg(chunk_nnz=256)
    p1 = plan_stream_cached(t, cfg, cache=cache)
    assert plan_stream_cached(t, cfg, cache=cache) is p1
    half = _cfg(chunk_nnz=128)
    plan_stream_cached(t, half, cache=cache)
    p4 = plan_stream_cached(t, half, cache=cache)
    assert cache.stats()["stream_misses"] == 2
    assert cache.stats()["stream_hits"] == 2
    assert p4.chunks[0].nchunks >= p1.chunks[0].nchunks
    assert plan_stream_cached(t, cfg, cache=False) is not p1


@pytest.mark.parametrize("backend", ["cuda_fused", "cuda"])
def test_stream_backend_rung_replans_tables(backend):
    """A build failure steps the stream's backend down; the replan swaps
    the ring's fields and the dedup / work tables for the new backend,
    and the rotation matches the next rung's own stream."""
    t = _tensor()
    factors = _factors(t.dims)
    nb = next_backend(backend, "cpu")
    want, _ = stream_all_modes(
        stream_init(t, _cfg(backend=nb, chunk_nnz=128)), factors)
    install(ChaosSpec(compile_fail=(backend,)))
    outs, ss = stream_all_modes(
        stream_init(t, _cfg(backend=backend, chunk_nnz=128)), factors,
        policy=DEFAULT_POLICY)
    assert ss.config.backend == nb and ss.stats.backend_steps == 1
    assert (ss.tables[0] is not None) == ss.plan.tables
    for a, b in zip(outs, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert _degradations()[f"compile:{backend}->{nb}"] >= 1


def test_upload_retry_bitwise_and_counted():
    t = _tensor()
    config = _cfg(chunk_nnz=128)
    factors = _factors(t.dims)
    outs_clean, _ = stream_all_modes(stream_init(t, config), factors)
    install(ChaosSpec(upload_fail=1, upload_fail_times=2))
    policy = LadderPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3)
    outs, ss = stream_all_modes(stream_init(t, config), factors,
                                policy=policy)
    assert _equal(outs_clean, outs)
    assert ss.stats.upload_retries == 2
    assert ss.stats.as_row()["upload_retries"] == 2
    assert obs.REGISTRY.metrics()["resilience_retries"]["stream.upload"] >= 2


def test_upload_retries_exhausted_raises():
    t = _tensor()
    install(ChaosSpec(upload_fail=0, upload_fail_times=10))
    policy = LadderPolicy(max_retries=2, backoff_base_s=1e-4,
                          backoff_cap_s=1e-3)
    with pytest.raises(ChaosUploadError):
        stream_all_modes(stream_init(t, _cfg(chunk_nnz=128)),
                         _factors(t.dims), policy=policy)


def test_plan_spec_ladder_hook():
    """``PlanSpec(ladder=...)`` and the ambient policy both feed the
    factory's residency rung; ``ladder=False`` in the spec wins."""
    idx, val, dims = _coo()
    install(ChaosSpec(oom_resident=True))
    state = make_engine((idx, val, dims),
                        PlanSpec(device="cpu", chunk_nnz=128, ladder=True))
    assert isinstance(state, StreamState)
    install(ChaosSpec(oom_resident=True))
    try:
        install_ambient(DEFAULT_POLICY)
        state = make_engine((idx, val, dims),
                            PlanSpec(device="cpu", chunk_nnz=128))
        assert isinstance(state, StreamState)
        install(ChaosSpec(oom_resident=True))
        with pytest.raises(ChaosOOM):
            make_engine((idx, val, dims),
                        PlanSpec(device="cpu", ladder=False))
    finally:
        uninstall_ambient()


# --------------------------------------------------------------------------
# The backend ladder in cp_als.
# --------------------------------------------------------------------------
def test_backend_ladder_lands_on_the_next_rungs_run():
    t = _tensor()
    ref = cp_als(t, 4, iters=4, config=_cfg(backend="torch"))
    install(ChaosSpec(compile_fail=("cuda_fused", "cuda")))
    res = cp_als(t, 4, iters=4, config=_cfg(backend="cuda_fused"),
                 ladder=True)
    assert _equal(ref.factors, res.factors) and ref.fits == res.fits
    degr = _degradations()
    assert degr["compile:cuda_fused->cuda"] >= 1
    assert degr["compile:cuda->torch"] >= 1


def test_build_failure_at_mode_1_restores_the_sweep(monkeypatch):
    """The eager rotation folds mode 0 before mode 1 fails: the rung must
    restore the sweep's starting factors and rebuild the state under the
    next backend, so the result is that backend's own run."""
    t = _tensor()
    want = cp_als(t, 4, iters=3, config=_cfg(backend="cuda"))
    step = engine_api._mode_step
    calls = []

    def failing(state, layout3, factors, d):
        if state.config.backend == "cuda_fused" and d == 1:
            calls.append(d)
            raise KernelBuildError("nvcc mttkrp_balanced.cu exited 1")
        return step(state, layout3, factors, d)

    monkeypatch.setattr(engine_api, "_mode_step", failing)
    before = _degradations().get("compile:cuda_fused->cuda", 0)
    got = cp_als(t, 4, iters=3, config=_cfg(backend="cuda_fused"),
                 ladder=True)
    assert calls == [1]
    assert _degradations()["compile:cuda_fused->cuda"] == before + 1
    for a, b in zip(got.factors, want.factors):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.fits, want.fits, rtol=0, atol=1e-6)
    with pytest.raises(KernelBuildError):
        cp_als(t, 4, iters=1, config=_cfg(backend="cuda_fused"))


def test_backend_ladder_off_raises_and_fatal_is_not_stepped(monkeypatch):
    t = _tensor()
    install(ChaosSpec(compile_fail=("torch",)))
    with pytest.raises(ChaosCompileError, match="injected kernel build"):
        cp_als(t, 4, iters=2, config=_cfg(backend="torch"))
    uninstall()

    def sticky(*a, **k):
        raise RuntimeError("mttkrp_balanced launch failed: cudaError 700")

    monkeypatch.setattr(engine_api, "_mode_step", sticky)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        cp_als(t, 4, iters=1, config=_cfg(backend="cuda_fused"),
               ladder=True)


# --------------------------------------------------------------------------
# NaN burst, torn plan-cache blob, the factory's residency rung.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("streamed", [False, True])
def test_nan_rollback_recovers(streamed):
    t = _tensor()
    install(ChaosSpec(nan_sweep=2))
    if streamed:
        res = cp_als_stream(t, 4, iters=5, config=_cfg(chunk_nnz=128),
                            ladder=True)
    else:
        res = cp_als(t, 4, iters=5, config=_cfg(), ladder=True)
    assert all(torch.isfinite(f).all() for f in res.factors)
    assert torch.isfinite(res.lam).all()
    assert len(res.fits) == 5 and np.isfinite(res.fits).all()
    assert obs.REGISTRY.metrics()["resilience_recoveries"][
        "nan_rollback"] >= 1


@pytest.mark.parametrize("streamed", [False, True])
def test_nan_persisting_through_the_replay_raises(streamed, monkeypatch):
    """Both tiers run one sweep loop: a burst that the ridge replay does
    not clear raises, after one rollback, instead of checkpointing
    non-finite factors."""
    from repro_torch.core import cpd

    monkeypatch.setattr(cpd._guard, "all_finite", lambda *a: False)
    t = _tensor()
    before = obs.REGISTRY.metrics().get("resilience_recoveries", {}).get(
        "nan_rollback", 0)
    with pytest.raises(FloatingPointError, match="persisted"):
        if streamed:
            cp_als_stream(t, 4, iters=2, config=_cfg(chunk_nnz=128),
                          ladder=True)
        else:
            cp_als(t, 4, iters=2, config=_cfg(), ladder=True)
    assert obs.REGISTRY.metrics()["resilience_recoveries"][
        "nan_rollback"] == before + 1


def test_nan_without_ladder_reaches_results():
    t = _tensor()
    install(ChaosSpec(nan_sweep=1))
    res = cp_als(t, 4, iters=3, config=_cfg())
    assert np.isnan(res.fits[1])


def test_plancache_corrupt_blob_quarantine_and_selfheal(tmp_path):
    idx, val, dims = _coo()
    install(ChaosSpec(corrupt_blob=True))
    t1 = PlanCache(path=str(tmp_path)).get_tensor(idx, val, dims, rows_pp=8)
    uninstall()
    c2 = PlanCache(path=str(tmp_path))
    t2 = c2.get_tensor(idx, val, dims, rows_pp=8)
    assert c2.stats()["disk_corrupt"] == 1
    assert any(n.endswith(".corrupt") for n in os.listdir(tmp_path))
    np.testing.assert_array_equal(t1.values, t2.values)
    c3 = PlanCache(path=str(tmp_path))
    c3.get_tensor(idx, val, dims, rows_pp=8)
    assert c3.stats()["disk_corrupt"] == 0
    assert c3.stats()["disk_loads"] == 1


def test_factory_resident_oom_falls_back_to_stream():
    idx, val, dims = _coo()
    install(ChaosSpec(oom_resident=True))
    state = make_engine((idx, val, dims),
                        PlanSpec(device="cpu", chunk_nnz=128), ladder=True)
    assert isinstance(state, StreamState)
    assert _degradations()["oom:full->stream"] >= 1
    factors = _factors(dims)
    want, _ = engine_api.all_modes(
        make_engine((idx, val, dims), PlanSpec(device="cpu")), factors)
    got, _ = stream_all_modes(state, factors)
    assert _equal(want, got)


def test_factory_resident_oom_without_ladder_raises():
    idx, val, dims = _coo()
    install(ChaosSpec(oom_resident=True))
    with pytest.raises(ChaosOOM):
        make_engine((idx, val, dims), PlanSpec(device="cpu"))


# --------------------------------------------------------------------------
# The report and the refusals that remain.
# --------------------------------------------------------------------------
def test_resilience_report_pairs_all_injections(tmp_path):
    obs.REGISTRY.reset()
    t = _tensor()
    install(ChaosSpec(upload_fail=1, oom_chunk=4, nan_sweep=1))
    cp_als_stream(t, 4, iters=3, config=_cfg(chunk_nnz=512),
                  ladder=LadderPolicy(backoff_base_s=1e-4,
                                      backoff_cap_s=1e-3),
                  checkpoint=str(tmp_path))
    rep = obs.resilience_report()
    for site in ("upload_fail", "oom_chunk", "nan_burst"):
        assert site in rep["injections"] and site in rep["answered"]
    assert rep["unanswered"] == []
    assert rep["snapshot_events"]["save"] == 3


def test_resilience_report_flags_silent_faults():
    obs.REGISTRY.reset()
    install(ChaosSpec(nan_sweep=0))
    cp_als(_tensor(seed=3), 4, iters=2, config=_cfg())
    assert "nan_burst" in obs.resilience_report()["unanswered"]


@pytest.mark.parametrize("case", ["cp_als", "chaos", "v2"])
def test_distributed_parts_refuse_naming_item_10(case, tmp_path):
    """Item 10 (the distributed tier) is ported, so none of its parts
    refuses any more: ``cp_als`` refuses only a mesh that is not the
    port's ``Mesh`` or a ``ShardingCtx`` (naming both), a spec with
    distributed faults installs, and ``save(mesh=)`` writes the v2
    format. The tier itself is held in ``tests/test_torch_dist.py``."""
    from repro_torch.launch.mesh import make_mesh

    t = _tensor()
    if case == "cp_als":
        with pytest.raises(TypeError, match="Mesh or a repro_torch."
                           "sharding.ShardingCtx"):
            cp_als(t, 4, iters=1, config=_cfg(), mesh=object())
        assert chaos.active() is None
    elif case == "chaos":
        assert install(ChaosSpec(exchange_fail=0)) is chaos.active()
    else:
        mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
        path = SnapshotStore(str(tmp_path)).save(
            "ab" * 32, 1, [np.ones((3, 2))], np.ones(2), mesh=mesh,
            dist="d")
        snap = rsnapshot.SnapshotStore(str(tmp_path)).load(path)
        assert snap.mesh == {"n_dev": 2, "axes": {"data": 2},
                             "platform": "cpu", "distinct": 1}
        assert snap.dist == repr("d")
        np.testing.assert_array_equal(snap.factors[0], np.ones((3, 2)))
    assert not [p for p in (REPO / "src" / "repro_torch").rglob("*.py")
                if "item 10" in p.read_text()]


def test_no_refusal_names_item_9():
    """Item 9 (resilience) is ported: no message in the port names it."""
    pat = re.compile(r"item 9\b")
    hits = [str(p) for p in (REPO / "src" / "repro_torch").rglob("*.py")
            if pat.search(p.read_text())]
    assert hits == []
