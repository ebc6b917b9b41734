"""The port's distributed tier (``repro_torch.engine.dist``,
``core.distributed``, ``launch.mesh``) on the CPU, held against the
reference's (``repro.engine.dist``) on the same inputs.

The reference needs several devices, so its side runs once, in a fresh
interpreter with ``--xla_force_host_platform_device_count=4``
(``tests/test_distributed.py`` does the same), which writes every
artifact the tests read to one ``.npz`` (the module fixture ``ref``).
The port's shards are ``devices=["cpu"] * n`` meshes in this process.

Tolerances. Bitwise: the sharded plans, ``element_devices``, the exchange
schedules, ``exchange_bytes``, the per-shard plan constants, the
sharded layouts and schedule tables of ``shard_state``, every layout
after a transition (the exchange only moves data), the ``permute`` and
``all_gather`` layouts against each other, and, port against port on the
CPU, the distributed chaos rungs and a resume on fewer shards against
the clean run. ``rtol = atol = 1e-5``: each mode's output against the
reference's ``dist_all_modes`` from its factors (float32 sums in
another order than XLA's). ``1e-5``: the ALS fits against the
reference's distributed run from the same initial factors.
"""
import os
import pathlib
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.engine import ExecutionConfig as RConfig
from repro.launch.mesh import make_mesh as rmake_mesh
from repro.resilience import snapshot as rsnapshot
from repro_torch import engine, interop, obs
from repro_torch.core import (DistributedMTTKRP, build_flycoo,
                              build_sharded_flycoo, cp_als)
from repro_torch.core.cpd import init_key
from repro_torch.engine import (DistConfig, DistState, ExecutionConfig,
                                PlanSpec, make_engine)
from repro_torch.engine import dist
from repro_torch.engine.api import mode_work
from repro_torch.engine.backends import fused_lidx
from repro_torch.kernels import mttkrp as kmt
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.resilience import (ChaosSpec, LadderPolicy, SnapshotStore,
                                    chaos, fingerprint, install, ladder,
                                    uninstall)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
FIT_ATOL = 1e-5
# name: (dims, nnz, schedule, seed, every start mode and every step)
CASES = {"a": ((24, 18, 12), 600, "compact", 0, True),
         "b": ((24, 18, 12), 600, "rect", 1, True),
         "c": ((12, 10, 8, 6), 700, "compact", 2, False),
         "d": ((9, 8, 7, 6, 5), 700, "rect", 3, False)}
GRID = [(c, n) for c in CASES for n in (2, 4)]
STEPPED = [(c, n) for c, n in GRID if CASES[c][4] or n == 2]

_REFERENCE = '''
import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
from repro import engine
from repro.core import init_factors
from repro.core.cpd import cp_als
from repro.core.distributed import build_sharded_flycoo
from repro.engine import ExecutionConfig
from repro.engine import dist as rdist
from repro.launch.mesh import make_mesh

CASES = %r
out = {}


def put(key, a):
    out[key] = np.asarray(a)


def layout(prefix, ds):
    put(prefix + "val", ds.val)
    put(prefix + "idx", ds.idx)
    put(prefix + "alpha", ds.alpha)


for name, (dims, nnz, sched, seed, every) in CASES.items():
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    put(f"{name}_idx", idx)
    put(f"{name}_val", val)
    n = len(dims)
    t = build_sharded_flycoo(idx, val, dims, n_dev=4, rows_pp=4, block_p=8,
                             schedule=sched)
    for d, p in enumerate(t.plans):
        for f in ("block_part", "slot_of_elem", "row_relabel", "part_nnz"):
            put(f"{name}_plan{d}_{f}", getattr(p, f))
        put(f"{name}_plan{d}_ints", [p.kappa, p.rows_pp, p.blocks_pp,
                                     p.nblocks])
    factors = init_factors(jax.random.PRNGKey(1), dims, 8)
    for d, f in enumerate(factors):
        put(f"{name}_factor{d}", f)
    cfg_x = ExecutionConfig(backend="xla")
    cfg_p = ExecutionConfig(backend="pallas_fused")
    for n_dev in (2, 4):
        mesh = make_mesh((n_dev,), ("data",))
        pre = f"{name}_{n_dev}_"
        for p in t.plans:
            put(pre + f"edev{p.mode}", rdist.element_devices(p, n_dev))
        put(pre + "plan_hops", rdist.schedule_for_plans(t.plans, n_dev).hops)
        ds = rdist.shard_state(engine.init(t, cfg_p), mesh)
        layout(pre, ds)
        put(pre + "hops", ds.schedule.hops)
        put(pre + "lstatics", [list(s[:6]) for s in ds.lstatics])
        put(pre + "statics", [list(s[:6]) for s in ds.statics])
        eb = rdist.exchange_bytes(ds.schedule, n, ds.slocs)
        put(pre + "xbytes", [[e["permute_bytes"], e["all_gather_bytes"]]
                             for e in eb])
        for d, ms in enumerate(ds.sched):
            for f in ("bpart", "uidx", "upos", "nuniq"):
                if getattr(ms, f) is not None:
                    put(pre + f"sched{d}_{f}", getattr(ms, f))
        for m in (range(n) if every else (0,)):
            ds = rdist.shard_state(engine.init(t, cfg_x, start_mode=m), mesh)
            for sweep in range(2):
                outs, ds = rdist.dist_all_modes(ds, factors)
                for d in range(n):
                    put(pre + f"out_m{m}_s{sweep}_d{d}", outs[d])
        if every or n_dev == 2:
            ds = rdist.shard_state(engine.init(t, cfg_x), mesh)
            for step in range(n):
                o, ds = rdist.dist_mttkrp(ds, factors)
                put(pre + f"step{step}_out", o)
                layout(pre + f"step{step}_", ds)
    if name == "a":
        mesh22 = make_mesh((2, 2), ("data", "model"))
        ds = rdist.shard_state(engine.init(t, cfg_x), mesh22,
                               rdist.DistConfig(model_axis="model"))
        outs, _ = rdist.dist_all_modes(ds, factors)
        for d in range(n):
            put(f"a_model_out{d}", outs[d])
        mesh4 = make_mesh((4,), ("data",))
        for d, f in enumerate(init_factors(jax.random.PRNGKey(0), dims, 4)):
            put(f"a_als_init{d}", f)
        r3 = cp_als(t, rank=4, iters=3, mesh=mesh4, checkpoint=sys.argv[2])
        r6 = cp_als(t, rank=4, iters=6, mesh=mesh4)
        for tag, r in (("als3", r3), ("als6", r6)):
            put(f"a_{tag}_fits", r.fits)
            put(f"a_{tag}_lam", r.lam)
            for d, f in enumerate(r.factors):
                put(f"a_{tag}_factor{d}", f)
np.savez(sys.argv[1], **out)
''' % (CASES,)


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop(chaos.ENV_VAR, None)
    env.pop(ladder.ENV_VAR, None)
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference artifact of this module, from one child process:
    ``(arrays, checkpoint directory)``."""
    tmp = tmp_path_factory.mktemp("refdist")
    path, ckpt = tmp / "ref.npz", tmp / "ckpt"
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        str(ckpt)], env=_env(), capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, ckpt


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its rotations are many
    small ops, which a thread pool per process slows down many times over
    when the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    uninstall()
    yield
    uninstall()


def _mesh(n):
    return make_mesh((n,), ("data",), devices=["cpu"] * n)


def _cfg(**kw):
    return ExecutionConfig(device="cpu", **kw)


def _tensor(name):
    dims, nnz, sched, seed, _ = CASES[name]
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    return build_sharded_flycoo(idx, val, dims, n_dev=4, rows_pp=4,
                                block_p=8, schedule=sched)


def _factors(R, name, key="factor"):
    n = len(CASES[name][0])
    return [torch.from_numpy(R[f"{name}_{key}{d}"]) for d in range(n)]


def _sharded(name, n_dev, backend="cuda_fused", start_mode=0, **dkw):
    t = _tensor(name)
    state = engine.init(t, _cfg(backend=backend), start_mode=start_mode)
    return t, dist.shard_state(state, _mesh(n_dev), DistConfig(**dkw))


def _cat_sched(ds, d, field):
    parts = [getattr(ms, field) for ms in ds.sched[d]]
    if parts[0] is None:
        return None
    axis = 1 if field in ("uidx", "nuniq") else 0
    return torch.cat(parts, dim=axis).numpy()


def _assert_layout(ds, R, prefix):
    for name, got in zip(("val", "idx", "alpha"), ds.host_layout()):
        np.testing.assert_array_equal(got, R[prefix + name], err_msg=name)


# --------------------------------------------------------------------------
# Host side, bitwise.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASES)
def test_sharded_plans_bitwise(ref, name):
    R, _ = ref
    t = _tensor(name)
    np.testing.assert_array_equal(t.indices, R[f"{name}_idx"])
    for d, p in enumerate(t.plans):
        for f in ("block_part", "slot_of_elem", "row_relabel", "part_nnz"):
            np.testing.assert_array_equal(getattr(p, f),
                                          R[f"{name}_plan{d}_{f}"], err_msg=f)
        assert [p.kappa, p.rows_pp, p.blocks_pp, p.nblocks] == \
            R[f"{name}_plan{d}_ints"].tolist()
        assert p.kappa % 4 == 0


@pytest.mark.parametrize("name,n_dev", GRID)
def test_schedules_bitwise(ref, name, n_dev):
    R, _ = ref
    t = _tensor(name)
    pre = f"{name}_{n_dev}_"
    for p in t.plans:
        np.testing.assert_array_equal(dist.element_devices(p, n_dev),
                                      R[pre + f"edev{p.mode}"])
    sched = dist.schedule_for_plans(t.plans, n_dev)
    assert sched.n_dev == n_dev
    np.testing.assert_array_equal(np.asarray(sched.hops),
                                  R[pre + "plan_hops"])


@pytest.mark.parametrize("name,n_dev", GRID)
def test_shard_state_bitwise(ref, name, n_dev):
    """Layouts, schedule tables, per-shard plan constants, the hop caps,
    ``exchange_bytes`` and the gauge, all bitwise the reference's."""
    R, _ = ref
    _, ds = _sharded(name, n_dev)
    pre = f"{name}_{n_dev}_"
    _assert_layout(ds, R, pre)
    assert [list(s[:6]) for s in ds.lstatics] == R[pre + "lstatics"].tolist()
    assert [list(s[:6]) for s in ds.statics] == R[pre + "statics"].tolist()
    np.testing.assert_array_equal(np.asarray(ds.schedule.hops),
                                  R[pre + "hops"])
    xb = dist.exchange_bytes(ds.schedule, ds.nmodes, ds.slocs)
    assert [[e["permute_bytes"], e["all_gather_bytes"]] for e in xb] == \
        R[pre + "xbytes"].tolist()
    wire = obs.REGISTRY.gauge("dist_exchange_bytes").as_dict()
    assert [wire[f"mode{d}"] for d in range(ds.nmodes)] == \
        [e["permute_bytes"] for e in xb]
    for d in range(ds.nmodes):
        for f in ("bpart", "uidx", "upos", "nuniq"):
            key = pre + f"sched{d}_{f}"
            got = _cat_sched(ds, d, f)
            if key in R:
                np.testing.assert_array_equal(got, R[key], err_msg=key)
            else:
                assert got is None, key
    # relabel: one copy a distinct device (all shards share the CPU)
    assert list(ds.relabel) == [torch.device("cpu")]
    assert ds.devices == (torch.device("cpu"),) * n_dev


@pytest.mark.parametrize("name,n_dev", GRID)
def test_dist_state_from_numpy_equals_shard_state(ref, name, n_dev):
    """The reference's sharded leaves carried across build the port's own
    ``shard_state``: the same layouts, schedule, block-start and work
    tables."""
    R, _ = ref
    t, want = _sharded(name, n_dev)
    pre = f"{name}_{n_dev}_"
    n = len(t.dims)
    sched = [tuple(R.get(pre + f"sched{d}_{f}")
                   for f in ("bpart", "uidx", "upos", "nuniq"))
             for d in range(n)]
    got = interop.dist_state_from_numpy(
        R[pre + "val"], R[pre + "idx"], R[pre + "alpha"],
        [R[f"{name}_plan{d}_row_relabel"] for d in range(n)], sched,
        mode=0, dims=t.dims, statics=want.statics, lstatics=want.lstatics,
        schedule=(n_dev, R[pre + "hops"].tolist()), plans=t.plans,
        mesh=_mesh(n_dev), config=_cfg(backend="cuda_fused"))
    assert got.schedule == want.schedule
    for a, b in zip(got.host_layout(), want.host_layout()):
        np.testing.assert_array_equal(a, b)
    for d in range(n):
        for ga, wa in zip(got.sched[d], want.sched[d]):
            for x, y in zip(ga, wa):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x, y)


@pytest.mark.parametrize("name,n_dev", GRID)
def test_shard_work_tables_list_only_real_blocks(name, n_dev):
    """Each shard's work table passes ``check_work``, lists no block at or
    past the shard's real block count (compact) and no dead block (rect),
    covers every alive slot, and its plain schedule (``chunked_plain``)
    computes the plain EC of the shard."""
    t, ds = _sharded(name, n_dev)
    rng = np.random.default_rng(5)
    factors = tuple(torch.from_numpy(rng.standard_normal((i, 4))
                                     .astype(np.float32)) for i in t.dims)
    for _ in range(ds.nmodes):
        d = ds.mode
        ls = ds.lstatics[d]
        _, per_dev, _, _ = dist._block_geometry(
            ds.statics[d], t.plans[d].block_part, n_dev)
        inputs = tuple(f for w, f in enumerate(factors) if w != d)
        for k in range(n_dev):
            ms = ds.sched[d][k]
            work = kmt.WorkTable(ms.work, ms.wsum)
            kmt.check_work(work, ms.pstart)
            assert kmt.checked_for(work) == (ls.kappa, ls.kappa * ls.blocks_pp
                                             if ls.schedule == "rect"
                                             else ls.nblocks)
            L, alive = dist.shard_layout(ds, k, d)
            v, ix, lrow = L["val"], L["idx"], L["lrow"]
            slots = torch.nonzero(alive).flatten().numpy()
            kmt.check_covers(work, slots, ls.block_p)
            ends = ms.work[:, 2].numpy()
            if ls.schedule == "compact":
                assert ends.max() <= per_dev[k]
            else:
                listed = np.concatenate([np.arange(b0, b1) for b0, b1 in
                                         ms.work[:, 1:3].numpy()])
                assert np.isin(listed, slots // ls.block_p).all()
            if ls.schedule == "compact":
                want = kmt.mttkrp_fused_gather_compact_plain(
                    v, lrow, ms.upos, ms.bpart, ms.uidx, ms.nuniq, inputs,
                    kappa=ls.kappa, rows_pp=ls.rows_pp, nblocks=ls.nblocks,
                    block_p=ls.block_p)
                got = kmt.chunked_plain(
                    v, lrow, ms.upos, ms.bpart, ms.uidx, ms.nuniq, inputs,
                    kappa=ls.kappa, rows_pp=ls.rows_pp, nblocks=ls.nblocks,
                    block_p=ls.block_p, work=work)
            else:
                lidx = fused_lidx(ix, d)
                want = kmt.mttkrp_fused_gather_plain(
                    v, lrow, lidx, inputs, kappa=ls.kappa,
                    rows_pp=ls.rows_pp, blocks_pp=ls.blocks_pp,
                    block_p=ls.block_p)
                got = kmt.chunked_plain_gather(
                    v, lrow, lidx, inputs, kappa=ls.kappa,
                    rows_pp=ls.rows_pp, block_p=ls.block_p, work=work)
            torch.testing.assert_close(got, want, **TOL)
        _, ds = dist.dist_mttkrp(ds, factors)


# --------------------------------------------------------------------------
# Outputs and exchanged layouts against the reference.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["torch", "cuda_fused", "cuda"])
@pytest.mark.parametrize("name,n_dev", GRID)
def test_dist_all_modes_matches_reference(ref, name, n_dev, backend):
    """Every recorded start mode, two sweeps, each mode's output within
    the tolerance of the reference's ``dist_all_modes``; the layout is
    back at its start after each rotation."""
    R, _ = ref
    pre = f"{name}_{n_dev}_"
    factors = _factors(R, name)
    n = len(factors)
    for m in (range(n) if CASES[name][4] else (0,)):
        _, ds = _sharded(name, n_dev, backend, start_mode=m)
        start = ds.host_layout()
        for sweep in range(2):
            outs, ds = dist.dist_all_modes(ds, factors)
            for d in range(n):
                np.testing.assert_allclose(
                    outs[d].numpy(), R[pre + f"out_m{m}_s{sweep}_d{d}"],
                    err_msg=f"start {m} sweep {sweep} mode {d}", **TOL)
        assert ds.mode == m
        for a, b in zip(ds.host_layout(), start):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,n_dev", STEPPED)
def test_dist_mttkrp_steps_layouts_bitwise(ref, name, n_dev):
    """``dist_mttkrp`` stepping through a rotation: each output within the
    tolerance, each layout after a transition bitwise the reference's,
    under both exchanges."""
    R, _ = ref
    pre = f"{name}_{n_dev}_"
    factors = _factors(R, name)
    for exchange in dist.EXCHANGES:
        _, ds = _sharded(name, n_dev, exchange=exchange)
        for step in range(len(factors)):
            out, ds = dist.dist_mttkrp(ds, factors)
            np.testing.assert_allclose(out.numpy(), R[pre + f"step{step}_out"],
                                       **TOL)
            assert ds.mode == (step + 1) % len(factors)
            _assert_layout(ds, R, pre + f"step{step}_")


@pytest.mark.parametrize("name,n_dev", GRID)
def test_permute_and_all_gather_layouts_bitwise(name, n_dev):
    """After each transition the two exchanges leave the same layouts."""
    t = _tensor(name)
    state = engine.init(t, _cfg(backend="torch"))
    rng = np.random.default_rng(2)
    factors = [torch.from_numpy(rng.standard_normal((i, 3))
                                .astype(np.float32)) for i in t.dims]
    ps = dist.shard_state(state, _mesh(n_dev))
    ag = dist.shard_state(state, _mesh(n_dev),
                          DistConfig(exchange="all_gather"))
    for _ in range(len(t.dims)):
        op, ps = dist.dist_mttkrp(ps, factors)
        oa, ag = dist.dist_mttkrp(ag, factors)
        assert torch.equal(op, oa)
        for a, b in zip(ps.host_layout(), ag.host_layout()):
            np.testing.assert_array_equal(a, b)


def test_model_axis_on_a_2x2_mesh(ref):
    R, _ = ref
    factors = _factors(R, "a")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    t = _tensor("a")
    for backend in ("torch", "cuda_fused"):
        ds = dist.shard_state(engine.init(t, _cfg(backend=backend)), mesh,
                              DistConfig(model_axis="model"))
        assert ds.n_dev == 2 and ds.grid.shape == (2, 2)
        outs, ds = dist.dist_all_modes(ds, factors)
        for d in range(3):
            np.testing.assert_allclose(outs[d].numpy(), R[f"a_model_out{d}"],
                                       **TOL)
        with pytest.raises(ValueError, match="full rank"):
            dist.dist_all_modes(ds, factors, fold=lambda *a: a[2:])


@pytest.mark.parametrize("shape,axes,dkw", [
    ((4,), ("data",), {}),
    ((2, 2), ("data", "model"), {"model_axis": "model"})])
def test_shards_on_distinct_devices(shape, axes, dkw):
    """``torch.device("cpu")`` and ``"cpu:0"`` are distinct mesh devices
    on one CPU: the relabel tables go to each once, a rank slice whose
    device is not its shard's takes the layout across (with its sealed
    work table), and the results equal the one-device mesh's bitwise."""
    from repro_torch.resilience import mesh_fingerprint

    t = _tensor("a")
    state = engine.init(t, _cfg(backend="cuda_fused"))
    factors = [torch.ones((i, 4)) for i in t.dims]
    want, _ = dist.dist_all_modes(dist.shard_state(
        state, make_mesh(shape, axes, devices=["cpu"] * 4),
        DistConfig(**dkw)), factors)
    mesh = make_mesh(shape, axes, devices=["cpu", "cpu:0", "cpu:0", "cpu"])
    ds = dist.shard_state(state, mesh, DistConfig(**dkw))
    assert len(ds.relabel) == 2 and mesh_fingerprint(mesh)["distinct"] == 2
    got, _ = dist.dist_all_modes(ds, factors)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_copied_bytes_equal_the_schedule():
    """What a rotation copies between shards is, per transition, ``n_dev``
    times ``exchange_bytes`` (a shard's share): for permute exactly the
    schedule's hop buffers, for all_gather the remote element lists."""
    for name in CASES:
        for n_dev in (2, 4):
            t = _tensor(name)
            state = engine.init(t, _cfg())
            factors = [torch.ones((i, 2)) for i in t.dims]
            for exchange in dist.EXCHANGES:
                ds = dist.shard_state(state, _mesh(n_dev),
                                      DistConfig(exchange=exchange))
                xb = dist.exchange_bytes(ds.schedule, ds.nmodes, ds.slocs)
                counter = obs.REGISTRY.counter("dist_copied_bytes")
                before = counter.as_dict()
                dist.dist_all_modes(ds, factors)
                after = counter.as_dict()
                for e in xb:
                    key = f"{exchange}:mode{e['mode']}"
                    got = after.get(key, 0) - before.get(key, 0)
                    assert got == n_dev * e[f"{exchange}_bytes"], key


def test_rotation_reads_nothing_back(monkeypatch):
    """A distributed rotation calls no ``.cpu()``, ``.item()``,
    ``.tolist()`` or ``synchronize``: every buffer size is static."""
    t = _tensor("c")
    factors = [torch.ones((i, 2)) for i in t.dims]
    calls = []

    def counting(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    for exchange in dist.EXCHANGES:
        ds = dist.shard_state(engine.init(t, _cfg(backend="cuda_fused")),
                              _mesh(4), DistConfig(exchange=exchange))
        with monkeypatch.context() as m:
            for name in ("cpu", "item", "tolist"):
                m.setattr(torch.Tensor, name,
                          counting(name, getattr(torch.Tensor, name)))
            m.setattr(torch.cuda, "synchronize",
                      counting("synchronize", torch.cuda.synchronize))
            dist.dist_all_modes(ds, factors)
        assert calls == [], (exchange, calls)


# --------------------------------------------------------------------------
# Entry points.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dim,n_dev", [(5, 2), (40, 4), (17, 4), (3, 4),
                                       (1000, 8), (9, 3)])
def test_kappa_for_rounds_as_the_reference(dim, n_dev):
    for rows_pp in (4, 7, 512):
        want = None
        try:
            want = RConfig(rows_pp=rows_pp).kappa_for(dim, n_dev)
        except ValueError:
            pass
        cfg = ExecutionConfig(device="cpu", rows_pp=rows_pp,
                              min_partitions=1)
        if want is None:
            with pytest.raises(ValueError, match="fewer rows"):
                cfg.kappa_for(dim, 3, n_dev=n_dev)
        else:
            assert cfg.kappa_for(dim, 3, n_dev=n_dev) == want
            assert cfg.kappa_for(dim, 3) == RConfig(
                rows_pp=rows_pp).kappa_for(dim)
    fixed = dict(kappa_policy="fixed", kappa=6)
    if dim >= n_dev:
        assert ExecutionConfig(device="cpu", **fixed).kappa_for(
            dim, 3, n_dev=n_dev) == RConfig(**fixed).kappa_for(dim, n_dev)


def test_make_mesh_and_surviving_mesh():
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="cards"):
            make_mesh((64,), ("data",))
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 2, "model": 2}
    assert mesh.distinct() == (torch.device("cpu"),) and mesh.size == 4
    with pytest.raises(ValueError, match="takes 4 devices"):
        make_mesh((4,), ("data",), devices=["cpu"] * 3)
    # the survivors: the lowest positions, as many as divide every kappa
    for n, lost, kappas, want in ((4, 2, (8, 12), 2), (4, 1, (8, 12), 2),
                                  (4, 1, (6, 9), 3), (8, 3, (16, 24, 8), 4)):
        got = dist.surviving_mesh(_mesh(n), lost, kappas)
        assert got.shape == {"data": want}, (n, lost, kappas)
    with pytest.raises(RuntimeError, match="no viable mesh"):
        dist.surviving_mesh(_mesh(2), 2, (4,))


def test_shard_state_refuses_other_meshes():
    t = _tensor("a")
    state = engine.init(t, _cfg())
    with pytest.raises(TypeError, match="Mesh or a repro_torch.sharding."
                       "ShardingCtx"):
        dist.shard_state(state, object())
    with pytest.raises(ValueError, match="no axis"):
        dist.shard_state(state, _mesh(2), DistConfig(data_axis="x"))
    odd = build_flycoo(t.indices, t.values, t.dims, kappa=[3, 3, 3],
                       block_p=8)
    with pytest.raises(ValueError, match="not divisible"):
        dist.shard_state(engine.init(odd, _cfg()), _mesh(2))


def test_make_engine_with_a_mesh():
    """A raw COO tensor planned with kappas rounded to the shard count,
    the spec's exchange, outputs as the single-device engine's; the
    stream tier refuses a mesh; ``auto`` resolves to the resident tier."""
    t = _tensor("c")
    coo = (t.indices, t.values, t.dims)
    factors = [torch.ones((i, 3)) for i in t.dims]
    spec = PlanSpec(device="cpu", backend="cuda_fused", rows_pp=4,
                    block_p=8, min_partitions=1, exchange="all_gather")
    ds = make_engine(coo, spec, mesh=_mesh(4), cache=False)
    assert isinstance(ds, DistState) and ds.dist.exchange == "all_gather"
    assert all(s.kappa % 4 == 0 for s in ds.statics)
    outs, _ = dist.dist_all_modes(ds, factors)
    want, _ = engine.all_modes(engine.init(_tensor("c"), _cfg()), factors)
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    auto = make_engine(coo, PlanSpec(device="cpu", rows_pp=4, block_p=8,
                                     residency="auto",
                                     device_budget_bytes=1),
                       mesh=_mesh(2), cache=False)
    assert isinstance(auto, DistState)
    with pytest.raises(ValueError, match="single-device tier"):
        make_engine(coo, PlanSpec(device="cpu", residency="stream"),
                    mesh=_mesh(2))
    assert spec.to_dist_config("data") == DistConfig(exchange="all_gather")


def test_distributed_mttkrp_shim():
    t = _tensor("a")
    factors = [torch.ones((i, 2)) for i in t.dims]
    with pytest.warns(DeprecationWarning):
        exe = DistributedMTTKRP(t, _mesh(4), config=_cfg())
    outs = exe.all_modes(factors)
    want, _ = engine.all_modes(engine.init(t, _cfg()), factors)
    first = exe.step(factors)
    assert exe.current_mode == 1
    exe.reset()
    assert exe.current_mode == 0
    torch.testing.assert_close(first, want[0], **TOL)
    for a, b in zip(outs, want):
        torch.testing.assert_close(a, b, **TOL)


# --------------------------------------------------------------------------
# CPD-ALS over the mesh, the rungs and resume.
# --------------------------------------------------------------------------
def test_cp_als_mesh_fits_match_reference(ref):
    R, _ = ref
    t = _tensor("a")
    init = _factors(R, "a", "als_init")
    for n_dev in (4, 2):
        got = cp_als(t, 4, iters=6, config=_cfg(), factors=init,
                     mesh=_mesh(n_dev))
        np.testing.assert_allclose(got.fits, R["a_als6_fits"], rtol=0,
                                   atol=FIT_ATOL)
    one = cp_als(t, 4, iters=6, config=_cfg(), factors=init)
    np.testing.assert_allclose(one.fits, got.fits, rtol=0, atol=FIT_ATOL)
    with pytest.raises(ValueError, match="without a mesh"):
        cp_als(t, 4, iters=1, config=_cfg(), dist=DistConfig())


def _clean(t, iters, n_dev=4):
    return cp_als(t, 4, iters=iters, config=_cfg(), mesh=_mesh(n_dev))


def _bitwise(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a.factors, b.factors))
    assert torch.equal(a.lam, b.lam)
    assert a.fits == b.fits


POLICY = LadderPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3)


def test_exchange_rung_bitwise():
    t = _tensor("a")
    clean = _clean(t, 4)
    obs.REGISTRY.reset()
    install(ChaosSpec(exchange_fail=1))     # the 2nd permute dispatch
    res = cp_als(t, 4, iters=4, config=_cfg(), mesh=_mesh(4),
                 ladder=POLICY)
    _bitwise(clean, res)
    degr = obs.REGISTRY.counter("resilience_degradations").as_dict()
    assert degr == {"exchange:permute->all_gather": 1}
    rep = obs.resilience_report()
    assert "exchange_fail" in rep["answered"] and rep["unanswered"] == []


def test_device_loss_shrinks_the_mesh_bitwise(tmp_path):
    t = _tensor("a")
    clean = _clean(t, 5)
    obs.REGISTRY.reset()
    install(ChaosSpec(device_lost=2, device_lost_n=2))
    res = cp_als(t, 4, iters=5, config=_cfg(), mesh=_mesh(4), ladder=POLICY,
                 checkpoint=str(tmp_path))
    _bitwise(clean, res)
    degr = obs.REGISTRY.counter("resilience_degradations").as_dict()
    assert degr == {"device_lost:4->2": 1}
    assert obs.resilience_report()["unanswered"] == []
    snap = SnapshotStore(str(tmp_path)).latest(fingerprint(
        t.indices, t.values, t.dims, 4, config=_cfg(),
        key=init_key(None, None), extra="dist"))
    assert snap.sweep == 5 and snap.mesh["axes"] == {"data": 2}
    install(ChaosSpec(device_lost=0))
    with pytest.raises(Exception, match="injected loss"):
        cp_als(t, 4, iters=2, config=_cfg(), mesh=_mesh(4))


def test_dist_transient_retries_bitwise():
    t = _tensor("a")
    clean = _clean(t, 3, n_dev=2)
    obs.REGISTRY.reset()
    install(ChaosSpec(dist_transient=1, dist_transient_times=2))
    res = cp_als(t, 4, iters=3, config=_cfg(), mesh=_mesh(2), ladder=POLICY)
    _bitwise(clean, res)
    retries = obs.REGISTRY.counter("resilience_retries").as_dict()
    assert retries == {"dist.dispatch": 2}
    assert "dist_transient" in obs.resilience_report()["answered"]


_KILL = '''
import sys
import numpy as np
from repro_torch.core import build_sharded_flycoo, cp_als
from repro_torch.engine import ExecutionConfig
from repro_torch.launch.mesh import make_mesh

dims = (24, 18, 12)
rng = np.random.default_rng(0)
idx = np.unique(np.stack([rng.integers(0, d, 600) for d in dims], 1)
                .astype(np.int32), axis=0)
val = rng.standard_normal(len(idx)).astype(np.float32)
# always the 4-shard build: its kappas divide every smaller mesh
t = build_sharded_flycoo(idx, val, dims, n_dev=4, rows_pp=4, block_p=8)
n = int(sys.argv[4])
r = cp_als(t, 4, iters=6, config=ExecutionConfig(device="cpu"),
           mesh=make_mesh((n,), ("data",), devices=["cpu"] * n),
           checkpoint=sys.argv[1], resume=sys.argv[2] == "resume")
np.savez(sys.argv[3], *[f.numpy() for f in r.factors], lam=r.lam.numpy(),
         fits=np.asarray(r.fits))
'''


def _kill_child(ckpt, out, mode, n, chaos_env=None):
    env = dict(_env(), OMP_NUM_THREADS="1")   # as ``_one_thread``
    if chaos_env:
        env[chaos.ENV_VAR] = chaos_env
    return subprocess.run([sys.executable, "-c", _KILL, str(ckpt), mode,
                           str(out), str(n)], env=env, capture_output=True,
                          text=True, timeout=300)


def test_kill_on_4_shards_resumes_on_2_and_1_bitwise(tmp_path):
    ckpt = tmp_path / "ckpt"
    clean = tmp_path / "clean.npz"
    r = _kill_child(tmp_path / "unused", clean, "fresh", 4)
    assert r.returncode == 0, r.stderr
    r = _kill_child(ckpt, os.devnull, "fresh", 4, chaos_env="kill_sweep=3")
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    blobs = os.listdir(ckpt)
    assert blobs
    snap = SnapshotStore(str(ckpt)).load(str(ckpt / sorted(blobs)[-1]))
    assert snap.sweep == 3 and snap.mesh == {
        "n_dev": 4, "axes": {"data": 4}, "platform": "cpu", "distinct": 1}
    with np.load(clean) as a:
        want = {k: a[k] for k in a.files}
    for n in (2, 1):
        ck = tmp_path / f"ckpt{n}"
        shutil.copytree(ckpt, ck)
        out = tmp_path / f"resumed{n}.npz"
        r = _kill_child(ck, out, "resume", n)
        assert r.returncode == 0, r.stderr
        with np.load(out) as b:
            for k in want:
                np.testing.assert_array_equal(want[k], b[k],
                                              err_msg=f"{k} on {n} shards")


def test_reference_v2_snapshot_resumes_in_the_port(ref, tmp_path):
    """The reference's own 4-device run wrote a v2 snapshot after 3
    sweeps; the port reads it (shards, mesh, dist meta), resumes it on 2
    shards and ends within ``FIT_ATOL`` of the reference's 6-sweep run."""
    R, ckpt = ref
    store = SnapshotStore(str(ckpt))
    _, blob = store._blobs()[-1]
    snap = store.load(str(ckpt / blob))
    assert snap.sweep == 3
    assert snap.mesh == {"n_dev": 4, "axes": {"data": 4}, "platform": "cpu"}
    assert snap.dist.startswith("DistConfig(")
    for d, f in enumerate(snap.factors):
        np.testing.assert_array_equal(f, R[f"a_als3_factor{d}"])
    t = _tensor("a")
    init = _factors(R, "a", "als_init")
    cfg = _cfg()
    fp = fingerprint(t.indices, t.values, t.dims, 4, config=cfg,
                     key=init_key(init), extra="dist")
    # the reference's blob, under the port's problem fingerprint
    rsnapshot.SnapshotStore(str(tmp_path)).save(
        fp, 3, snap.factors, snap.lam, snap.fits,
        mesh=rmake_mesh((1,), ("data",)), dist=snap.dist)
    got = cp_als(t, 4, iters=6, config=cfg, factors=init, mesh=_mesh(2),
                 checkpoint=str(tmp_path), resume=True)
    assert got.fits[:3] == [float(f) for f in R["a_als3_fits"]]
    np.testing.assert_allclose(got.fits, R["a_als6_fits"], rtol=0,
                               atol=FIT_ATOL)
    # the port's own v2 write, read back by the reference
    newest = rsnapshot.SnapshotStore(str(tmp_path)).latest(fp)
    assert newest.sweep == 6 and newest.mesh["n_dev"] == 2


# --------------------------------------------------------------------------
# interop.state_from_numpy: the engine's work tables (both schedules).
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["cuda", "cuda_fused"])
@pytest.mark.parametrize("name", ["a", "b"])
def test_state_from_numpy_builds_the_engines_tables(name, backend):
    """Given the plans, a state carried across has the tables
    ``engine.init`` builds, rect included; without them it has none for
    rect or ``cuda`` (the kernels then derive a full-range table)."""
    t = _tensor(name)
    cfg = _cfg(backend=backend)
    want = engine.init(t, cfg)
    leaves = dict(val=want.val.numpy(), idx=want.idx.numpy(),
                  alpha=want.alpha.numpy(),
                  relabel=[r.numpy() for r in want.relabel],
                  sched=[(ms.bpart.numpy(),) + tuple(
                      None if x is None else x.numpy()
                      for x in (ms.uidx, ms.upos, ms.nuniq))
                      for ms in want.sched])
    got = interop.state_from_numpy(**leaves, mode=0, dims=t.dims,
                                   statics=want.statics, config=cfg,
                                   plans=t.plans)
    for gm, wm, p in zip(got.sched, want.sched, t.plans):
        assert torch.equal(gm.work, wm.work) and torch.equal(gm.wsum,
                                                             wm.wsum)
        assert kmt.checked_for(kmt.WorkTable(gm.work, gm.wsum)) == \
            kmt.checked_for(mode_work(p))
    bare = interop.state_from_numpy(**leaves, mode=0, dims=t.dims,
                                    statics=want.statics, config=cfg)
    has = [ms.work is not None for ms in bare.sched]
    assert has == [CASES[name][2] == "compact"
                   and backend == "cuda_fused"] * 3
