"""The port's engine against the reference engine on the same layout.

The reference state is built by ``repro.engine.init`` and carried into the
port by ``interop.state_from_numpy``, so both engines rotate exactly the
same layout with the same (numpy-made) factors. The reference runs its
``pallas_fused`` kernels in interpret mode; the port's ``cuda_fused``
backend runs the kernels' plain versions on the CPU.

Tolerance for MTTKRP outputs: rtol = atol = 2e-4, as the reference's own
engine tests — float32 sums taken in another order. Layouts (the remap)
are compared bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as rengine
from repro.core import build_flycoo as rbuild
from repro.engine import ExecutionConfig as RConfig
from repro_torch import engine, interop
from repro_torch.core import build_flycoo
from repro_torch.engine import ExecutionConfig

DIMS = {3: (23, 17, 11), 4: (13, 11, 7, 9), 5: (9, 8, 7, 6, 5),
        6: (7, 6, 5, 4, 3, 8)}
TOL = dict(rtol=2e-4, atol=2e-4)


def _case(nmodes, nnz=300, seed=0, rank=8, **kw):
    dims = DIMS[nmodes]
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    facs = [rng.standard_normal((d, rank)).astype(np.float32) for d in dims]
    kw = {"rows_pp": 4, "block_p": 8, **kw}
    return idx, val, dims, facs, kw


def _ported(rstate, config):
    return interop.state_from_numpy(
        np.asarray(rstate.val), np.asarray(rstate.idx),
        np.asarray(rstate.alpha), [np.asarray(r) for r in rstate.relabel],
        [tuple(None if x is None else np.asarray(x) for x in sc)
         for sc in rstate.sched],
        mode=rstate.mode, dims=rstate.dims, statics=rstate.statics,
        config=config)


def _layout(state):
    return [x.numpy() if torch.is_tensor(x) else np.asarray(x)
            for x in (state.val, state.idx, state.alpha)]


def _same_layout(a, b):
    for x, y in zip(_layout(a), _layout(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("nmodes", [3, 4, 5, 6])
def test_cuda_fused_rotation_matches_reference_pallas_fused(nmodes):
    """Any start mode: every mode's output matches, each single step's
    remapped layout equals the reference kernel's bitwise, and a full
    rotation brings the layout bitwise back to its start."""
    idx, val, dims, facs, kw = _case(nmodes, nnz=160, seed=nmodes,
                                     block_p=16)
    rt = rbuild(idx, val, dims, **kw)
    rcfg = RConfig(backend="pallas_fused", interpret=True)
    cfg = ExecutionConfig(backend="cuda_fused", device="cpu")
    rf = tuple(jnp.asarray(f) for f in facs)
    tf = interop.factors_from_numpy(facs, device="cpu")
    start = nmodes - 1
    r0 = rengine.init(rt, rcfg, start_mode=start)
    t0 = _ported(r0, cfg)
    routs, r1 = rengine.all_modes(r0, rf)
    touts, t1 = engine.all_modes(t0, tf)
    assert t1.mode == start
    for d in range(nmodes):
        np.testing.assert_allclose(touts[d].numpy(), np.asarray(routs[d]),
                                   **TOL)
    _same_layout(t1, t0)
    _same_layout(t1, r1)
    rout, rs = rengine.mttkrp(r0, rf)
    tout, ts = engine.mttkrp(t0, tf)
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), **TOL)
    assert ts.mode == rs.mode == 0
    _same_layout(ts, rs)


@pytest.mark.parametrize("backend,dedup", [("cuda_fused", True),
                                           ("cuda_fused", False),
                                           ("torch", True)])
def test_port_init_equals_reference_state(backend, dedup):
    idx, val, dims, _, kw = _case(4, seed=7)
    ref_backend = "pallas_fused" if backend == "cuda_fused" else "xla"
    r0 = rengine.init(rbuild(idx, val, dims, **kw),
                      RConfig(backend=ref_backend, dedup=dedup), start_mode=2)
    cfg = ExecutionConfig(backend=backend, device="cpu", dedup=dedup)
    t0 = engine.init(build_flycoo(idx, val, dims, **kw), cfg, start_mode=2)
    p0 = _ported(r0, cfg)
    _same_layout(t0, p0)
    assert t0.statics == p0.statics and t0.mode == p0.mode
    for a, b in zip(t0.relabel, p0.relabel):
        assert torch.equal(a, b)
    for sa, sb in zip(t0.sched, p0.sched):
        for a, b in zip(sa, sb):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("schedule,backend,fuse", [
    ("compact", "torch", True), ("rect", "torch", True),
    ("compact", "ref", True), ("rect", "ref", True),
    ("compact", "cuda_fused", False)])
def test_backends_match_reference_xla(schedule, backend, fuse):
    """torch/ref (both schedules) and cuda_fused with the index_copy_
    remap against the reference's default xla backend."""
    idx, val, dims, facs, kw = _case(5, seed=11, schedule=schedule)
    r0 = rengine.init(rbuild(idx, val, dims, **kw), RConfig(), start_mode=1)
    routs, r1 = rengine.all_modes(r0, tuple(jnp.asarray(f) for f in facs))
    cfg = ExecutionConfig(backend=backend, device="cpu", fuse_remap=fuse)
    t0 = engine.init(build_flycoo(idx, val, dims, **kw), cfg, start_mode=1)
    touts, t1 = engine.all_modes(t0, interop.factors_from_numpy(
        facs, device="cpu"))
    for d in range(5):
        np.testing.assert_allclose(touts[d].numpy(), np.asarray(routs[d]),
                                   **TOL)
    _same_layout(t1, r1)


def test_cuda_fused_refuses_rect_schedule():
    """``cuda_fused`` takes the rect schedule too (``mttkrp_fused_remap``,
    or ``mttkrp_fused_gather`` with ``fuse_remap=False``): on the CPU it
    runs their plain versions, launches nothing, and matches the COO
    oracle."""
    from repro_torch.core import mttkrp_ref
    from repro_torch.kernels import mttkrp as kmt

    idx, val, dims, facs, kw = _case(3, schedule="rect")
    tf = interop.factors_from_numpy(facs, device="cpu")
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    before = dict(kmt.LAUNCHES)
    for fuse in (True, False):
        state = engine.init(build_flycoo(idx, val, dims, **kw),
                            ExecutionConfig(backend="cuda_fused",
                                            device="cpu", fuse_remap=fuse))
        outs, nxt = engine.all_modes(state, tf)
        for d in range(3):
            np.testing.assert_allclose(
                outs[d].numpy(), mttkrp_ref(ti, tv, tf, d, dims[d]).numpy(),
                **TOL)
        _same_layout(nxt, state)
    assert kmt.LAUNCHES == before


@pytest.mark.parametrize("backend,schedule,fuse", [
    ("cuda", "compact", True), ("cuda", "rect", True),
    ("cuda_fused", "rect", True), ("cuda_fused", "rect", False)])
def test_cuda_backends_match_reference_pallas(backend, schedule, fuse):
    """``cuda`` (both schedules) and rect ``cuda_fused`` against the
    reference's ``pallas`` / ``pallas_fused`` on the same plans: every
    mode's output within the tolerance, the layout bitwise equal to the
    reference's after the rotation and back at its start."""
    idx, val, dims, facs, kw = _case(4, nnz=220, seed=5, schedule=schedule,
                                     block_p=16)
    ref_backend = {"cuda": "pallas", "cuda_fused": "pallas_fused"}[backend]
    r0 = rengine.init(rbuild(idx, val, dims, **kw),
                      RConfig(backend=ref_backend, interpret=True,
                              fuse_remap=fuse), start_mode=1)
    cfg = ExecutionConfig(backend=backend, device="cpu", fuse_remap=fuse)
    t0 = _ported(r0, cfg)
    routs, r1 = rengine.all_modes(r0, tuple(jnp.asarray(f) for f in facs))
    touts, t1 = engine.all_modes(t0, interop.factors_from_numpy(
        facs, device="cpu"))
    for d in range(4):
        np.testing.assert_allclose(touts[d].numpy(), np.asarray(routs[d]),
                                   **TOL)
    _same_layout(t1, r1)
    _same_layout(t1, t0)


@pytest.mark.parametrize("backend,schedule", [
    ("torch", "compact"), ("torch", "rect"), ("cuda", "compact"),
    ("cuda", "rect")])
def test_mode_step_matches_reference(backend, schedule):
    """``core.mode_step`` against the reference's on one mode's layout:
    ``out_rel`` within the tolerance, the next layout bitwise."""
    from repro.core.mttkrp import mode_step as rmode_step
    from repro_torch.core import mode_step

    idx, val, dims, facs, kw = _case(3, seed=9, schedule=schedule)
    rt = rbuild(idx, val, dims, **kw)
    d = 1
    r0 = rengine.init(rt, RConfig(), start_mode=d)
    plan = rt.plans[d]
    sd, nxt_size = plan.padded_nnz, rt.plans[2].padded_nnz
    lay = {k: np.asarray(getattr(r0, k))[:sd] for k in ("val", "idx",
                                                        "alpha")}
    lay["bpart"] = plan.block_part
    skw = dict(mode=d, rows_pp=plan.rows_pp, blocks_pp=plan.blocks_pp,
               block_p=plan.block_p, kappa=plan.kappa, next_size=nxt_size,
               schedule=schedule, nblocks=plan.nblocks)
    ref_backend = {"torch": "xla", "cuda": "pallas"}[backend]
    rout, rnext = rmode_step({k: jnp.asarray(v) for k, v in lay.items()},
                             tuple(jnp.asarray(f) for f in facs),
                             jnp.asarray(plan.row_relabel),
                             backend=ref_backend, interpret=True, **skw)
    tout, tnext = mode_step({k: torch.from_numpy(np.array(v))
                             for k, v in lay.items()},
                            interop.factors_from_numpy(facs, device="cpu"),
                            torch.from_numpy(plan.row_relabel),
                            backend=backend, **skw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), **TOL)
    for k in ("val", "idx", "alpha"):
        np.testing.assert_array_equal(tnext[k].numpy(),
                                      np.asarray(rnext[k]))


def test_mttkrp_executor_is_a_deprecated_engine_shim():
    from repro_torch.core import MTTKRPExecutor, mttkrp_ref

    idx, val, dims, facs, kw = _case(3, seed=4)
    t = build_flycoo(idx, val, dims, **kw)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        exe = MTTKRPExecutor(t, backend="cuda", device="cpu")
    tf = interop.factors_from_numpy(facs, device="cpu")
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    out0 = exe.step(tf)
    assert exe.current_mode == 1
    outs = exe.all_modes(tf)          # from mode 1, back to mode 1
    assert exe.current_mode == 1
    for d, out in [(0, out0)] + list(enumerate(outs)):
        np.testing.assert_allclose(
            out.numpy(), mttkrp_ref(ti, tv, tf, d, dims[d]).numpy(), **TOL)
    assert exe.layout["val"].shape[0] == t.plans[1].padded_nnz
    exe.reset()
    assert exe.current_mode == 0 and exe.state.mode == 0


def test_fold_hook_and_mode_guard():
    idx, val, dims, facs, kw = _case(3, seed=2)
    cfg = ExecutionConfig(device="cpu")
    state = engine.init(build_flycoo(idx, val, dims, **kw), cfg)
    tf = interop.factors_from_numpy(facs, device="cpu")
    seen = []

    def fold(d, out, factors, carry):
        seen.append((d, tuple(out.shape)))
        return factors, carry + 1

    outs, _, _, carry = engine.all_modes(state, tf, fold=fold, carry=0)
    assert carry == 3 and seen == [(d, (dims[d], 8)) for d in range(3)]
    with pytest.raises(ValueError, match="without rotating"):
        engine.mttkrp(state, tf, mode=1)
