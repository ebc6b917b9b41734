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
    idx, val, dims, facs, kw = _case(3, schedule="rect")
    state = engine.init(build_flycoo(idx, val, dims, **kw),
                        ExecutionConfig(backend="cuda_fused", device="cpu"))
    with pytest.raises(NotImplementedError, match="Queue B items 4-5"):
        engine.all_modes(state, interop.factors_from_numpy(facs,
                                                           device="cpu"))


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
