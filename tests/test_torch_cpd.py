"""The port's CPD-ALS against the reference's, from the same initial
factors (the reference draws them with ``jax.random``; the port is handed
them as numpy arrays).

Tolerances: fits within 1e-4 absolute and final factors within
rtol = atol = 1e-3. Both runs are float32 ALS on the same data; only the
summation order of the MTTKRP (index_add_ vs XLA segment_sum) and of the
R x R solves differ, and a few sweeps amplify those last-bit differences
by at most a few orders of magnitude.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import build_flycoo as rbuild
from repro.core import cp_als as rcp_als
from repro.core import cp_als_reference as rcp_als_reference
from repro.core import init_factors as rinit
from repro.engine import ExecutionConfig as RConfig
from repro_torch.core import build_flycoo, cp_als, cp_als_reference
from repro_torch.engine import ExecutionConfig

DIMS = {3: (24, 18, 12), 5: (9, 8, 7, 6, 5)}
FIT_ATOL = 1e-4


def _tensor(nmodes, nnz=500, seed=11):
    dims = DIMS[nmodes]
    rng = np.random.default_rng(seed)
    idx = np.unique(np.stack([rng.integers(0, d, nnz) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    return idx, val, dims


@pytest.mark.parametrize("nmodes", [3, 5])
@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
def test_cp_als_matches_reference(nmodes, backend):
    idx, val, dims = _tensor(nmodes)
    kw = dict(rows_pp=8, block_p=16)
    key = jax.random.PRNGKey(3)
    want = rcp_als(rbuild(idx, val, dims, **kw), rank=6, iters=4, key=key,
                   config=RConfig(backend="xla"))
    init = [np.asarray(f) for f in rinit(key, dims, 6)]
    got = cp_als(build_flycoo(idx, val, dims, **kw), 6, iters=4,
                 config=ExecutionConfig(backend=backend, device="cpu"),
                 factors=init)
    assert len(got.fits) == 4
    assert got.fits == pytest.approx(want.fits, abs=FIT_ATOL)
    for a, b in zip(got.factors, want.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                               rtol=1e-3)


def test_cp_als_reference_matches_and_engine_agrees():
    idx, val, dims = _tensor(3, seed=4)
    key = jax.random.PRNGKey(0)
    want = rcp_als_reference(idx, val, dims, 5, iters=3, key=key)
    init = [np.asarray(f) for f in rinit(key, dims, 5)]
    got = cp_als_reference(idx, val, dims, 5, iters=3, factors=init,
                           device="cpu")
    assert got.fits == pytest.approx(want.fits, abs=FIT_ATOL)
    eng = cp_als(build_flycoo(idx, val, dims, rows_pp=8, block_p=16), 5,
                 iters=3, config=ExecutionConfig(device="cpu"),
                 factors=init)
    assert eng.fits == pytest.approx(got.fits, abs=FIT_ATOL)


def test_cp_als_generator_init_is_seeded():
    idx, val, dims = _tensor(3, seed=5)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    cfg = ExecutionConfig(device="cpu")
    a = cp_als(t, 4, iters=2, config=cfg,
               generator=torch.Generator().manual_seed(7))
    b = cp_als(t, 4, iters=2, config=cfg,
               generator=torch.Generator().manual_seed(7))
    assert a.fits == b.fits and all(np.isfinite(a.fits))


@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
def test_float64_witness_agrees_with_float32_runs(backend):
    """``cp_als_reference(dtype=torch.float64)`` runs the ALS in float64
    from the same initial factors (the witness ``chip_smoke.py`` holds the
    float32 engine runs against); a float32 engine run lies within the
    float32 fit tolerance of it."""
    idx, val, dims = _tensor(3, seed=6)
    key = jax.random.PRNGKey(1)
    init = [np.asarray(f) for f in rinit(key, dims, 5)]
    wit = cp_als_reference(idx, val, dims, 5, iters=3, factors=init,
                           device="cpu", dtype=torch.float64)
    assert all(f.dtype == torch.float64 for f in wit.factors)
    assert wit.lam.dtype == torch.float64
    eng = cp_als(build_flycoo(idx, val, dims, rows_pp=8, block_p=16), 5,
                 iters=3, config=ExecutionConfig(backend=backend,
                                                 device="cpu"),
                 factors=init)
    assert eng.fits == pytest.approx(wit.fits, abs=FIT_ATOL)
