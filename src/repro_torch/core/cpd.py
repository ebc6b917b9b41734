"""CPD via Alternating Least Squares on the port's spMTTKRP engine.

The port of ``repro.core.cpd``. For each mode d (Eq. 1 of the paper):
    M_d   = X_(d) * KRP(Y_w, w != d)          <- the paper's kernel
    V_d   = hadamard_{w != d} (Y_w^T Y_w)      (R x R)
    Y_d   = M_d @ pinv(V_d); column-normalize -> lambda

A sweep is one ``engine.all_modes`` rotation with the Gauss-Seidel update
in its ``fold`` hook. Fit uses the sparse-CPD identity
    ||X - X_hat||^2 = ||X||^2 - 2<X, X_hat> + ||X_hat||^2.

The Gram products and the R x R solve stay library calls
(``torch.matmul``, ``torch.linalg.solve``), as the reference leaves them
to XLA; TF32 is switched off so they run in full f32, as the reference
runs ``precision="float32"``. The reference's ``mesh``, ``ladder`` and
``checkpoint`` arguments come with the distributed and resilience slices.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import engine
from repro_torch.engine import ExecutionConfig
from repro_torch.obs.metrics import gauge as _obs_gauge
from repro_torch.obs.trace import span

from .flycoo import FlycooTensor
from .mttkrp import mttkrp_ref


def _full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_factors(generator: torch.Generator, dims: Sequence[int], rank: int,
                 device=None) -> list[torch.Tensor]:
    """Uniform [0, 1) factors drawn from ``generator`` (on its device),
    then placed on ``device``."""
    return [torch.rand((d, rank), generator=generator,
                       device=generator.device).to(device or
                                                   generator.device)
            for d in dims]


def gram(f: torch.Tensor) -> torch.Tensor:
    return f.T @ f


def _als_update(mttkrp_out, grams_other, eps=1e-8):
    """Y_d = M_d @ pinv(hadamard of other grams); normalize columns."""
    v = grams_other[0]
    for g in grams_other[1:]:
        v = v * g
    # Relative ridge keeps overcomplete ALS stable when V becomes singular.
    r = v.shape[0]
    ridge = eps + 1e-6 * torch.trace(v) / r
    v = v + ridge * torch.eye(r, dtype=v.dtype, device=v.device)
    y = torch.linalg.solve(v.T, mttkrp_out.T).T
    lam = torch.linalg.vector_norm(y, dim=0)
    lam = torch.where(lam < eps, 1.0, lam)
    return (y / lam).contiguous(), lam


def _als_fold(d: int, m_d, factors, lam):
    """Gauss-Seidel update for mode ``d`` (the ``all_modes`` fold hook)."""
    n = len(factors)
    grams_other = tuple(gram(factors[w]) for w in range(n) if w != d)
    y, lam = _als_update(m_d, grams_other)
    return tuple(factors[:d]) + (y,) + tuple(factors[d + 1:]), lam


@dataclasses.dataclass
class CPDResult:
    factors: list[torch.Tensor]
    lam: torch.Tensor
    fits: list[float]


def _initial(factors, generator, dims, rank, device, dtype=torch.float32):
    if factors is not None:
        return [(f if torch.is_tensor(f) else torch.from_numpy(np.array(f)))
                .to(device=device, dtype=dtype).contiguous()
                for f in factors]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return [f.to(dtype) for f in init_factors(generator, dims, rank,
                                              device=device)]


def cp_als(tensor: FlycooTensor, rank: int, iters: int = 10,
           generator: torch.Generator | None = None,
           config: ExecutionConfig | None = None, track_fit: bool = True,
           *, factors=None) -> CPDResult:
    """Run CPD-ALS for ``iters`` sweeps over all modes (paper Alg. 5 outer).

    Initial factors are ``factors`` when given (tensors or numpy arrays —
    how the tests hand in the JAX reference's ``jax.random`` draws), else
    drawn from ``generator`` (default: CPU generator seeded 0).
    """
    config = config or ExecutionConfig()
    _full_fp32()
    dev = config.torch_device
    n = tensor.nmodes
    factors = tuple(_initial(factors, generator, tensor.dims, rank, dev))
    lam = torch.ones((rank,), dtype=torch.float32, device=dev)
    state = engine.init(tensor, config)
    norm_x_sq = float(np.sum(tensor.values.astype(np.float64) ** 2))
    fits: list = []
    for i in range(iters):
        with span("cpd.sweep", sweep=i) as sp:
            outs, state, factors, lam = engine.all_modes(
                state, factors, fold=_als_fold, carry=lam)
            if track_fit:
                fit = _fit(norm_x_sq, outs[n - 1], factors, lam)
                fits.append(fit)
                sp.set("fit", fit)
                _obs_gauge("cpd_fit", "latest ALS fit per tier").set(
                    "resident", fit)
    return CPDResult(factors=list(factors), lam=lam, fits=fits)


def _fit(norm_x_sq: float, m_last, factors, lam) -> float:
    n = len(factors)
    inner = torch.sum(m_last * (factors[n - 1] * lam[None, :]))
    g = gram(factors[0])
    for f in factors[1:]:
        g = g * gram(f)
    norm_est_sq = lam @ g @ lam
    resid_sq = torch.clamp(norm_x_sq - 2 * inner + norm_est_sq, min=0.0)
    return float(1.0 - torch.sqrt(resid_sq) / np.sqrt(norm_x_sq))


def cp_als_reference(indices, values, dims, rank, iters=10, generator=None,
                     *, factors=None, device="cuda",
                     dtype=torch.float32) -> CPDResult:
    """Oracle ALS on the plain COO ``mttkrp_ref`` (no FLYCOO), with the
    factors, the MTTKRP and the solves in ``dtype`` (float64 makes it a
    witness for float32 runs from the same initial factors)."""
    _full_fp32()
    n = len(dims)
    factors = _initial(factors, generator, dims, rank, device, dtype)
    lam = torch.ones((rank,), dtype=dtype, device=device)
    norm_x_sq = float(np.sum(np.asarray(values, np.float64) ** 2))
    indices = torch.as_tensor(np.asarray(indices), device=device)
    values = torch.as_tensor(np.asarray(values), device=device)
    fits = []
    for _ in range(iters):
        m_last = None
        for d in range(n):
            m = mttkrp_ref(indices, values, factors, d, dims[d])
            grams_other = [gram(factors[w]) for w in range(n) if w != d]
            factors[d], lam = _als_update(m, tuple(grams_other))
            m_last = m
        fits.append(_fit(norm_x_sq, m_last, factors, lam))
    return CPDResult(factors=factors, lam=lam, fits=fits)
