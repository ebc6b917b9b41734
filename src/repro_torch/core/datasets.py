"""Synthetic sparse-tensor generators mirroring the paper's datasets (Table 3).

The port's copy of ``repro.core.datasets``. The generators are numpy-
seeded, so the port's data is bitwise the reference's (tested): same mode
counts, proportionally scaled dimensions, and heavy-tailed (Zipf-like)
indices — the regime the paper's degree-sorted load balancing targets.
``scale=1.0`` reproduces the published shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .flycoo import FlycooTensor, build_flycoo

# name -> (dims, nnz) from paper Table 3.
PAPER_TENSORS: dict[str, tuple[tuple[int, ...], int]] = {
    "amazon": ((15_200_000, 43_500_000, 7_800), 233_100_000),
    "delicious": ((532_900, 17_300_000, 2_500_000, 1_400), 140_100_000),
    "music": ((23_300_000, 23_300_000, 166), 99_500_000),
    "nell1": ((2_900_000, 2_100_000, 25_500_000), 143_600_000),
    "twitch": ((15_500_000, 6_200_000, 783_900, 6_100, 6_100), 474_700_000),
    "vast": ((165_400, 11_400, 2, 100, 89), 26_000_000),
}

# Synthetic skewed stress tensor (not from Table 3): a = 2.0 power law.
SYNTH_TENSORS: dict[str, tuple[tuple[int, ...], int, float]] = {
    "zipf": ((2_000_000, 1_500_000, 1_000_000), 40_000_000, 2.0),
}

DEFAULT_ZIPF_A = 1.2


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    name: str
    dims: tuple[int, ...]
    nnz: int
    zipf_a: float = DEFAULT_ZIPF_A  # power-law exponent of the mode indices


def spec(name: str, scale: float = 1e-3, min_dim: int = 2,
         max_nnz: int | None = None) -> TensorSpec:
    if name in PAPER_TENSORS:
        (dims, nnz), a = PAPER_TENSORS[name], DEFAULT_ZIPF_A
    else:
        dims, nnz, a = SYNTH_TENSORS[name]
    sdims = tuple(max(min_dim, int(round(d * scale))) for d in dims)
    snnz = max(1000, int(round(nnz * scale)))
    if max_nnz is not None:
        snnz = min(snnz, max_nnz)
    return TensorSpec(name=name, dims=sdims, nnz=snnz, zipf_a=a)


def _zipf_indices(rng: np.random.Generator, dim: int, n: int,
                  a: float = DEFAULT_ZIPF_A) -> np.ndarray:
    """Heavy-tailed indices in [0, dim): Zipf ranks permuted over the dim."""
    raw = rng.zipf(a, size=n)
    idx = (raw - 1) % dim
    perm = rng.permutation(dim)  # decorrelate rank from index id
    return perm[idx].astype(np.int32)


def synthesize(ts: TensorSpec, seed: int = 0,
               dedupe: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Generate COO (indices (nnz, N), values (nnz,)) for a spec."""
    rng = np.random.default_rng(seed)
    cols = [_zipf_indices(rng, d, ts.nnz, a=ts.zipf_a) for d in ts.dims]
    indices = np.stack(cols, axis=1)
    if dedupe:
        indices = np.unique(indices, axis=0)
    values = rng.standard_normal(indices.shape[0]).astype(np.float32)
    return indices, values


def random_tensor(dims, nnz, seed=0, **flycoo_kw) -> FlycooTensor:
    ts = TensorSpec(name="random", dims=tuple(dims), nnz=nnz)
    indices, values = synthesize(ts, seed=seed)
    return build_flycoo(indices, values, ts.dims, **flycoo_kw)


def zipf_tensor(dims, nnz, a: float = 1.5, seed: int = 0,
                **flycoo_kw) -> FlycooTensor:
    """Skewed synthetic generator: every mode's indices follow a seeded
    Zipf power law with exponent ``a`` (steeper = more skew)."""
    ts = TensorSpec(name="zipf", dims=tuple(int(d) for d in dims),
                    nnz=int(nnz), zipf_a=float(a))
    indices, values = synthesize(ts, seed=seed)
    return build_flycoo(indices, values, ts.dims, **flycoo_kw)
