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
runs ``precision="float32"``. ``cp_als`` takes the reference's
resilience arguments (``ladder``, ``checkpoint``, ``checkpoint_every``,
``resume``; :mod:`repro_torch.resilience`) and its ``mesh`` / ``dist``:
the sweep is then ``engine.dist.dist_all_modes`` over the shards, with
the same fold.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch import engine
from repro_torch.engine import ExecutionConfig
from repro_torch.obs.metrics import gauge as _obs_gauge
from repro_torch.obs.trace import span
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience import guard as _guard
from repro_torch.resilience.ladder import (classify, next_backend,
                                           record_degradation,
                                           resolve_policy)
from repro_torch.resilience.snapshot import as_store, fingerprint

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


#: Ridge strength a rolled-back sweep is replayed under: strong enough to
#: dominate a near-singular gram product that NaN'd the plain solve, small
#: enough to leave a well-conditioned sweep's fixed point nearly where it
#: was (the reference's value).
RECOVERY_EPS = 1e-3


def _als_fold_recovery(d: int, m_d, factors, lam):
    """The Gauss-Seidel update under the stronger :data:`RECOVERY_EPS`
    ridge: the replay of a sweep after a NaN/Inf burst
    (``resilience.guard``)."""
    n = len(factors)
    grams_other = tuple(gram(factors[w]) for w in range(n) if w != d)
    y, lam = _als_update(m_d, grams_other, RECOVERY_EPS)
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


def init_key(factors=None, generator=None) -> np.ndarray:
    """The initial factors' identity, hashed into a snapshot's problem
    fingerprint where the reference hashes its PRNG key: the bytes of
    ``factors`` (as float32) when given, else the generator's seed and
    state before it draws (the default CPU generator seeded 0 when both
    are ``None``). So a resume refuses a run that started elsewhere."""
    if factors is not None:
        return np.concatenate([
            np.ascontiguousarray(
                f.detach().cpu().numpy() if torch.is_tensor(f)
                else np.asarray(f), dtype=np.float32).view(np.uint8).ravel()
            for f in factors])
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return np.concatenate([
        np.asarray([generator.initial_seed()], dtype=np.uint64)
        .view(np.uint8), generator.get_state().cpu().numpy()])


def _restore(snap, dev):
    """A snapshot's ``(factors, lam, fits)`` on ``dev``."""
    factors = tuple(torch.from_numpy(np.array(f)).to(dev)
                    for f in snap.factors)
    return (factors, torch.from_numpy(np.array(snap.lam)).to(dev),
            [float(f) for f in snap.fits])


def cp_als(tensor: FlycooTensor, rank: int, iters: int = 10,
           generator: torch.Generator | None = None,
           config: ExecutionConfig | None = None, track_fit: bool = True,
           mesh=None, dist=None, *, factors=None, ladder=None,
           checkpoint=None, checkpoint_every: int = 1,
           resume: bool = False) -> CPDResult:
    """Run CPD-ALS for ``iters`` sweeps over all modes (paper Alg. 5 outer).

    Initial factors are ``factors`` when given (tensors or numpy arrays —
    how the tests hand in the JAX reference's ``jax.random`` draws), else
    drawn from ``generator`` (default: CPU generator seeded 0).

    Resilience (:mod:`repro_torch.resilience`), as in the reference:

    * ``ladder``: ``True`` / a :class:`~repro_torch.resilience.
      LadderPolicy` enables the degradation ladder (a kernel build failure
      steps the backend down ``cuda_fused -> cuda``, and on the CPU on to
      ``torch``) and the per-sweep NaN/Inf guard (a burst rolls the sweep
      back and replays it under the stronger :data:`RECOVERY_EPS` ridge).
      Every transition lands on the obs registry. ``None`` defers to the
      ambient ``REPRO_LADDER`` policy, off when there is none.
    * ``checkpoint``: a directory or :class:`~repro_torch.resilience.
      SnapshotStore`; every ``checkpoint_every`` completed sweeps (and
      after the last) ``(factors, lam, fits)`` are snapshotted under the
      problem fingerprint (tensor bytes, rank, config, the initial
      factors' :func:`init_key`). ``resume=True`` restores the newest
      intact snapshot of the same problem and runs only the remaining
      sweeps: at a sweep boundary the layout has rotated back to its
      start, so ``(factors, lam)`` are the whole state, and on the CPU
      the result is bitwise the uninterrupted run's.

    The rotation is eager (a Python loop, the fold after each mode), so a
    build failure at mode d > 0 comes after modes 0..d-1 have updated the
    factors. The backend rung therefore restores the sweep's starting
    ``(factors, lam)`` and rebuilds the state from the tensor under the
    next backend before it replays the sweep.

    With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, or a
    :class:`~repro_torch.sharding.ShardingCtx` of which only the data
    axis is used, never its tp axis: the ALS fold needs the full rank on
    every shard) the state is sharded over its data axis
    (``engine.dist.shard_state``) and each sweep is one
    ``dist_all_modes`` rotation with the same fold, the factors on the
    first shard's device and copied to each other distinct device once a
    mode. ``tensor``'s partition counts must
    divide over the mesh (``core.distributed.build_sharded_flycoo``);
    ``dist`` is an optional ``DistConfig`` whose ``model_axis`` stays
    ``None``. Snapshots are then v2, under a problem fingerprint that
    leaves the mesh out, so a run killed on 4 shards resumes on 2 or 1.
    With a ladder two more rungs act, as in the reference: an exchange
    failure steps ``permute -> all_gather``, and a lost device re-shards
    on the surviving mesh (``engine.dist.surviving_mesh``) and rolls back
    to the latest snapshot or the sweep's start; transient dispatch
    failures retry with the policy's backoff.
    """
    if mesh is None and dist is not None:
        raise ValueError("dist config given without a mesh")
    if mesh is not None:   # before any state is built
        mesh, dist = engine.dist.from_ctx(mesh, dist, model=False)
        engine.dist.check_mesh(mesh, dist or engine.dist.DistConfig())
    config = config or ExecutionConfig()
    store = as_store(checkpoint)
    policy = resolve_policy(ladder)
    _full_fp32()
    key = init_key(factors, generator) if store is not None else None
    fp = None if store is None else fingerprint(
        tensor.indices, tensor.values, tensor.dims, rank, config=config,
        key=key, extra="resident" if mesh is None else "dist")

    def rebuild(cfg, mesh=None, dist=None):
        state = engine.init(tensor, cfg)
        return state if mesh is None else engine.dist.shard_state(
            state, mesh, dist)

    state = rebuild(config, mesh, dist)
    if mesh is None:
        sweep, dev = engine.all_modes, config.torch_device
    else:
        sweep = functools.partial(engine.dist.dist_all_modes, policy=policy)
        dev = state.device
    return als_sweeps(
        sweep, state, _initial(factors, generator, tensor.dims, rank, dev),
        tensor.values, iters, track_fit=track_fit, policy=policy,
        store=store, fp=fp, checkpoint_every=checkpoint_every,
        resume=resume, tier="resident", rebuild=rebuild)


def als_sweeps(sweep, state, factors, values, iters: int, *,
               track_fit: bool, policy, store, fp, checkpoint_every: int,
               resume: bool, tier: str, rebuild=None) -> CPDResult:
    """The sweep loop of ``cp_als`` (resident or distributed) and
    ``cp_als_stream``, with the resilience that acts at a sweep
    boundary: resume from ``store``'s newest snapshot under ``fp``,
    chaos's kill and NaN hooks, the NaN guard (roll back, replay under
    :data:`RECOVERY_EPS`, raise if the burst persists), the rungs (with a
    ``rebuild(config, mesh=None, dist=None) -> state``; the stream steps
    its backend inside ``stream_mttkrp`` instead) and a snapshot every
    ``checkpoint_every`` sweeps and after the last (v2 for a
    ``DistState``). The rungs: a build failure steps the backend; on a
    ``DistState`` an exchange failure steps ``permute -> all_gather`` and
    a lost device re-shards on the surviving mesh, rolling back to the
    newest snapshot when there is one.

    ``sweep(state, factors, fold=, carry=)`` is one rotation that returns
    ``(outs, state, factors, lam)``; ``tier`` ("resident" / "streamed")
    names the fit gauge's label and the sweep span's ``streamed``."""
    dev = factors[0].device
    factors = tuple(factors)
    lam = torch.ones((factors[0].shape[1],), dtype=torch.float32,
                     device=dev)
    norm_x_sq = float(np.sum(values.astype(np.float64) ** 2))
    fits: list = []
    first = 0
    snap = store.latest(fp) if store is not None and resume else None
    if snap is not None:
        factors, lam, fits = _restore(snap, dev)
        first = snap.sweep
    streamed = tier == "streamed"
    backend_steps = 0
    i = first
    while i < iters:
        cz = _chaos.active()
        if cz is not None:
            cz.maybe_kill(i)
        # the sweep-boundary state, read only by the rungs
        prev = (factors, lam) if policy is not None else None
        rewind = None
        with span("cpd.sweep", sweep=i, streamed=streamed) as sp:
            fold = _als_fold
            while True:
                try:
                    outs, state, factors, lam = sweep(
                        state, factors, fold=fold, carry=lam)
                except Exception as exc:
                    if rebuild is None or policy is None:
                        raise
                    kind = classify(exc)
                    sharded = isinstance(state, engine.dist.DistState)
                    where = ({"mesh": state.mesh, "dist": state.dist}
                             if sharded else {})
                    if kind == "compile" \
                            and backend_steps < policy.max_backend_steps:
                        nb = next_backend(state.config.backend,
                                          state.config.torch_device)
                        if nb is None:
                            raise
                        backend_steps += 1
                        record_degradation("compile", state.config.backend,
                                           nb, site="cpd.backend", sweep=i)
                        factors, lam = prev
                        state = rebuild(dataclasses.replace(
                            state.config, backend=nb), **where)
                        continue
                    if kind == "exchange" and sharded \
                            and state.dist.exchange == "permute":
                        # the same layouts and outputs, moved another way
                        record_degradation("exchange", "permute",
                                           "all_gather", site="cpd.exchange",
                                           sweep=i)
                        factors, lam = prev
                        state = state.replace(dist=dataclasses.replace(
                            state.dist, exchange="all_gather"))
                        continue
                    if kind == "device_lost" and sharded:
                        lost = getattr(exc, "lost", 1)
                        mesh = engine.dist.surviving_mesh(
                            state.mesh, lost, [s.kappa for s in state.statics],
                            data_axis=state.dist.data_axis)
                        new_n = mesh.shape[state.dist.data_axis]
                        record_degradation("device_lost", state.n_dev, new_n,
                                           site="cpd.mesh", sweep=i,
                                           lost=lost)
                        # the latest snapshot when there is one (a real
                        # loss takes the shards' buffers with it), else the
                        # sweep's start, which the failed dispatch left
                        factors, lam = prev
                        resume_at = i
                        snap = store.latest(fp) if store is not None \
                            else None
                        if snap is not None:
                            factors, lam, fits = _restore(snap, dev)
                            resume_at = snap.sweep
                        state = rebuild(state.config, mesh=mesh,
                                        dist=state.dist)
                        if resume_at == i:
                            prev = (factors, lam)
                            continue
                        rewind = resume_at
                        break
                    raise
                if cz is not None:
                    factors = tuple(cz.mangle_factors(i, factors))
                if policy is not None \
                        and not _guard.all_finite(factors, lam):
                    if fold is _als_fold_recovery:
                        raise FloatingPointError(
                            f"NaN/Inf burst in sweep {i} persisted "
                            "through the ridge-recovery replay")
                    # the layout is back at its start arrangement, so the
                    # replay sees exactly the pre-sweep problem
                    _guard.record_recovery("nan_rollback", sweep=i,
                                           streamed=streamed)
                    factors, lam = prev
                    fold = _als_fold_recovery
                    continue
                break
            if rewind is None and track_fit:
                fit = _fit(norm_x_sq, outs[len(factors) - 1], factors, lam)
                fits.append(fit)
                sp.set("fit", fit)
                _obs_gauge("cpd_fit", "latest ALS fit per tier").set(
                    tier, fit)
        if rewind is not None:
            i = rewind
            continue
        if store is not None and ((i + 1) % checkpoint_every == 0
                                  or i + 1 == iters):
            if isinstance(state, engine.dist.DistState):
                store.save(fp, i + 1, factors, lam, fits, mesh=state.mesh,
                           dist=state.dist)
            else:
                store.save(fp, i + 1, factors, lam, fits)
        i += 1
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
