"""Resilience for the port (the port of ``repro.resilience``): fault
injection, checkpoint/resume, the degradation ladder and the NaN guard.

:mod:`~repro_torch.resilience.snapshot`
    Atomic, content-addressed sweep snapshots. ``cp_als`` /
    ``cp_als_stream`` write one every ``checkpoint_every`` sweeps;
    ``resume=True`` loads the newest intact one *for the same problem
    fingerprint* and replays the remaining sweeps, bit for bit the
    uninterrupted run on the CPU. Reads and writes the reference's v1 and
    sharded v2 blobs (v2: a distributed run, with the mesh's
    fingerprint); a run killed on 4 shards resumes on 2 or 1.

:mod:`~repro_torch.resilience.ladder`
    The rungs, as in the reference:

    ======================  =======================================
    failure                 rung
    ======================  =======================================
    kernel build            backend ``cuda_fused -> cuda -> torch ->
                            ref`` (the state rebuilt from the tensor)
    OOM (resident place)    residency ``full -> stream``
    OOM (streamed chunk)    chunk budget halved + replan (cached)
    transient transfer      retry with seeded backoff
    exchange failure        ``permute -> all_gather`` (distributed)
    device lost             re-shard on the surviving mesh from the
                            latest snapshot (distributed)
    transient dist dispatch retry with seeded backoff
    sticky CUDA error       none: ``"fatal"``, the context is gone
    ======================  =======================================

    Every transition is a ``resilience_degradations`` /
    ``resilience_retries`` counter label and a span. ``REPRO_LADDER``
    installs an ambient policy that every ``ladder=None`` site picks up.

:mod:`~repro_torch.resilience.chaos`
    Seeded fault injectors at the hooks of the stream, the factory, the
    plan cache, the engine's dispatch and the ALS sweep; ``REPRO_CHAOS``
    installs a spec from the environment.
    :func:`repro_torch.obs.report.resilience_report` pairs each fired
    fault with the event that answered it.

:mod:`~repro_torch.resilience.guard`
    The per-sweep NaN/Inf check behind the rollback.

"""
from . import chaos, ladder
from .chaos import (Chaos, ChaosCompileError, ChaosDeviceLost, ChaosError,
                    ChaosExchangeError, ChaosOOM, ChaosSpec, ChaosUploadError,
                    active, from_env, install, uninstall)
from .snapshot import (Snapshot, SnapshotStore, as_store, factor_shards,
                       fingerprint, mesh_fingerprint, payload_digest)
from .ladder import (DEFAULT_POLICY, LadderPolicy, ambient, backoff_delay,
                     classify, install_ambient, next_backend,
                     record_degradation, record_retry, resolve_policy,
                     uninstall_ambient)
from .guard import all_finite, record_recovery

# The package-level ``from_env`` is chaos's (REPRO_CHAOS); the ladder's
# REPRO_LADDER parser stays ``ladder.from_env``, as in the reference.
__all__ = [
    "chaos", "ladder", "Chaos", "ChaosSpec", "ChaosError",
    "ChaosUploadError", "ChaosOOM", "ChaosCompileError",
    "ChaosExchangeError", "ChaosDeviceLost", "install", "uninstall",
    "active", "from_env",
    "Snapshot", "SnapshotStore", "as_store", "fingerprint",
    "payload_digest", "factor_shards", "mesh_fingerprint",
    "LadderPolicy", "DEFAULT_POLICY", "classify", "next_backend",
    "backoff_delay", "record_degradation", "record_retry",
    "resolve_policy", "ambient", "install_ambient", "uninstall_ambient",
    "all_finite", "record_recovery",
]
