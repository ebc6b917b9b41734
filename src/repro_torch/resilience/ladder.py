"""Policy-driven degradation ladder: classify failures, step down, retry
(the port of ``repro.resilience.ladder``).

*Degrade, never die silently*: a kernel build failure steps the backend
down ``cuda_fused -> cuda -> torch`` on the CPU
(``engine.config.BACKEND_LADDER``) and ``cuda_fused -> cuda`` on the card
(``CARD_LADDER``, no plain PyTorch rung there); a device OOM steps residency ``full
-> stream`` (``engine.factory.make_engine``) or halves the streamed
chunk budget and replans (``engine.stream.stream_mttkrp``); a transient
transfer failure retries with bounded exponential backoff and seeded
jitter, so chaos runs replay identically. Every transition is a
``resilience_degradations`` counter label plus a ``resilience.degrade``
span, every retry a ``resilience_retries`` label plus a
``resilience.retry`` span. A failure ``classify`` cannot name is
``"fatal"`` and is never stepped over.

The distributed tier adds two rungs (``core.cpd.als_sweeps``): an
exchange failure steps ``permute -> all_gather``, and a lost device
re-shards the state on the surviving mesh from the latest snapshot; a
transient dist dispatch retries with the same backoff
(``engine.dist``).

The ladder is off unless asked for: ``ladder=None`` with no ambient
policy means no ladder. ``REPRO_LADDER=1`` (or ``key=value`` items naming
:class:`LadderPolicy` fields) installs an ambient policy at import, which
every ``ladder=None`` call site picks up through :func:`resolve_policy`;
``ladder=False`` still opts out.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import time

import torch

from repro_torch.kernels.build import KernelBuildError
from repro_torch.obs.metrics import counter as _counter
from repro_torch.obs.trace import span as _span

from .chaos import (ChaosCompileError, ChaosDeviceLost,
                    ChaosExchangeError, ChaosOOM, ChaosUploadError)

__all__ = ["LadderPolicy", "DEFAULT_POLICY", "classify", "next_backend",
           "backoff_delay", "record_degradation", "record_retry",
           "resolve_policy", "from_env", "install_ambient",
           "uninstall_ambient", "ambient", "ENV_VAR"]

ENV_VAR = "REPRO_LADDER"

# The reference's message markers (its failures carry their status only in
# the message), kept so that every answer it gives stays the same here.
_OOM_MARKERS = ("resource_exhausted", "out of memory", "oom")
_COMPILE_MARKERS = ("mosaic", "lowering", "unsupported", "unimplemented",
                    "compilation failure", "failed to compile",
                    "triton", "nvcc", "no kernel image", "invalid ptx")
_TRANSIENT_MARKERS = ("unavailable", "deadline_exceeded",
                      "connection reset", "transfer failed")
_DEVICE_LOST_MARKERS = ("device lost", "device is lost",
                        "failed to query device")
_EXCHANGE_MARKERS = ("collective_permute", "ppermute",
                     "collective timed out")

# The card's own failures. The kernel wrappers raise
# ``RuntimeError("... launch failed: cudaError <n>")``; PyTorch's
# ``torch.AcceleratorError`` / ``RuntimeError("CUDA error: ...")`` name
# the same errors in words. After a sticky error (illegal address, a
# device-side trap such as ``chunk_walk.cuh``'s on a malformed table row,
# a failed launch) the CUDA context is gone: nothing may run on it, so
# no rung is tried.
_CUDA_ERROR_RE = re.compile(r"cudaerror[ :]*(\d+)")
_CUDA_OOM = {2}                       # cudaErrorMemoryAllocation
_CUDA_COMPILE = {209, 218, 222}       # no kernel image, invalid PTX,
                                      # unsupported PTX version
_CUDA_STICKY = {700, 710, 719}        # illegal address, device assert,
                                      # launch failure
_STICKY_MARKERS = ("illegal memory access", "device-side assert",
                   "unspecified launch failure", "illegal instruction",
                   "misaligned address")


@dataclasses.dataclass(frozen=True)
class LadderPolicy:
    """Knobs of the retry/fallback chain (frozen, safely shareable).

    Attributes:
      max_retries: attempts beyond the first for *transient* failures.
      backoff_base_s / backoff_cap_s: attempt ``a`` sleeps
        ``min(base * 2**a, cap)`` scaled by jitter.
      jitter: fraction of the delay randomized (0 = none), drawn from a
        seeded hash of (seed, token, attempt).
      seed: jitter seed.
      max_budget_halvings: how often the streamed chunk budget may halve
        on OOM before the failure is surfaced.
      max_backend_steps: how many backend rungs may be descended.
    """

    max_retries: int = 3
    backoff_base_s: float = 0.005
    backoff_cap_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0
    max_budget_halvings: int = 4
    max_backend_steps: int = 3

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")


DEFAULT_POLICY = LadderPolicy()

_AMBIENT: LadderPolicy | None = None


def install_ambient(policy: LadderPolicy) -> LadderPolicy:
    """Install ``policy`` as the process-wide default of every
    ``ladder=None`` call site."""
    global _AMBIENT
    if not isinstance(policy, LadderPolicy):
        raise TypeError("install_ambient wants a LadderPolicy")
    _AMBIENT = policy
    return _AMBIENT


def uninstall_ambient() -> LadderPolicy | None:
    """Remove the ambient policy (``ladder=None`` means off again)."""
    global _AMBIENT
    prev, _AMBIENT = _AMBIENT, None
    return prev


def ambient() -> LadderPolicy | None:
    """The ambient (env/process-default) policy, or ``None``."""
    return _AMBIENT


def resolve_policy(ladder) -> LadderPolicy | None:
    """A user-facing ``ladder=`` argument as a policy: ``None`` -> the
    ambient policy (off when none is installed), ``False`` -> off,
    ``True`` -> :data:`DEFAULT_POLICY`, a policy -> itself."""
    if ladder is None:
        return _AMBIENT
    if ladder is False:
        return None
    if ladder is True:
        return DEFAULT_POLICY
    if isinstance(ladder, LadderPolicy):
        return ladder
    raise TypeError(f"ladder must be bool/None/LadderPolicy, "
                    f"got {type(ladder).__name__}")


def from_env(value: str) -> LadderPolicy:
    """Parse a ``REPRO_LADDER`` policy string, as the reference does:
    ``"1"``/``"true"``/``"on"``/``"default"`` mean :data:`DEFAULT_POLICY`,
    else comma-separated ``key=value`` items naming :class:`LadderPolicy`
    fields (``"max_retries=5,backoff_cap_s=1.0,seed=7"``)."""
    value = value.strip()
    if value.lower() in ("1", "true", "on", "default"):
        return DEFAULT_POLICY
    fields = {f.name: f.type for f in dataclasses.fields(LadderPolicy)}
    kwargs: dict = {}
    for item in value.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, raw = item.partition("=")
        key, raw = key.strip(), raw.strip()
        if key not in fields:
            raise ValueError(f"unknown {ENV_VAR} key {key!r}")
        kwargs[key] = (float(raw) if "float" in str(fields[key])
                       else int(raw))
    return LadderPolicy(**kwargs)


def _init_from_env() -> None:
    value = os.environ.get(ENV_VAR, "").strip()
    if not value or value.lower() in ("0", "false", "off"):
        return
    install_ambient(from_env(value))


def classify(exc: BaseException) -> str:
    """Failure taxonomy: ``"oom" | "compile" | "transient" |
    "device_lost" | "exchange" | "fatal"``.

    Injected faults classify by type, the card's by type or by their
    ``cudaError`` number (a sticky one is ``"fatal"``), the rest by the
    reference's message markers. Anything unrecognized is ``"fatal"``.
    """
    if isinstance(exc, ChaosOOM):
        return "oom"
    if isinstance(exc, ChaosCompileError):
        return "compile"
    if isinstance(exc, ChaosDeviceLost):
        return "device_lost"
    if isinstance(exc, ChaosExchangeError):
        return "exchange"
    if isinstance(exc, ChaosUploadError):
        return "transient"
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return "oom"
    if isinstance(exc, KernelBuildError):
        return "compile"
    msg = f"{type(exc).__name__}: {exc}".lower()
    m = _CUDA_ERROR_RE.search(msg)
    if m is not None:
        code = int(m.group(1))
        if code in _CUDA_OOM:
            return "oom"
        if code in _CUDA_COMPILE:
            return "compile"
        if code in _CUDA_STICKY:
            return "fatal"
    if any(m in msg for m in _STICKY_MARKERS):
        return "fatal"
    if any(m in msg for m in _OOM_MARKERS):
        return "oom"
    if any(m in msg for m in _COMPILE_MARKERS):
        return "compile"
    if any(m in msg for m in _DEVICE_LOST_MARKERS):
        return "device_lost"
    if any(m in msg for m in _EXCHANGE_MARKERS):
        return "exchange"
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


def next_backend(backend: str, device) -> str | None:
    """The next (more portable) rung under ``backend`` for tensors on
    ``device``, or ``None`` at the bottom and for backends outside the
    ladder. On a CUDA device the ladder is ``CARD_LADDER``: it ends at
    ``cuda``, the last hand-written kernel backend, where the reference
    goes on to plain XLA."""
    from repro_torch.engine.config import BACKEND_LADDER, CARD_LADDER

    ladder = (CARD_LADDER if torch.device(device).type == "cuda"
              else BACKEND_LADDER)
    try:
        i = ladder.index(backend)
    except ValueError:
        return None
    if i + 1 >= len(ladder):
        return None
    return ladder[i + 1]


def backoff_delay(policy: LadderPolicy, attempt: int, token="") -> float:
    """Bounded exponential backoff with deterministic seeded jitter, the
    reference's delays bit for bit: ``token`` names the retried operation
    so two retriers don't share a jitter stream."""
    base = min(policy.backoff_base_s * (2.0 ** attempt),
               policy.backoff_cap_s)
    if policy.jitter <= 0.0:
        return base
    h = hashlib.sha256(
        repr((policy.seed, token, attempt)).encode()).digest()
    u = int.from_bytes(h[:8], "big") / float(1 << 64)   # [0, 1)
    return base * (1.0 - policy.jitter * u)


def record_degradation(kind: str, frm, to, **attrs) -> None:
    """One ladder transition: a ``resilience_degradations`` counter label
    ``kind:frm->to`` and a ``resilience.degrade`` span."""
    _counter("resilience_degradations",
             "degradation-ladder transitions (kind:from->to)").inc(
                 f"{kind}:{frm}->{to}")
    with _span("resilience.degrade", kind=kind, frm=str(frm), to=str(to),
               **attrs):
        pass


def record_retry(what: str, attempt: int, delay_s: float, **attrs) -> None:
    """One transient-failure retry (counter + span), then sleep the
    backoff delay."""
    _counter("resilience_retries",
             "transient-failure retries by site").inc(what)
    with _span("resilience.retry", what=what, attempt=attempt,
               delay_s=delay_s, **attrs):
        if delay_s > 0:
            time.sleep(delay_s)


_init_from_env()
