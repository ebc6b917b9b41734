"""Deterministic fault injection (the port of ``repro.resilience.chaos``).

The faults a long decomposition dies of: a host -> device upload fails
transiently, the card runs out of memory on chunk ``k``, a cached plan
blob is torn mid-write, a factor matrix picks up a NaN, the process is
SIGKILLed between sweeps. This module injects exactly those, at fixed
ordinals of the hooks the production paths already call, so that the
degradation ladder, checkpoint/resume and the cache's checksums run in
tests and in ``chip_smoke.py`` instead of waiting for the first outage.

* **Seeded and ordinal-addressed.** Every injector fires at a fixed
  ordinal of its site a fixed number of times, then never again, so the
  retry or fallback that answers it succeeds deterministically.
* **Observable.** Every fired injection ticks the ``chaos_injections``
  counter (by site) and leaves a ``chaos.inject`` span, so
  :func:`repro_torch.obs.report.resilience_report` can pair each fault
  with the event that answered it.
* **Off by default, env-installable.** A hook costs one ``is None`` test
  while chaos is off. ``REPRO_CHAOS="upload_fail=1,oom_chunk=3,seed=7"``
  installs a spec at import; the string means what it means to the
  reference.

Single-device fault model (``ChaosSpec`` fields), with the hook that
fires it:

  ``upload_fail``    ``on_upload``: fail the Nth distinct chunk upload
                     (0-based) for ``upload_fail_times`` attempts
                     (answered by retry with backoff)
  ``oom_chunk``      ``on_chunk_compute``: raise :class:`ChaosOOM` at the
                     Nth streamed chunk compute, once (answered by
                     halving the chunk budget and replanning)
  ``oom_resident``   ``on_resident_init``: raise :class:`ChaosOOM` once
                     while the factory places the resident layout
                     (answered by the ``full -> stream`` rung)
  ``compile_fail``   ``on_dispatch``: every dispatch of these backends
                     raises :class:`ChaosCompileError` (answered by the
                     backend ladder ``cuda_fused -> cuda``, then
                     ``torch`` on the CPU only)
  ``nan_sweep``      ``mangle_factors``: NaN into ``factors[0][0, 0]``
                     after sweep N (answered by rollback and a replay
                     under the stronger ridge)
  ``kill_sweep``     ``maybe_kill``: SIGKILL at the start of sweep N
                     (answered by checkpoint/resume)
  ``corrupt_blob``   ``on_disk_save``: truncate the next ``PlanCache``
                     blob after it lands (answered by the checksum
                     quarantine and a cold rebuild)

Distributed fault model (hook: ``on_dist_dispatch``, before every
``engine.dist`` dispatch):

  ``exchange_fail``  raise :class:`ChaosExchangeError` at the Nth dist
                     dispatch that runs the permute exchange, once
                     (answered by the ``permute -> all_gather`` rung)
  ``device_lost``    raise :class:`ChaosDeviceLost` at the Nth dist
                     dispatch, once; ``device_lost_n`` devices die
                     (answered by re-sharding on the surviving mesh from
                     the latest snapshot)
  ``dist_transient`` fail the Nth dist dispatch for
                     ``dist_transient_times`` attempts (answered by retry
                     with backoff)
"""
from __future__ import annotations

import dataclasses
import os
import signal

from repro_torch.obs.metrics import counter as _counter
from repro_torch.obs.trace import span as _span

__all__ = ["ChaosError", "ChaosUploadError", "ChaosOOM",
           "ChaosCompileError", "ChaosExchangeError", "ChaosDeviceLost",
           "ChaosSpec", "Chaos", "install", "uninstall", "active",
           "from_env", "ENV_VAR"]

ENV_VAR = "REPRO_CHAOS"


class ChaosError(RuntimeError):
    """Base class for injected faults."""


class ChaosUploadError(ChaosError):
    """Injected transient host->device transfer failure."""


class ChaosOOM(ChaosError):
    """Injected device allocation failure (classified as OOM)."""


class ChaosCompileError(ChaosError):
    """Injected kernel build failure."""


class ChaosExchangeError(ChaosError):
    """Injected collective-exchange failure (distributed tier)."""


class ChaosDeviceLost(ChaosError):
    """Injected device loss; ``lost`` carries how many devices died."""

    def __init__(self, msg: str, lost: int = 1):
        super().__init__(msg)
        self.lost = lost


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Declarative, seeded fault plan (see module docstring); the
    reference's fields, so one spec string parses alike in both
    packages."""

    seed: int = 0
    upload_fail: int | None = None
    upload_fail_times: int = 1
    oom_chunk: int | None = None
    oom_resident: bool = False
    compile_fail: tuple = ()
    nan_sweep: int | None = None
    kill_sweep: int | None = None
    corrupt_blob: bool = False
    exchange_fail: int | None = None
    device_lost: int | None = None
    device_lost_n: int = 1
    dist_transient: int | None = None
    dist_transient_times: int = 1

    def __post_init__(self):
        if self.upload_fail_times < 1:
            raise ValueError("upload_fail_times must be >= 1")
        if self.dist_transient_times < 1:
            raise ValueError("dist_transient_times must be >= 1")
        if self.device_lost_n < 1:
            raise ValueError("device_lost_n must be >= 1")


class Chaos:
    """Live injector: a :class:`ChaosSpec` plus the ordinal counters that
    make every fault fire at exactly one deterministic point."""

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self._upload_ordinal: dict = {}      # (mode, chunk) -> ordinal
        self._upload_attempts: dict = {}     # (mode, chunk) -> failed tries
        self._compute_calls = 0
        self._dist_calls = 0                 # distinct dist dispatches
        self._exchange_calls = 0             # ... of which run permute
        self._dist_attempts = 0              # transient tries at target
        self._fired: set[str] = set()

    def _record(self, site: str, **attrs) -> None:
        _counter("chaos_injections",
                 "injected faults by site (resilience.chaos)").inc(site)
        with _span("chaos.inject", site=site, **attrs):
            pass

    def fired(self, site: str) -> bool:
        return site in self._fired

    def on_upload(self, mode: int, chunk: int, attempt: int) -> None:
        """Called per upload attempt; raises ChaosUploadError while the
        targeted distinct upload has failures left."""
        fail_at = self.spec.upload_fail
        if fail_at is None:
            return
        key = (mode, chunk)
        ordinal = self._upload_ordinal.setdefault(
            key, len(self._upload_ordinal))
        if ordinal != fail_at:
            return
        tries = self._upload_attempts.get(key, 0)
        if tries >= self.spec.upload_fail_times:
            return
        self._upload_attempts[key] = tries + 1
        self._fired.add("upload_fail")
        self._record("upload_fail", mode=mode, chunk=chunk, attempt=attempt)
        raise ChaosUploadError(
            f"injected upload failure (mode {mode}, chunk {chunk}, "
            f"attempt {attempt})")

    def on_chunk_compute(self, mode: int, chunk: int) -> None:
        """Called before each streamed chunk compute; raises ChaosOOM once
        at the configured call ordinal."""
        at = self.spec.oom_chunk
        ordinal = self._compute_calls
        self._compute_calls += 1
        if at is None or "oom_chunk" in self._fired or ordinal != at:
            return
        self._fired.add("oom_chunk")
        self._record("oom_chunk", mode=mode, chunk=chunk)
        raise ChaosOOM(
            f"injected CUDA out of memory at chunk compute {ordinal} "
            f"(mode {mode}, chunk {chunk})")

    def on_resident_init(self) -> None:
        """Called before the full-residency placement; raises ChaosOOM
        once when ``oom_resident`` is set."""
        if not self.spec.oom_resident or "oom_resident" in self._fired:
            return
        self._fired.add("oom_resident")
        self._record("oom_resident")
        raise ChaosOOM("injected CUDA out of memory placing the resident "
                       "layout")

    def on_dispatch(self, backend: str) -> None:
        """Called once per engine dispatch (``engine.mttkrp``,
        ``engine.all_modes``, a streamed mode); every dispatch of a
        backend in ``compile_fail`` raises."""
        if backend in self.spec.compile_fail:
            self._fired.add("compile_fail")
            self._record("compile_fail", backend=backend)
            raise ChaosCompileError(
                f"injected kernel build failure for backend {backend!r}")

    def on_dist_dispatch(self, backend: str, *, exchange: str, n_dev: int,
                         attempt: int = 0) -> None:
        """Called before each distributed (``engine.dist``) dispatch.

        Ordinals advance once per distinct dispatch (``attempt == 0``), so
        a retried dispatch keeps its ordinal. Checks in the reference's
        order: build (``compile_fail``, shared with ``on_dispatch``),
        device loss, exchange failure, transient failure.
        """
        self.on_dispatch(backend)
        if attempt == 0:
            ordinal = self._dist_calls
            self._dist_calls += 1
            exchange_ordinal = self._exchange_calls
            if exchange == "permute":
                self._exchange_calls += 1
        else:
            ordinal = self._dist_calls - 1
            exchange_ordinal = self._exchange_calls - 1
        at = self.spec.device_lost
        if at is not None and ordinal == at \
                and "device_lost" not in self._fired:
            lost = self.spec.device_lost_n
            self._fired.add("device_lost")
            self._record("device_lost", ordinal=ordinal, lost=lost,
                         n_dev=n_dev)
            raise ChaosDeviceLost(
                f"injected loss of {lost} device(s) at dist dispatch "
                f"{ordinal} (mesh had {n_dev})", lost=lost)
        at = self.spec.exchange_fail
        if at is not None and exchange == "permute" \
                and exchange_ordinal == at \
                and "exchange_fail" not in self._fired:
            self._fired.add("exchange_fail")
            self._record("exchange_fail", ordinal=exchange_ordinal)
            raise ChaosExchangeError(
                f"injected permute exchange failure at dist dispatch "
                f"{exchange_ordinal}")
        at = self.spec.dist_transient
        if at is not None and ordinal == at \
                and self._dist_attempts < self.spec.dist_transient_times:
            self._dist_attempts += 1
            self._fired.add("dist_transient")
            self._record("dist_transient", ordinal=ordinal,
                         attempt=attempt)
            raise ChaosUploadError(
                f"injected transient dist dispatch failure at ordinal "
                f"{ordinal} (attempt {attempt})")

    def mangle_factors(self, sweep: int, factors):
        """Called after each ALS sweep; at the configured sweep (once)
        returns the factors with NaN in a clone of ``factors[0][0, 0]``
        (the caller's tensors are left as they were)."""
        if self.spec.nan_sweep is None or sweep != self.spec.nan_sweep \
                or "nan_burst" in self._fired:
            return factors
        self._fired.add("nan_burst")
        self._record("nan_burst", sweep=sweep)
        factors = list(factors)
        f0 = factors[0].clone()
        f0[0, 0] = float("nan")
        factors[0] = f0
        return tuple(factors)

    def maybe_kill(self, sweep: int) -> None:
        """Called at the start of each ALS sweep; SIGKILLs the process at
        the configured sweep (the preemption scenario)."""
        if self.spec.kill_sweep is None or sweep != self.spec.kill_sweep:
            return
        self._record("kill_sweep", sweep=sweep)
        os.kill(os.getpid(), signal.SIGKILL)

    def on_disk_save(self, path: str) -> None:
        """Called after a ``PlanCache`` blob lands on disk; truncates it
        once (a torn write) when ``corrupt_blob`` is set."""
        if not self.spec.corrupt_blob or "corrupt_blob" in self._fired:
            return
        self._fired.add("corrupt_blob")
        self._record("corrupt_blob", path=os.path.basename(path))
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))


_ACTIVE: Chaos | None = None


def install(spec: ChaosSpec | Chaos) -> Chaos:
    """Install ``spec`` as the process-global injector; returns it."""
    global _ACTIVE
    _ACTIVE = spec if isinstance(spec, Chaos) else Chaos(spec)
    return _ACTIVE


def uninstall() -> Chaos | None:
    """Remove the global injector (hooks become no-ops); returns it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, None
    return prev


def active() -> Chaos | None:
    """The global injector, or ``None`` while chaos is off."""
    return _ACTIVE


def from_env(value: str) -> ChaosSpec:
    """Parse a ``REPRO_CHAOS`` spec string, as the reference does.

    Comma-separated ``key=value`` items naming :class:`ChaosSpec` fields;
    ``compile_fail`` takes ``|``-separated backend names; the bare flags
    ``corrupt_blob`` / ``oom_resident`` mean ``True``::

        REPRO_CHAOS="upload_fail=1,oom_chunk=3,kill_sweep=2,seed=7"
        REPRO_CHAOS="compile_fail=cuda_fused|cuda,corrupt_blob"
    """
    kwargs: dict = {}
    for item in value.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, raw = item.partition("=")
        key = key.strip()
        raw = raw.strip()
        if key in ("corrupt_blob", "oom_resident"):
            kwargs[key] = raw.lower() not in ("0", "false") if raw else True
        elif key == "compile_fail":
            kwargs[key] = tuple(b for b in raw.split("|") if b)
        elif key in ("seed", "upload_fail", "upload_fail_times",
                     "oom_chunk", "nan_sweep", "kill_sweep",
                     "exchange_fail", "device_lost", "device_lost_n",
                     "dist_transient", "dist_transient_times"):
            kwargs[key] = int(raw)
        else:
            raise ValueError(f"unknown {ENV_VAR} key {key!r}")
    return ChaosSpec(**kwargs)


def _init_from_env() -> None:
    value = os.environ.get(ENV_VAR, "").strip()
    if not value or value.lower() in ("0", "false", "off"):
        return
    install(from_env(value))


_init_from_env()
