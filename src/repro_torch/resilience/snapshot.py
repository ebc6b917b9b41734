"""Atomic, content-addressed ALS sweep snapshots (the port of
``repro.resilience.snapshot``).

A snapshot is bound to a :func:`fingerprint` of the problem: the tensor's
bytes, the rank, the config's repr, the start mode and the initial
factors' identity (the port hashes the initial factors' bytes, or the
generator's seed and state, where the reference hashes its PRNG key). A
resume refuses a snapshot of another problem, because it continues bit
for bit: at a sweep boundary the layout has rotated back to its start,
so ``(factors, lam)`` are the whole dynamic state.

Writes go to a temporary file in the destination directory and are
published with ``os.replace``; the payload digest is part of the file
name, so a torn blob is found on load, renamed ``*.corrupt``, and the
loader falls back to the next older sweep. Saves, loads and corruptions
tick the ``snapshot_events`` counter inside ``resilience.snapshot_*``
spans.

Layout: ``<dir>/<fp16>-sweep<NNNNNN>-<digest12>.npz``, one flat npz a
snapshot (``factor{i}``, ``lam``, ``fits`` and a JSON ``meta``), the
``keep`` newest kept per fingerprint; the reference's format, so each
package reads the other's blobs.

The store reads and writes both formats: v1 (one array a factor) and
the sharded v2 a distributed sweep writes (``save(mesh=, dist=)``:
``factor{i}_s{j}`` row shards, the saving mesh's
:func:`mesh_fingerprint` and the ``DistConfig`` repr in the
digest-covered meta; reassembled on the host at load). The problem
fingerprint leaves the mesh out: at a sweep boundary ``(factors, lam)``
do not depend on it, so a run killed on 4 shards resumes on 2 or 1,
re-sharded onto the current mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs.metrics import counter as _counter
from repro_torch.obs.trace import span as _span

__all__ = ["fingerprint", "payload_digest", "mesh_fingerprint",
           "factor_shards", "Snapshot", "SnapshotStore", "as_store"]

_FORMAT_VERSION = 1
_SHARDED_VERSION = 2
_NAME_RE = re.compile(
    r"(?P<fp>[0-9a-f]{16})-sweep(?P<sweep>\d{6})-(?P<digest>[0-9a-f]{12})"
    r"\.npz")


def _host(a) -> np.ndarray:
    """``a`` as a host numpy array (a torch tensor is copied off its
    device)."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def fingerprint(indices, values, dims: Sequence[int], rank: int,
                config=None, key=None, start_mode: int = 0,
                extra: str = "") -> str:
    """Content address of one decomposition problem (sha256 hex), the
    reference's hash: the tensor's bytes and every knob that changes the
    computation. ``key`` is the initial factors' identity (any array;
    ``core.cpd.init_key``)."""
    h = hashlib.sha256()
    h.update(repr((tuple(int(d) for d in dims), int(rank),
                   int(start_mode), repr(config), extra,
                   _FORMAT_VERSION)).encode())
    h.update(np.ascontiguousarray(indices).tobytes())
    h.update(np.ascontiguousarray(values).tobytes())
    if key is not None:
        h.update(np.asarray(key).tobytes())
    return h.hexdigest()


def payload_digest(arrays: dict) -> str:
    """Order-stable sha256 over a dict of numpy arrays (key order is the
    caller's contract): name, dtype, shape and bytes of each. The snapshot
    store and the ``PlanCache`` disk tier verify blobs with it, as in the
    reference."""
    h = hashlib.sha256()
    for name in arrays:
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def mesh_fingerprint(mesh) -> dict:
    """JSON-able identity of a :class:`~repro_torch.launch.mesh.Mesh`:
    the reference's ``n_dev`` (mesh positions), ``axes`` (``{axis:
    size}``) and ``platform`` (the devices' type, ``cuda`` or ``cpu``),
    and ``distinct``, how many distinct devices hold the shards (several
    shards may share a card)."""
    devices = np.asarray(mesh.devices).reshape(-1)
    return {"n_dev": int(devices.size),
            "axes": {str(k): int(v) for k, v in dict(mesh.shape).items()},
            "platform": str(getattr(devices[0], "type", "unknown")),
            "distinct": len(set(devices))}


def factor_shards(arr) -> list[tuple[int, np.ndarray]]:
    """``(row_offset, host_shard)`` pairs covering ``arr`` once. The
    port's factors are whole tensors (replicated over the mesh, as the
    reference's distributed sweep leaves them), so this is one ``(0,
    full)`` entry."""
    return [(0, _host(arr))]


def as_store(checkpoint) -> "SnapshotStore | None":
    """A user-facing ``checkpoint=`` argument as a store: ``None`` /
    ``False`` -> off, a directory path -> a fresh :class:`SnapshotStore`
    over it, a store -> itself."""
    if checkpoint is None or checkpoint is False:
        return None
    if isinstance(checkpoint, SnapshotStore):
        return checkpoint
    return SnapshotStore(os.fspath(checkpoint))


@dataclasses.dataclass
class Snapshot:
    """One loaded sweep snapshot (host numpy; ``sweep`` is the number of
    *completed* sweeps, so a resume continues at sweep ``sweep``)."""

    fingerprint: str
    sweep: int
    factors: list[np.ndarray]
    lam: np.ndarray
    fits: list[float]
    path: str
    mesh: dict | None = None      # saving mesh's fingerprint (v2 blobs)
    dist: str | None = None       # the saving run's DistConfig repr (v2)


def _events():
    return _counter("snapshot_events",
                    "sweep snapshot saves/loads/corruptions")


class SnapshotStore:
    """Directory of fingerprinted sweep snapshots; see module docstring.

    ``save`` is one host copy and one npz write; ``latest`` returns the
    newest *intact* snapshot for a fingerprint, quarantining any corrupt
    blob on the way down.
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.dir = os.fspath(directory)
        self.keep = keep
        self.saves = 0
        self.loads = 0
        self.corrupt = 0

    def save(self, fp: str, sweep: int, factors, lam,
             fits: Sequence[float] = (), *, mesh=None, dist=None) -> str:
        """Persist one completed-sweep state; returns the blob's path.
        Factors and ``lam`` may be numpy arrays or tensors on any device.
        With ``mesh=`` the blob is the sharded v2 format (module
        docstring), else v1."""
        with _span("resilience.snapshot_save", sweep=sweep) as sp:
            arrays: dict = {}
            if mesh is not None:
                shard_meta = []
                for i, f in enumerate(factors):
                    shards = factor_shards(f)
                    shard_meta.append(
                        {"rows": [r for r, _ in shards],
                         "shape": [int(s) for s in tuple(f.shape)]})
                    for j, (_, data) in enumerate(shards):
                        arrays[f"factor{i}_s{j}"] = data
            else:
                for i, f in enumerate(factors):
                    arrays[f"factor{i}"] = _host(f)
            arrays["lam"] = _host(lam)
            arrays["fits"] = np.asarray(list(fits), dtype=np.float64)
            meta = {"version": (_SHARDED_VERSION if mesh is not None
                                else _FORMAT_VERSION),
                    "fingerprint": fp, "sweep": int(sweep),
                    "n_factors": len(factors)}
            if mesh is not None:
                meta["shards"] = shard_meta
                meta["mesh"] = mesh_fingerprint(mesh)
                meta["dist"] = repr(dist)
            arrays["meta"] = np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8)
            digest = payload_digest(arrays)
            os.makedirs(self.dir, exist_ok=True)
            fn = os.path.join(
                self.dir, f"{fp[:16]}-sweep{sweep:06d}-{digest[:12]}.npz")
            tmp = os.path.join(self.dir,
                               f".tmp-{os.getpid()}-{fp[:16]}-{sweep}")
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, fn)
            sp.set("path", os.path.basename(fn))
        self.saves += 1
        _events().inc("save")
        self._gc(fp[:16])
        return fn

    def _gc(self, fp16: str) -> None:
        for _, fn in self._blobs(fp16)[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, fn))
            except OSError:
                pass

    def _blobs(self, fp16: str | None = None) -> list[tuple[int, str]]:
        """(sweep, filename) of every snapshot blob, sweep-ascending."""
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        out = []
        for name in names:
            m = _NAME_RE.fullmatch(name)
            if m and (fp16 is None or m.group("fp") == fp16):
                out.append((int(m.group("sweep")), name))
        return sorted(out)

    def load(self, path: str) -> Snapshot:
        """Load and checksum-verify one blob (v1 or v2); raises
        ``ValueError`` on corruption (:meth:`latest` quarantines and
        falls back instead)."""
        m = _NAME_RE.fullmatch(os.path.basename(path))
        if m is None:
            raise ValueError(f"not a snapshot blob: {path}")
        with _span("resilience.snapshot_load") as sp:
            with np.load(path) as blob:
                arrays = {name: blob[name] for name in blob.files}
            meta = json.loads(bytes(arrays["meta"]).decode())
            sharded = meta["version"] >= _SHARDED_VERSION
            # the digest in save order: factors (or their shards), lam,
            # fits, meta
            ordered: dict = {}
            if sharded:
                for i, sm in enumerate(meta["shards"]):
                    for j in range(len(sm["rows"])):
                        ordered[f"factor{i}_s{j}"] = \
                            arrays[f"factor{i}_s{j}"]
            else:
                for i in range(meta["n_factors"]):
                    ordered[f"factor{i}"] = arrays[f"factor{i}"]
            ordered["lam"] = arrays["lam"]
            ordered["fits"] = arrays["fits"]
            ordered["meta"] = arrays["meta"]
            if payload_digest(ordered)[:12] != m.group("digest"):
                raise ValueError(
                    f"snapshot payload digest mismatch: {path}")
            sp.set("sweep", meta["sweep"])
            if sharded:
                factors = []
                for i, sm in enumerate(meta["shards"]):
                    first = arrays[f"factor{i}_s0"]
                    full = np.empty(tuple(sm["shape"]), dtype=first.dtype)
                    for j, row0 in enumerate(sm["rows"]):
                        data = arrays[f"factor{i}_s{j}"]
                        full[row0:row0 + data.shape[0]] = data
                    factors.append(full)
            else:
                factors = [arrays[f"factor{i}"]
                           for i in range(meta["n_factors"])]
        self.loads += 1
        _events().inc("load")
        return Snapshot(
            fingerprint=meta["fingerprint"], sweep=meta["sweep"],
            factors=factors, lam=arrays["lam"],
            fits=list(arrays["fits"]), path=path,
            mesh=meta.get("mesh"), dist=meta.get("dist"))

    def latest(self, fp: str) -> Snapshot | None:
        """Newest intact snapshot for ``fp``; corrupt blobs met on the
        way are quarantined (``*.corrupt``) and skipped."""
        for _, name in reversed(self._blobs(fp[:16])):
            path = os.path.join(self.dir, name)
            try:
                snap = self.load(path)
            except Exception:
                self._quarantine(path)
                continue
            if snap.fingerprint != fp:  # 16-hex-char prefix collision
                continue
            return snap
        return None

    def _quarantine(self, path: str) -> None:
        self.corrupt += 1
        _events().inc("corrupt")
        with _span("resilience.snapshot_quarantine",
                   path=os.path.basename(path)):
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
