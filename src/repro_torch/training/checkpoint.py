"""Train-state checkpoints: atomic, checksummed, retained, saved in the
background. The reference's ``training/checkpoint.py``.

Each step is ONE flat ``.npz`` (the state's tensors in
:func:`~.tree.leaves` order, plus JSON meta with the data-pipeline
cursor) whose :func:`~repro_torch.resilience.snapshot.payload_digest` is
part of the *filename*, ``step_<NNNNNNNN>-<digest12>.npz``. Writes go to
a tmp file and are published with ``os.replace`` (atomic on POSIX), so a
preempted save can never corrupt the latest checkpoint; restores
recompute the digest, and :meth:`CheckpointManager.restore_latest`
quarantines a torn or bit-rotten blob (renamed ``*.corrupt``) and falls
back to the next-older step instead of resuming from garbage. A save
copies the state to the host before it returns (the train step then
updates its tensors in place) and writes on a worker thread. A restore
puts each tensor on the device and in the dtype of ``like``'s (a
bfloat16 tensor is stored as float32, exactly).

A sharded state (``sharding.Sharded`` leaves) is gathered whole before
it is written, so the blob and its digest do not depend on the mesh.
``restore(shardings=)`` reshards on load: each tensor is placed by its
spec over the current sharding context's mesh, whatever mesh (or single
device) wrote it (the reference's elastic shrink/grow).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re

import numpy as np
import torch

from .. import sharding
from ..obs.metrics import counter as _counter
from ..obs.trace import span as _span
from ..resilience.snapshot import payload_digest
from .tree import leaves, unflatten

_NAME_RE = re.compile(r"step_(?P<step>\d{8})-(?P<digest>[0-9a-f]{12})\.npz")


def _events():
    return _counter("checkpoint_events",
                    "train checkpoint saves/loads/corruptions")


def _payload(host_leaves, meta_bytes) -> dict:
    """Canonical digest/save order: leaves, then meta."""
    arrays = {f"leaf{i:05d}": a for i, a in enumerate(host_leaves)}
    arrays["meta"] = meta_bytes
    return arrays


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (bfloat16, which numpy lacks, as float32);
    a sharded tensor gathered whole."""
    if isinstance(x, sharding.Sharded):
        x = sharding.gather_tensor(x, "cpu")
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending = None

    # ------------------------------------------------------------------ save
    def save(self, state, data_state: dict | None = None):
        step = int(state["step"])
        # copy to the host synchronously (the step updates in place),
        # write in the background
        host = [_host(x) for x in leaves(state)]
        meta = {
            "step": step,
            "n_leaves": len(host),
            "data_state": data_state or {},
        }
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host, meta)
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host_leaves, meta):
        with _span("checkpoint.save", step=step) as sp:
            arrays = _payload(host_leaves, np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
            digest = payload_digest(arrays)
            final = os.path.join(
                self.dir, f"step_{step:08d}-{digest[:12]}.npz")
            tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{step}")
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, final)                # atomic publish
            sp.set("path", os.path.basename(final))
        _events().inc("save")
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        blobs = self._blobs()
        for _, name in blobs[:-self.keep] if self.keep else []:
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    # --------------------------------------------------------------- restore
    def _blobs(self) -> list[tuple[int, str]]:
        """(step, filename) of every checkpoint blob, step-ascending."""
        out = []
        for name in os.listdir(self.dir):
            m = _NAME_RE.fullmatch(name)
            if m:
                out.append((int(m.group("step")), name))
        return sorted(out)

    def all_steps(self) -> list[int]:
        return [s for s, _ in self._blobs()]

    def _load(self, name: str):
        """Load + checksum-verify one blob; ValueError on corruption."""
        path = os.path.join(self.dir, name)
        m = _NAME_RE.fullmatch(name)
        with np.load(path) as blob:
            arrays = {k: blob[k] for k in blob.files}
        meta = json.loads(bytes(arrays["meta"]).decode())
        host = [arrays[f"leaf{i:05d}"] for i in range(meta["n_leaves"])]
        digest = payload_digest(_payload(host, arrays["meta"]))
        if digest[:12] != m.group("digest"):
            raise ValueError(f"checkpoint payload digest mismatch: {path}")
        return host, meta

    def _quarantine(self, name: str) -> None:
        _events().inc("corrupt")
        with _span("checkpoint.quarantine", path=name):
            try:
                os.replace(os.path.join(self.dir, name),
                           os.path.join(self.dir, name + ".corrupt"))
            except OSError:
                pass

    def _unflatten(self, host, meta, like, shardings):
        if like is None:
            raise ValueError("restore requires `like` (a state of the same "
                             "structure) for the tree and devices")
        ref = leaves(like)
        if len(ref) != len(host):
            raise ValueError(f"checkpoint has {len(host)} leaves, `like` "
                             f"{len(ref)}")
        if shardings is not None:
            ctx = sharding.current()
            if ctx is None:
                raise ValueError("restore(shardings=) reshards onto the "
                                 "current mesh: call it under "
                                 "sharding.use(ctx)")
            specs = _spec_leaves(like, shardings)
        else:
            specs = [None] * len(ref)
        with _span("checkpoint.load", step=meta["step"]):
            flat = []
            for a, x, spec in zip(host, ref, specs):
                t = torch.from_numpy(a)
                if spec is not None:
                    flat.append(sharding.place_tensor(t.to(x.dtype), spec,
                                                      ctx.mesh))
                elif isinstance(x, sharding.Sharded):
                    flat.append(sharding.place_tensor(t.to(x.dtype), x.spec,
                                                      x.mesh))
                else:
                    flat.append(t.to(x.device, x.dtype))
        _events().inc("load")
        return unflatten(like, flat), meta["data_state"]

    def restore(self, step: int, like=None, shardings=None):
        """Load one step onto ``like``'s structure, devices and dtypes.
        ``shardings`` (specs of the same structure,
        ``launch.specs.state_shardings``) reshards onto the current
        sharding context's mesh. Raises on a corrupt blob — use
        :meth:`restore_latest` for quarantine-and-fall-back semantics."""
        for s, name in self._blobs():
            if s == step:
                host, meta = self._load(name)
                return self._unflatten(host, meta, like, shardings)
        raise FileNotFoundError(f"no checkpoint for step {step} in "
                                f"{self.dir}")

    def restore_latest(self, like=None, shardings=None):
        """Newest *intact* checkpoint, or ``None`` with an empty dir.
        Corrupt blobs met on the way down are quarantined and skipped."""
        if like is None:
            return None
        for _, name in reversed(self._blobs()):
            try:
                host, meta = self._load(name)
            except Exception:
                self._quarantine(name)
                continue
            return self._unflatten(host, meta, like, shardings)
        return None


def _spec_leaves(like, shardings) -> list:
    """One spec (or ``None``: left where ``like`` has it) for each tensor
    of ``like``, in :func:`~.tree.leaves` order."""
    out = []

    def walk(node, spec):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if spec is None else spec[k])
        elif isinstance(node, list):
            for i, x in enumerate(node):
                walk(x, None if spec is None else spec[i])
        else:
            out.append(spec)

    walk(like, shardings)
    return out


__all__ = ["CheckpointManager"]
