"""Device meshes for the distributed tier (the port of
``repro.launch.mesh``).

A :class:`Mesh` is an ndarray of ``torch.device`` with named axes, as a
``jax.sharding.Mesh`` is one of jax devices. One process drives every
shard of it, as the reference's ``shard_map`` does, and each shard's
tensors live on its device (``repro_torch.engine.dist``).

:func:`make_mesh` takes distinct visible cards and raises when there are
too few. Several shards share a card only when the caller says so
(``devices=["cuda:0"] * 4``); the tests pass ``devices=["cpu"] * 4``, the
counterpart of the reference's forced host-device count.
:func:`make_production_mesh` is the reference's production layout, (data
16, model 16) on 256 cards or (pod 2, data 16, model 16) on 512; the
tests build it on ``devices=["cpu"] * 256``. ``repro_torch.sharding``
puts a sharding context over a mesh.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


class Mesh:
    """An ndarray of ``torch.device`` with one name an axis.

    ``devices`` keeps the given shape (a flat list is reshaped to
    ``len(axis_names)`` axes only by :func:`make_mesh`); ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices.ravel()))

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.ravel())
        return f"Mesh({self.shape}, [{devs}])"


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``. ``devices`` (a flat
    list of ``torch.device`` or names, one per mesh position) defaults to
    the first ``prod(shape)`` visible cards, which must all exist: a mesh
    never doubles shards up on a card unless ``devices`` says so."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} cards, torch sees {have}; pass "
                "devices= to place several shards on one device")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a {shape} mesh takes {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16). Raises, as
    :func:`make_mesh` does, when fewer cards are visible and no
    ``devices=`` is given."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


__all__ = ["Mesh", "make_mesh", "make_production_mesh"]
