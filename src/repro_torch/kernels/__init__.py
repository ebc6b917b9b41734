"""Hand-written Hopper kernels of the port and their wrappers.

``csrc/`` holds the CUDA C++ sources, :mod:`.build` compiles them with
``nvcc`` at first CUDA use, and :mod:`.mttkrp` (spMTTKRP), :mod:`.wkv6`
(RWKV-6) and :mod:`.lru_scan` (RG-LRU) hold the wrappers, their plain
PyTorch versions and the launch counters. Importing this package needs
neither ``nvcc`` nor a card.

On the ``meta`` device (a shape-only trace, ``analysis.cost``) a wrapper
launches nothing: it makes its outputs' shapes and calls :func:`charge`
with the bytes and operations of its kernel's own work, the formula kept
beside the kernel (``wkv6.wkv6_cost``, ``lru_scan.lru_scan_cost``, ...),
which the bounds of ``chip_smoke.py`` read too.
"""
_LISTENERS: list = []


def listen(listener) -> None:
    """From now on ``listener(name, nbytes, flops)`` hears every kernel
    that a wrapper runs on the ``meta`` device (:func:`unlisten` ends
    it)."""
    _LISTENERS.append(listener)


def unlisten(listener) -> None:
    _LISTENERS.remove(listener)


def charge(name: str, nbytes: int, flops: int) -> None:
    """A kernel's work on the ``meta`` device: ``nbytes`` moved (each
    input read once, each output written once) and ``flops`` done."""
    for fn in list(_LISTENERS):
        fn(name, nbytes, flops)
