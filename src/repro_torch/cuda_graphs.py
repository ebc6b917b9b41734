"""Capturing a CUDA graph without ``torch.cuda.graph``'s pinned-host flush.

``torch.cuda.graph`` empties the allocator's device cache and its pinned
host cache before every capture. The port captures one graph per serving
engine and one per rotation key, many in one process beside the
streaming tier's pinned buffers, which would be freed and pinned again
each time. :func:`capture` empties the device cache alone (a dead graph's
pool stays reserved until then, and a new pool could not find room),
then records the work on one side stream per device (the same stream
every capture, so cuBLAS keeps one workspace for it) into the graph's own
pool, in the global capture mode, which refuses a sync or an unsafe call
from any thread.
"""
from __future__ import annotations

import contextlib

import torch

_STREAMS: dict = {}


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device):
    """Record the CUDA work of the ``with`` body on ``device`` into
    ``graph``; a failed capture raises."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    torch.cuda.empty_cache()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="global")
        try:
            yield
        finally:
            graph.capture_end()


__all__ = ["capture"]
