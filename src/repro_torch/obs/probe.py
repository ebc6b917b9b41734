"""Peak-memory probes: the host's resident-set high-water mark and the
card's allocator high-water mark (the port of ``repro.obs.probe``).

``StreamStats.as_row()`` records the device peak beside the streaming
ring's modeled bytes, so a residency regression shows as a measured
number, not only as drift of the model.
"""
from __future__ import annotations

import resource
import sys

import torch

__all__ = ["memory_probe", "device_peak_bytes"]


def memory_probe() -> dict:
    """``host_peak_rss_bytes`` (the process high-water mark; Linux reports
    ``ru_maxrss`` in KiB) and ``device_peak_bytes``
    (:func:`device_peak_bytes`)."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    scale = 1024 if sys.platform.startswith("linux") else 1
    return {"host_peak_rss_bytes": int(peak) * scale,
            "device_peak_bytes": device_peak_bytes()}


def device_peak_bytes() -> int | None:
    """The current card's ``torch.cuda.max_memory_allocated`` (bytes of
    tensors the caching allocator handed out at most since the last
    ``reset_peak_memory_stats``), or ``None`` where torch sees no card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated())
