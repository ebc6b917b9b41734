"""The COO oracle for spMTTKRP (port of ``repro.core.mttkrp.mttkrp_ref``)."""
from __future__ import annotations

import torch


def mttkrp_ref(indices, values, factors, mode: int, dim: int):
    """out[i_d, r] = sum_nnz val * prod_{w != d} F_w[i_w, r], in canonical
    COO order with no FLYCOO machinery (``index_select`` + ``index_add_``)."""
    partials = values[:, None].to(torch.float32)
    for w, f in enumerate(factors):
        if w == mode:
            continue
        partials = partials * f.index_select(0, indices[:, w])
    out = torch.zeros((dim, partials.shape[1]), dtype=partials.dtype,
                      device=partials.device)
    return out.index_add_(0, indices[:, mode], partials)
