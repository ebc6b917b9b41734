"""Three-term roofline from dry-run records (NVIDIA H100 SXM targets).

    compute term    = FLOPs_per_device / peak_flops
    memory term     = bytes_per_device / hbm_bw
    collective term = collective_bytes_per_device / link_bw

The reference's scan correction (``cost_analysis`` counts a while-body
once, so variant compiles give each cycle's cost) is kept in
:func:`corrected_costs` for the records' contract, but the port's counts
need none: every layer is a Python call that the dispatch mode
(``analysis.cost``) sees, so a full trace already counts each layer, and
``nonloop + sum_s rep_s * (variant_s - nonloop)`` equals it (FLOPs
exactly). For bytes the body correction still subtracts the cycle's
optimizer traffic and charges the stacked params' once, as the
reference does.

Roofline fraction = MODEL_FLOPS-ideal time / max(term):
    MODEL_FLOPS = 6*N_active*tokens (train) or 2*N_active*tokens (inference)
"""
from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM5 (80 GB, 700 W) datasheet figures, per card.
HW = {
    # dense BF16 tensor-core peak (1,979 TFLOP/s is with 2:4 sparsity)
    "peak_flops": 989e12,
    "hbm_bw": 3.35e12,       # HBM3, B/s
    # The slowest hop a 16-way mesh axis crosses: 16 cards span two
    # 8-card HGX H100 nodes, and a ring between them goes through each
    # card's own 400 Gb/s NDR InfiniBand NIC (ConnectX-7, one a card):
    # 50 GB/s each way.
    "link_bw": 50e9,
}
#: NVLink 4 within one 8-card node: 900 GB/s a card, 450 GB/s each way
#: (the ``link_bw`` of a mesh axis that stays inside a node).
NVLINK_BW = 450e9

_ADAM_RW_F32 = 28   # g+m+v+p reads, m+v+p writes (4B each)
_ADAM_RW_BF16 = 20  # bf16 moments


@dataclasses.dataclass
class Roofline:
    flops: float            # corrected, per device
    bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_total: float
    useful_ratio: float     # MODEL_FLOPS / (corrected flops * chips)
    roofline_fraction: float
    est_step_s: float

    def as_dict(self):
        return dataclasses.asdict(self)


def _tokens(rec) -> float:
    from ..configs import SHAPES

    shape = SHAPES[rec["shape"]]
    if rec["step"] == "decode":
        return shape.global_batch  # one new token per sequence
    return shape.global_batch * shape.seq_len


def model_flops(rec) -> float:
    n = rec["active_params"]
    toks = _tokens(rec)
    mult = 6.0 if rec["step"] == "train" else 2.0
    return mult * n * toks


def corrected_costs(rec, opt_bf16: bool = False) -> tuple[float, float, float]:
    """(flops, bytes, collective bytes) per device, scan-corrected.

    With variants present, costs come from the variants alone:
        nonloop + sum_s rep_s * (variant_s - nonloop [- opt traffic])
    The optimizer's stacked-param traffic is charged once, analytically.
    """
    variants = rec.get("variants")
    if not variants or "nonloop" not in variants:
        return (rec["cost"]["flops_per_device"],
                rec["cost"]["bytes_per_device"],
                rec["collectives_per_device"]["total"])
    nl = variants["nonloop"]
    rw = _ADAM_RW_BF16 if opt_bf16 else _ADAM_RW_F32
    n_dev = rec["n_devices"]
    f = nl["flops_per_device"]
    b = nl["bytes_per_device"]
    c = nl["collectives_per_device"]["total"]
    for tag, v in variants.items():
        if tag == "nonloop" or v["rep"] < 1:
            continue
        body_f = max(v["flops_per_device"] - nl["flops_per_device"], 0.0)
        body_b = v["bytes_per_device"] - nl["bytes_per_device"]
        body_c = (v["collectives_per_device"]["total"]
                  - nl["collectives_per_device"]["total"])
        body_params = max(v.get("params", 0) - nl.get("params", 0), 0)
        if rec["step"] == "train" and body_params:
            # remove the cycle's optimizer traffic from the body, then
            # charge the full stacked-param traffic once at the end
            body_b -= body_params * rw / n_dev
        body_b = max(body_b, 0.0)
        body_c = max(body_c, 0.0)
        f += v["rep"] * body_f
        b += v["rep"] * body_b
        c += v["rep"] * body_c
    if rec["step"] == "train":
        b += rec["params"] * rw / n_dev  # stacked-param optimizer traffic
    return f, b, c


def analyze(rec, hw=HW, opt_bf16: bool = False) -> Roofline:
    f, b, c = corrected_costs(rec, opt_bf16=opt_bf16)
    t_comp = f / hw["peak_flops"]
    t_mem = b / hw["hbm_bw"]
    t_coll = c / hw["link_bw"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec)
    n_dev = rec["n_devices"]
    est = max(terms.values())
    ideal = mf / (n_dev * hw["peak_flops"])
    return Roofline(
        flops=f, bytes=b, coll_bytes=c,
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        dominant=dominant,
        model_flops_total=mf,
        useful_ratio=mf / max(f * n_dev, 1.0),
        roofline_fraction=ideal / max(est, 1e-12),
        est_step_s=est,
    )


__all__ = ["HW", "NVLINK_BW", "Roofline", "analyze", "corrected_costs",
           "model_flops"]
