"""``chip_smoke.py`` [14a] alone, for a machine with several cards: nell1
scale 0.1 (R 32) planned by ``build_sharded_flycoo(n_dev=4)``, sharded 4
ways on ``cuda:0`` and checked and timed as in the full script, then, as
[14a] does wherever torch sees 2 or more cards, sharded a shard a card
(4 cards, or 2) and checked against the oracle, the single-device
rotation and the schedule's bytes, its rotation timed. [14b] needs
[3]'s single-device fits and float64 witness: they are computed here the
way [3] computes them (3 ``cp_als`` sweeps on ``cuda_fused`` and
``cp_als_reference`` in float64 from the same factors).

    python3 experiments/torch_dist_cards.py      # on a host with 4 cards

Prints [14a], [14b] and [14d]'s lines and a JSON record of the multi-card
check.
"""
from __future__ import annotations

import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.core import (build_flycoo, cp_als, cp_als_reference,
                                  init_factors, spec, synthesize)
    from repro_torch.engine import ExecutionConfig
    from repro_torch.kernels import mttkrp as kmt

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, smi = c.phase_card()
    print(smi, "cards", torch.cuda.device_count(), flush=True)
    ts = spec("nell1", scale=0.1)
    indices, values = synthesize(ts, seed=0)
    t = types.SimpleNamespace(indices=indices, values=values, dims=ts.dims)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           ts.dims, c.RANK)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=c.RANK)
    n = len(ts.dims)
    single = build_flycoo(indices, values, ts.dims,
                          kappa=[cfg.kappa_for(x, n) for x in ts.dims])
    fits = cp_als(single, c.RANK, iters=3, config=cfg, factors=factors).fits
    f64 = cp_als_reference(indices, values, ts.dims, c.RANK, iters=3,
                           factors=factors, device="cuda",
                           dtype=torch.float64).fits
    del single
    report = {"nell1": {"fits": fits, "fit_witness": [{"f64_fits": f64}]}}
    c.phase_dist_nell1(kmt, t, factors, report["nell1"], report, 5)
    print(json.dumps(report["dist_nell1"]["cards"]), flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
