"""The CPD-ALS fold's parts on one card, at the factor shapes of
``chip_smoke.py``'s nell1 tensor (scale 0.1: dims 290,000 x 210,000 x
2,550,000, rank 32), float32 with TF32 off as ``cp_als`` runs them.

For each mode d: the Gram products of the other two factors
(``core.cpd.gram``, a 32 x I by I x 32 product each), the update
(``core.cpd._als_update``: their Hadamard product, the ridge, the
32 x 32 solve with I_d right-hand sides through ``solve_ex``, the column
norms and the normalisation), and the whole fold (``_als_fold``), each
the CUDA-event ms (median of ``REPS`` after a warm-up), eagerly and as a
replayed CUDA graph of the fold. Random uniform factors and MTTKRP
outputs of those shapes stand in for the sweep's (the fold's cost does
not depend on their values).

    python3 experiments/torch_als_fold_split.py

Prints the card's name and power limit and a line a mode; writes the
record to ``chiprun_out/torch_als_fold_split.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DIMS = (290_000, 210_000, 2_550_000)
RANK = 32
REPS = 5


def median_ms(fn):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch
    from repro_torch.core import cpd

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    cpd._full_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    g = torch.Generator(device="cuda").manual_seed(0)
    factors = tuple(torch.rand((d, RANK), generator=g, device="cuda")
                    for d in DIMS)
    outs = [torch.rand((d, RANK), generator=g, device="cuda") for d in DIMS]
    lam = torch.ones(RANK, device="cuda")
    rec = {"device": smi, "dims": DIMS, "rank": RANK, "modes": []}
    for d in range(len(DIMS)):
        others = [w for w in range(len(DIMS)) if w != d]
        grams = tuple(cpd.gram(factors[w]) for w in others)
        row = {
            "mode": d,
            "gram_ms": [median_ms(lambda w=w: cpd.gram(factors[w]))
                        for w in others],
            "update_ms": median_ms(lambda: cpd._als_update(outs[d], grams)),
            "fold_ms": median_ms(lambda: cpd._als_fold(d, outs[d], factors,
                                                       lam)),
        }
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            cpd._als_fold(d, outs[d], factors, lam)
        row["fold_graph_ms"] = median_ms(graph.replay)
        del graph
        rec["modes"].append(row)
        print(f"mode {d} (I {DIMS[d]:,}): grams "
              + ", ".join(f"{t:.3f}" for t in row["gram_ms"])
              + f" ms; update {row['update_ms']:.3f} ms; fold "
              f"{row['fold_ms']:.3f} ms eager, {row['fold_graph_ms']:.3f} "
              "ms replayed")
    rec["fold_ms_a_sweep"] = sum(r["fold_ms"] for r in rec["modes"])
    print(f"the fold over a sweep: {rec['fold_ms_a_sweep']:.3f} ms eager")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_als_fold_split.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
