"""What the distributed tier's remap exchange costs where its scatters
park the rows they do not send, on one CUDA card.

PyTorch's scatter (``index_copy_``) has no "drop" mode, so each scatter
of ``engine.dist``'s exchange sends the rows it skips to parking rows
past its buffer: ``PARK_ROWS = 1`` puts all of them on one row (millions
of stores to one address), the module's default spreads row ``i`` over
``i % PARK_ROWS``. The script shards ``chip_smoke.py`` [14a]'s tensor
(nell1, scale 0.1, R 32, ``build_sharded_flycoo(n_dev=4)``, ``cuda_fused``
compact) 4 ways on ``cuda:0`` and times, for each setting in turn
(1, default, 1, default), each transition's ``permute`` and
``all_gather`` exchange and one ``dist_all_modes`` rotation (CUDA
events, median of ``--reps`` after a warm-up), checking that every
setting leaves the same layouts. Four shards on one card: not a
multi-GPU speed.

    python3 experiments/torch_dist_exchange.py [--reps 5]

Prints the card's name and power limit, one line per setting and a JSON
record (also written to ``chiprun_out/dist_exchange.json``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RANK = 32


def median_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.core import (build_sharded_flycoo, init_factors, spec,
                                  synthesize)
    from repro_torch.engine import ExecutionConfig, dist
    from repro_torch.launch.mesh import make_mesh

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ts = spec("nell1", scale=0.1)
    indices, values = synthesize(ts, seed=0)
    t = build_sharded_flycoo(indices, values, ts.dims, n_dev=4)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                           rank_hint=RANK))
    ds = dist.shard_state(state, make_mesh((4,), ("data",),
                                           devices=["cuda:0"] * 4))
    n, n_dev = ds.nmodes, ds.n_dev
    # each mode's shard inputs, as the rotation hands them to the exchange
    inputs, cur = [], ds
    for _ in range(n):
        d = cur.mode
        parts = [dist.shard_layout(cur, k, d) for k in range(n_dev)]
        inputs.append((d, [(L["val"], L["idx"], L["alpha"])
                           for L, _ in parts], [a for _, a in parts]))
        _, cur = dist.dist_mttkrp(cur, factors)
    default = dist.PARK_ROWS
    rows, layouts = [], {}
    for park in (1, default, 1, default):
        dist.PARK_ROWS = park
        row = {"park_rows": park, "permute_ms": [], "all_gather_ms": []}
        for d, local, alive in inputs:
            kw = dict(d=d, nxt=(d + 1) % n, smax_loc=ds.smax_loc,
                      n_dev=n_dev, nmodes=n, devices=ds.devices)
            row["permute_ms"].append(median_ms(
                lambda: dist._exchange_permute(
                    local, alive, hops=ds.schedule.hops[d], **kw),
                args.reps))
            row["all_gather_ms"].append(median_ms(
                lambda: dist._exchange_all_gather(local, alive, **kw),
                args.reps))
        row["rotation_ms"] = median_ms(
            lambda: dist.dist_all_modes(ds, factors), args.reps)
        _, one = dist.dist_mttkrp(ds, factors)
        lay = one.host_layout()
        if park in layouts:
            ok = all(np.array_equal(a, b) for a, b in zip(lay, layouts[park]))
        else:
            layouts[park] = lay
            ok = all(np.array_equal(a, b) for a, b in zip(
                lay, layouts.get(1, lay)))
        if not ok:
            raise AssertionError(f"PARK_ROWS={park} left another layout")
        rows.append(row)
        print(f"PARK_ROWS {park}: exchange a transition permute "
              + ", ".join(f"{x:.3f}" for x in row["permute_ms"])
              + " ms, all_gather "
              + ", ".join(f"{x:.3f}" for x in row["all_gather_ms"])
              + f" ms; rotation {row['rotation_ms']:.3f} ms", flush=True)
    dist.PARK_ROWS = default
    out = {"device": smi, "slocs": list(ds.slocs), "rows": rows}
    path = ROOT / "chiprun_out"
    path.mkdir(exist_ok=True)
    (path / "dist_exchange.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
