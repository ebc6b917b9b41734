"""Render the dry-run and roofline tables from the records of
``launch.dryrun`` (``experiments/dryrun_torch/*.json``): the port of
``repro.analysis.report``. The tables are the reference's, word for
word: "HLO" names the per-device counts, and "compile s" holds the
trace's seconds."""
from __future__ import annotations

import glob
import json
import os

from .roofline import analyze

_OPT_BF16 = {"command-r-plus-104b", "qwen3-moe-235b-a22b"}


def load_records(dry_dir: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dry_dir, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_bytes(x: float) -> str:
    return f"{x / 1e9:.2f}"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | ok | peak GB/dev | HLO GFLOP/dev | "
        "HLO GB/dev | coll GB/dev | compile s |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | - | **FAIL** "
                         f"| - | - | - | - | - |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | yes | "
            f"{r['memory']['peak_per_device_gb']:.2f} | "
            f"{r['cost']['flops_per_device'] / 1e9:.0f} | "
            f"{_fmt_bytes(r['cost']['bytes_per_device'])} | "
            f"{_fmt_bytes(r['collectives_per_device']['total'])} | "
            f"{r['compile_s']} |")
    return "\n".join(lines)


_FIX_HINTS = {
    "compute": "raise arithmetic intensity (bigger per-chip batch, fuse "
               "elementwise chains into the matmuls)",
    "memory": "cut HBM traffic: tighter remat policy, bf16 master/offload, "
              "fuse gather+hadamard (keep partials in VMEM)",
    "collective": "reshard to cut cross-chip bytes: cast-before-gather "
                  "params, reduce-scatter grads, overlap a2a with expert "
                  "compute",
}


def roofline_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | "
        "dominant | MODEL_TF | useful ratio | roofline frac | "
        "what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if not r.get("ok") or r.get("mesh") != "16x16":
            continue
        rf = analyze(r, opt_bf16=r["arch"] in _OPT_BF16)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf.t_compute:.4f} | "
            f"{rf.t_memory:.4f} | {rf.t_collective:.4f} | {rf.dominant} | "
            f"{rf.model_flops_total / 1e12:.1f} | {rf.useful_ratio:.3f} | "
            f"{rf.roofline_fraction:.3f} | "
            f"{_FIX_HINTS[rf.dominant]} |")
    return "\n".join(lines)


def hillclimb_table(dry_dir: str, hc_dir: str) -> str:
    """Render §Perf Phase-2: baseline vs optimized per hillclimb cell."""
    import collections

    base = {}
    for r in load_records(dry_dir):
        if r.get("ok") and r.get("mesh") == "16x16":
            base[(r["arch"], r["shape"])] = r
    rows = ["| cell | change | peak GB/dev | t_compute | t_memory | "
            "t_collective | dominant | roofline frac | verdict |",
            "|---|---|---|---|---|---|---|---|---|"]
    recs = collections.defaultdict(list)
    for r in load_records(hc_dir):
        if r.get("ok"):
            recs[(r["arch"], r["shape"])].append(r)

    def fmt(r, label, ref=None):
        rf = analyze(r, opt_bf16=r["arch"] in _OPT_BF16)
        frac = rf.roofline_fraction
        verdict = ""
        if ref is not None:
            rfb = analyze(ref, opt_bf16=ref["arch"] in _OPT_BF16)
            d = {"compute": rf.t_compute / max(rfb.t_compute, 1e-12),
                 "memory": rf.t_memory / max(rfb.t_memory, 1e-12),
                 "collective":
                 rf.t_collective / max(rfb.t_collective, 1e-12)}
            verdict = (f"dom term x{d[rfb.dominant]:.2f}; "
                       f"frac {rfb.roofline_fraction:.3f}->{frac:.3f}")
        return (f"| {r['arch']} x {r['shape']} | {label} | "
                f"{r['memory']['peak_per_device_gb']:.2f} | "
                f"{rf.t_compute:.4f} | {rf.t_memory:.4f} | "
                f"{rf.t_collective:.4f} | {rf.dominant} | {frac:.3f} | "
                f"{verdict} |")

    for key, hcs in sorted(recs.items()):
        b = base.get(key)
        if b is not None:
            rows.append(fmt(b, "baseline (paper-faithful framework)"))
        for r in sorted(hcs, key=lambda x: x.get("opt_tag", "")):
            rows.append(fmt(r, r.get("opt_tag", "?"), ref=b))
    return "\n".join(rows)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dry-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "dryrun_torch"))
    args = ap.parse_args()
    recs = load_records(args.dry_dir)
    print("## Dry-run\n")
    print(dryrun_table(recs))
    print("\n## Roofline\n")
    print(roofline_table(recs))
    hc_dir = os.path.join(args.dry_dir, "..", "hillclimb_torch")
    if os.path.isdir(hc_dir):
        print("\n## Perf hillclimbs\n")
        print(hillclimb_table(args.dry_dir, hc_dir))


if __name__ == "__main__":
    main()
