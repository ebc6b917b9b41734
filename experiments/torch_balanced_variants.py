"""Where the balanced spMTTKRP kernel's main pass spends its time, on one
CUDA card: the kernel against two variants of its own source that each
skip one part of the work.

  base        ``src/repro_torch/kernels/csrc/mttkrp_balanced.cu`` as it is
  no-compute  the slot loop skipped (``warp_runs`` over rank 0: metadata
              and factor-row copies, barriers and the tile write-out
              only)
  no-rows     the factor-row copies skipped (the slot loop reads stale
              stage rows)

The variants are made by replacing two exact lines of the source (the
slot loop's head and ``load_rows``'s): the script is tied to the source
revision it ships with and stops with an error when a line it replaces
is gone. Neither variant computes the right result; they are for timing.
Each time is the main pass of ``mttkrp_fused_gather_compact`` on one
mode of the main path's tensor (nell1, scale 0.1, R 32, ``cuda_fused``
compact), the mean of ``--reps`` launches by CUDA events after a
warm-up.

    python3 experiments/torch_balanced_variants.py [--reps 10]

Prints one line per variant and mode, and a JSON record (also written to
``chiprun_out/balanced_variants.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RANK = 32
SLOT_LOOP = "warp_runs(acc, lrow, val, i0, i1, r, lane, [&](int s, int col) {"


def variant_sources(src: str) -> dict[str, str]:
    """The source texts of the variants (see the module docstring)."""
    m = re.search(r"void load_rows\([^)]*\) \{\n", src)
    if SLOT_LOOP not in src or m is None:
        raise RuntimeError("mttkrp_balanced.cu no longer has the lines the "
                           "variants replace")
    return {"base": src,
            "no-compute": src.replace(SLOT_LOOP, SLOT_LOOP.replace(
                "i1, r,", "i1, 0,")),
            "no-rows": src[:m.end()] + "  return;\n" + src[m.end():]}


def build_variants(out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant with the port's flags, all at once."""
    from repro_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "mttkrp_balanced.cu").read_text()
    procs = {}
    for name, text in variant_sources(src).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in \
                build.SIGNATURES["mttkrp_balanced"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.core import build_flycoo, init_factors, spec, synthesize
    from repro_torch.engine import ExecutionConfig
    from repro_torch.engine.api import mode_layout
    from repro_torch.kernels import build
    from repro_torch.kernels import mttkrp as kmt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(build.BUILD_DIR / "variants")
    t0 = time.perf_counter()
    ts = spec("nell1", scale=0.1)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    state = engine.init(t, cfg)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    print(f"nell1 0.1: nnz {t.nnz}, setup {time.perf_counter() - t0:.1f} s",
          flush=True)
    rows = []
    try:
        for _ in range(n):
            d = state.mode
            plan = state.statics[d]
            L = mode_layout(state, (state.val, state.idx, state.alpha), d)
            inputs = tuple(f for w, f in enumerate(factors) if w != d)
            row = {"mode": d, "nblocks": plan.nblocks,
                   "rows_pp": plan.rows_pp,
                   "chunks": int(L["work"].shape[0])}
            for name, lib in libs.items():
                build._LIBS["mttkrp_balanced"] = lib
                _, main_pass, _ = kmt.balanced_passes(
                    L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"],
                    L["nuniq"], inputs, kappa=plan.kappa,
                    rows_pp=plan.rows_pp, nblocks=plan.nblocks,
                    block_p=plan.block_p,
                    work=kmt.WorkTable(L["work"], L["wsum"]))
                row[name] = ms = cuda_ms(main_pass, args.reps)
                us = 1e3 * ms * kmt.H100_SMS / plan.nblocks
                print(f"mode {d} {name:10s} {ms:.3f} ms main pass "
                      f"({us:.2f} us a block an SM)", flush=True)
            rows.append(row)
            _, state = engine.mttkrp(state, factors)
    finally:
        build._LIBS.pop("mttkrp_balanced", None)
    rec = {"device": smi, "reps": args.reps, "rows": rows}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "balanced_variants.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
