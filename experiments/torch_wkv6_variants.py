"""The ``wkv6`` kernel's launch shape, measured on one CUDA card: the
kernel as it is against variants of its own source, each at the
``rwkv6-3b`` prefill's shape (BH 160, T 4096, K = V = 64).

  base            ``src/repro_torch/kernels/csrc/wkv6.cu`` as it is
  G4, G16         K cut into 4 or 16 slices (``kGroups``): 1 or 4 warps
                  a CTA instead of 2
  VT8, VT32       8 or 32 columns of V a CTA (``kTile``): 1 or 4
                  columns a lane instead of 2
  G16 VT32        both
  chunk32         32 steps staged a buffer (``kChunk``)
  G4 direct-y     G4 (one warp, so no warps' sum) with y written by the
                  lanes, 8 bytes a store, instead of staged in shared
                  memory and written in 16-byte stores
  adjacent-lanes  probe: the slices dealt to adjacent lanes instead of to
                  quarter-warps, so a quarter's float4 reads of r, k, w
                  hit 4 addresses; times the loads only, its result is
                  wrong
  no-load, no-bonus, no-store-y, no-reduce, no-fold, steps-only
                  probes: the kernel without chunk c + 2's loads (the
                  steps read stale rows), the bonus, the y stores, the
                  reduce-scatter's shuffles, warp 0's b_t v_t, or all of
                  these; each times what is left, its result is wrong
  clock           probe: thread 0 of each CTA writes its clock64 cycles,
                  %globaltimer nanoseconds and SM into y; the script
                  prints the SM clock and the CTAs' times on SMs holding
                  4 and 5 CTAs

The variants are made by replacing exact lines of the source (the launch
shape's constants, the partial-sum write and the two tile stores, the
quarter's slice): the script is tied to the source revision it ships with
and stops with an error when a line it replaces is gone. Every variant
but the probe computes the same function and is held against the plain
version within ``chip_smoke.wkv_limit`` before it is timed. Each time is
the mean of ``--reps`` launches by CUDA events after a warm-up, on random
inputs (``chip_smoke.wkv_case``: the kernel's time does not depend on the
values); ``base`` is timed first and last, to show the drift.

    python3 experiments/torch_wkv6_variants.py [--reps 20]

Prints one line per variant (with registers and spills of its K = V = 64
instantiation, from ``-Xptxas -v``) and a JSON record (also written to
``chiprun_out/wkv6_variants.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPE = (160, 4096, 64, 64)      # rwkv6-3b prefill, B 4 x 40 heads
Y_WRITE = "        part[s * VT + col + (base + h) % JS] = wp == 0 ? bv[h] + val[h]\n"
Y_DIRECT = ("        yb[static_cast<long long>(c * kChunk + s) * V + col +"
            " (base + h) % JS] = wp == 0 ? bv[h] + val[h]\n")
STORES = ("    store_y(c - 1, c > 0 ? kChunk : 0);\n",
          "  store_y(nchunks - 1, T - (nchunks - 1) * kChunk);\n")
QUARTER = "  const int qt = (tid / 8) % Q;\n"
ABLATIONS = {
    "no-load": ("    load(min(c + 2, nchunks - 1), (c + 2) % 3);\n", ""),
    "no-bonus": ("    bonus(min(c + 1, nchunks - 1), (c + 1) & 1);\n", ""),
    "no-store-y": ("    store_y(c - 1, c > 0 ? kChunk : 0);\n", ""),
    "no-reduce": ("const float recv = __shfl_xor_sync(Sh::kMask, send, off);",
                  "const float recv = send * 0.5f;"),
    "no-fold": ("wp == 0 ? bv[h] + val[h]", "false ? bv[h] + val[h]"),
}
CLOCK_START = "  const int nchunks = (T + kChunk - 1) / kChunk;\n"
CLOCK_END = "  store_y(nchunks - 1, T - (nchunks - 1) * kChunk);\n}\n"
PROBES = ("adjacent-lanes", *ABLATIONS, "steps-only", "clock")


def _const(src: str, name: str, value: int) -> str:
    """``src`` with the line of constant ``name`` set to ``value``."""
    pat = re.compile(rf"^constexpr int {name} = \d+;", re.M)
    if len(pat.findall(src)) != 1:
        raise RuntimeError(f"wkv6.cu no longer has one line `constexpr int "
                           f"{name} = ...;`")
    return pat.sub(f"constexpr int {name} = {value};", src)


def variant_sources(src: str) -> dict[str, str]:
    """The source texts of the variants (see the module docstring)."""
    def consts(**kv):
        out = src
        for name, value in kv.items():
            out = _const(out, name, value)
        return out

    lines = (Y_WRITE, QUARTER, *STORES, CLOCK_START, CLOCK_END,
             *(old for old, _ in ABLATIONS.values()))
    if any(line not in src for line in lines):
        raise RuntimeError("wkv6.cu no longer has the lines the direct-y "
                           "and probe variants replace")
    direct = consts(kGroups=4).replace(Y_WRITE, Y_DIRECT)
    for line in STORES:
        direct = direct.replace(line, "")
    steps_only = src
    for old, new in ABLATIONS.values():
        steps_only = steps_only.replace(old, new)
    clock = src.replace(CLOCK_START, CLOCK_START + """\
  const long long c0 = clock64();
  unsigned long long g0, g1;
  unsigned sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
""").replace(CLOCK_END, CLOCK_END[:-2] + """\
  __syncthreads();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if (tid == 0)
    yb[0] = float(clock64() - c0), yb[1] = float(g1 - g0), yb[2] = float(sm);
}
""")
    return {"base": src, "G4": consts(kGroups=4), "G16": consts(kGroups=16),
            "VT8": consts(kTile=8), "VT32": consts(kTile=32),
            "G16 VT32": consts(kGroups=16, kTile=32),
            "chunk32": consts(kChunk=32), "G4 direct-y": direct,
            "adjacent-lanes": src.replace(QUARTER,
                                          "  const int qt = tid % Q;\n"),
            **{name: src.replace(old, new)
               for name, (old, new) in ABLATIONS.items()},
            "steps-only": steps_only, "clock": clock}


def clock_report(y, vt):
    """SM clock and CTA times from the clock probe's output ``y``: one
    (cycles, ns, SM) triple at the first row of each CTA's tile."""
    import torch

    rec = y[:, 0, :].reshape(y.shape[0], -1, vt)[:, :, :3].reshape(-1, 3)
    cycles, ns, sm = rec.double().cpu().T
    per_sm = torch.bincount(sm.long())[sm.long()]
    out = {"clock_mhz": float((cycles / ns).median() * 1e3),
           "cta_us": {}}
    for held in sorted(set(per_sm.tolist())):
        sel = per_sm == held
        out["cta_us"][int(held)] = {
            "ctas": int(sel.sum()), "median": float(ns[sel].median() / 1e3),
            "max": float(ns[sel].max() / 1e3)}
    return out


def ptxas_summary(log: str, k: int, v: int, vt: int, g: int):
    """(registers, spill stores, spill loads) of one instantiation."""
    tag = f"wkv6_kernelILi{k}ELi{min(v, vt)}ELi{min(g, k // 4)}EE"
    m = re.search(re.escape(tag) + r".*?(\d+) bytes spill stores, (\d+) "
                  r"bytes spill loads.*?Used (\d+) registers", log, re.S)
    return None if m is None else (int(m[3]), int(m[1]), int(m[2]))


def build_variants(out_dir: Path) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every variant with the port's flags, all at once."""
    from repro_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "wkv6.cu").read_text()
    procs = {}
    for name, text in variant_sources(src).items():
        stem = name.replace(" ", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{stem}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES["wkv6"].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, log)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import close_to, cuda_ms, wkv_bound, wkv_case, wkv_limit
    from repro_torch.kernels import build
    from repro_torch.kernels import wkv6 as kw6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_variants(build.BUILD_DIR / "wkv6_variants")
    inputs = wkv_case(*SHAPE, seed=0)
    want = kw6.wkv6_plain(*inputs)
    lim = wkv_limit(kw6, inputs)
    nbytes, flops = wkv_bound(inputs)
    bound_ms = 1e3 * max(nbytes / 3.35e12, flops / 67e12)
    print(f"(BH, T, K, V) = {SHAPE}: bound {bound_ms:.4f} ms", flush=True)
    src = (build.CSRC / "wkv6.cu").read_text()
    base = {c: int(re.search(rf"constexpr int {c} = (\d+);", src)[1])
            for c in ("kGroups", "kTile")}
    rows, clocks = [], None
    try:
        for name in [*libs, "base"]:
            lib, log = libs[name]
            build._LIBS["wkv6"] = lib
            err, share = (None, None) if name in PROBES else close_to(
                f"{name} wkv6", kw6.wkv6(*inputs), want, lim)
            ms = cuda_ms(lambda: kw6.wkv6(*inputs), args.reps)
            text = (build.BUILD_DIR / "wkv6_variants"
                    / f"{name.replace(' ', '_')}.cu").read_text()
            shape = {c: int(re.search(rf"constexpr int {c} = (\d+);",
                                      text)[1]) for c in base}
            regs = ptxas_summary(log, 64, 64, shape["kTile"],
                                 shape["kGroups"])
            if name == "clock":
                clocks = clock_report(kw6.wkv6(*inputs), shape["kTile"])
                print(f"clock probe: {clocks}", flush=True)
            rows.append({"variant": name, "ms": ms, "max_abs_err": err,
                         "share_of_limit": share,
                         "registers_spill_stores_loads": regs})
            check = ("timing only" if err is None else
                     f"max err {err:.2e}, {share:.3f} of the limit")
            print(f"{name:14s} {ms:.4f} ms a launch ({ms / bound_ms:.2f}x "
                  f"the bound; {check}; registers, spill stores, spill "
                  f"loads {regs})", flush=True)
    finally:
        build._LIBS.pop("wkv6", None)
    rec = {"device": smi, "shape": SHAPE, "reps": args.reps,
           "bound_ms": bound_ms, "rows": rows, "clock_probe": clocks}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wkv6_variants.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
