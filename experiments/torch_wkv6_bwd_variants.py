"""The ``wkv6_bwd`` kernel against its column-tiled predecessor and against
variants of its own launch shape, measured on one CUDA card at the
``rwkv6-3b`` prefill's shape (BH 160, T 4096, K = V = 64) and at a training
step's (B 2 x 40 heads: BH 80).

  columns       ``experiments/wkv6_bwd_columns.cu``: the earlier design,
                one CTA of 256 threads a (bh, 16-column tile), 4 rows a
                thread, the row sums through a 3 x 4 x BH x T x 64 float
                buffer and a second kernel
  base          ``src/repro_torch/kernels/csrc/wkv6_bwd.cu`` as it is: 2
                rows x 4 columns of S a lane, 4 warps (16 rows) a CTA, a
                cluster of 4 CTAs a bh, 16 steps a chunk, 8 a sub-chunk
  W2, W8        2 or 8 warps a CTA (``kWarps``): 8 or 32 rows of S a CTA,
                clusters of 8 or 2 CTAs a bh instead of 4
  R4 W1, R4 W2, R4 W4
                4 rows of S a lane (``kLaneRows``), so half the warps a
                bh, with 1, 2 or 4 warps a CTA (8, 16 or 32 rows)
  C8, C32       8 or 32 steps between saved states (``kChunk``)
  R4 S4, R4 C32 S4
                R4 W2 with 4 steps of states in registers (``kSub``)
                instead of 8, and with 32-step chunks too (2 rows a lane
                need kSub 8: a sub-chunk's 3 x 2 x kSub row sums are cut
                over 16 lanes)
  no-fwd, no-skip, no-recompute, no-reduce, no-dv, no-cluster
                probes: base without its forward walk (the saved states
                are never written), the walk up to a sub-chunk, the
                sub-chunk's state updates, the row sums' reduce-scatter,
                the cluster's dv sums (reads and stores), or those and the
                cluster barriers; each times what is left, its result is
                wrong
  steps-only    probe: no-skip, no-reduce and no-cluster together

The variants are made by replacing the launch shape's constant lines of
the source, the probes by replacing exact lines: the script stops with an
error when one is gone. Every kernel but a probe computes the same
function; before it is timed, each is held against
``wkv6_backward_plain`` in float64 within ``chip_smoke.wkv_bwd_limit`` at
the shape, and two of its launches must give the same bits; a kernel that
fails either is reported with its errors and not timed. Times are
CUDA-event means of ``--reps`` launches after a warm-up, on random inputs
(``chip_smoke.wkv_case``; the time does not depend on the values), taken
in the order columns, base, the other variants, base, columns, so the
first pair and the last show the drift.

    python3 experiments/torch_wkv6_bwd_variants.py [--reps 10]

Prints one line per kernel and shape (with its registers and spills from
``-Xptxas -v`` and its shared memory a CTA) and a JSON record (also
written to ``chiprun_out/wkv6_bwd_variants.json``).
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

SHAPES = ((160, 4096), (80, 4096))     # rwkv6-3b prefill; a B 2 train step
VARIANTS = {"base": {}, "W2": {"kWarps": 2}, "W8": {"kWarps": 8},
            "R4 W1": {"kLaneRows": 4, "kWarps": 1},
            "R4 W2": {"kLaneRows": 4, "kWarps": 2},
            "R4 W4": {"kLaneRows": 4, "kWarps": 4},
            "C8": {"kChunk": 8}, "C32": {"kChunk": 32},
            "R4 S4": {"kLaneRows": 4, "kWarps": 2, "kSub": 4},
            "R4 C32 S4": {"kLaneRows": 4, "kWarps": 2, "kChunk": 32,
                          "kSub": 4}}
OLD = ROOT / "experiments" / "wkv6_bwd_columns.cu"
_DV = (("        reduce_dv(g - 1, t_prev);\n", ""),
       ("  reduce_dv(g - 1, t_prev);\n", ""))
_BARRIERS = (("        cluster_wait();\n", ""), ("  cluster_wait();\n", ""),
             ("      cluster_arrive();\n", ""), ("  cluster_arrive();\n", ""))
_SKIP = (("      for (int s = 0; s < sb; ++s) advance(buf, s, S);\n", ""),)
_REDUCE = (("      scatter_sum<kP3 * kSub, 8>(p, lane);\n", ""),)
PROBES = {
    "no-fwd": (("    for (int c = 0; c < nc; ++c) {\n",
                "    for (int c = 0; c < 0; ++c) {\n"),),
    "no-skip": _SKIP,
    "no-recompute": (("        advance(buf, sb + s, S);\n", ""),),
    "no-reduce": _REDUCE,
    "no-dv": _DV,
    "no-cluster": _DV + _BARRIERS,
    "steps-only": _SKIP + _REDUCE + _DV + _BARRIERS,
}
_VP, _I = ctypes.c_void_p, ctypes.c_int


def _const(src: str, name: str, value: int) -> str:
    """``src`` with the line of constant ``name`` set to ``value``."""
    pat = re.compile(rf"^constexpr int {name} = \d+;", re.M)
    if len(pat.findall(src)) != 1:
        raise RuntimeError(f"wkv6_bwd.cu no longer has one line `constexpr "
                           f"int {name} = ...;`")
    return pat.sub(f"constexpr int {name} = {value};", src)


def shape_of(src: str) -> dict[str, int]:
    return {c: int(re.search(rf"^constexpr int {c} = (\d+);", src, re.M)[1])
            for c in ("kLaneRows", "kWarps", "kChunk", "kSub")}


def smem_bytes(kLaneRows: int, kWarps: int, kChunk: int, kSub: int) -> int:
    """Dynamic shared memory a CTA (``kBytes`` in wkv6_bwd.cu)."""
    rows, threads = 2 * kLaneRows * kWarps, 32 * kWarps
    buf = 3 * kChunk * rows + 2 * kChunk * 64 + rows * 64
    return 4 * (2 * buf + 3 * kChunk * rows + 3 * kWarps * kSub * 64
                + 2 * kChunk + 8 * threads)


def ptxas_summary(log: str) -> dict[str, tuple[int, int, int]]:
    """kernel -> (registers, spill stores, spill loads) from ``-Xptxas
    -v``."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'(.*?)Used (\d+) "
                         r"registers", log, re.S):
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", m[2])
        name = re.search(r"wkv6_bwd_(?:kernel|finish)", m[1])
        out[name[0] if name else m[1]] = (
            int(m[3]), int(spill[1]) if spill else -1,
            int(spill[2]) if spill else -1)
    return out


def build(out_dir: Path) -> dict[str, tuple[ctypes.CDLL, str, dict]]:
    """Compile the old kernel and every variant with the port's flags, all
    at once."""
    from repro_torch.kernels import build as kbuild

    out_dir.mkdir(parents=True, exist_ok=True)
    src = (kbuild.CSRC / "wkv6_bwd.cu").read_text()
    texts = {"columns": OLD.read_text()}
    for name, consts in VARIANTS.items():
        text = src
        for c, value in consts.items():
            text = _const(text, c, value)
        texts[name] = text
    for name, edits in PROBES.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"wkv6_bwd.cu no longer has the line the "
                                   f"{name} probe replaces: {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        stem = name.replace(" ", "_")
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{stem}.so"
        procs[name] = (so, text, subprocess.Popen(
            [kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, text, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.wkv6_bwd_launch.restype = _I
        lib.wkv6_bwd_launch.argtypes = (
            [_VP] * (13 if name == "columns" else 12) + [_I] * 2 + [_VP])
        info = {"ptxas": ptxas_summary(log)}
        if name != "columns":
            info["shape"] = shape_of(text)
            info["smem_bytes"] = smem_bytes(**info["shape"])
        libs[name] = (lib, log, info)
    return libs


def runner(name, lib, info, args, dy):
    """A function that launches kernel ``name`` on ``args``, ``dy`` and
    returns ``(dr, dk, dw, dv, du)``; its scratch allocated once."""
    import torch

    bh, t, _ = args[0].shape
    f32, dev = torch.float32, args[0].device
    outs = [torch.empty((bh, t, 64), dtype=f32, device=dev)
            for _ in range(4)] + [torch.empty((bh, 64), dtype=f32,
                                              device=dev)]
    if name == "columns":
        nc = -(-t // 16)
        scratch = [torch.empty((bh * 4 * nc * 256 * 4,), dtype=f32,
                               device=dev),
                   torch.empty((3 * 4 * bh * t * 64,), dtype=f32,
                               device=dev)]
    else:
        nc = -(-t // info["shape"]["kChunk"])
        scratch = [torch.empty((bh * nc * 64 * 64,), dtype=f32, device=dev)]
    held = (*args, dy, *scratch, *outs)    # alive as long as the runner
    ptrs = [x.data_ptr() for x in held]

    def run():
        err = lib.wkv6_bwd_launch(
            *ptrs, bh, t, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{name}: cudaError {err}")
        return held[-5:]

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import close_to, cuda_ms, wkv_bwd_bound, wkv_bwd_limit, \
        wkv_case
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import wkv6 as kw6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build(kbuild.BUILD_DIR / "wkv6_bwd_variants")
    for name, (_, _, info) in libs.items():
        print(f"{name:8s} {info}", flush=True)
    names = ["columns", "base", *[n for n in VARIANTS if n != "base"],
             *PROBES, "base", "columns"]
    rec = {"device": smi, "reps": args.reps, "builds": {
        n: info for n, (_, _, info) in libs.items()}, "shapes": []}
    for bh, t in SHAPES:
        inputs = wkv_case(bh, t, 64, 64, seed=bh)
        dy = torch.randn(inputs[3].shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(t))
        want = kw6.wkv6_backward_plain(*(x.double()
                                         for x in (*inputs, dy)))
        lims = wkv_bwd_limit(kw6, inputs, dy)
        nbytes, flops = wkv_bwd_bound(inputs)
        bound = 1e3 * max(nbytes / 3.35e12, flops / 67e12)
        print(f"(BH, T, K, V) = ({bh}, {t}, 64, 64): bound {bound:.4f} ms",
              flush=True)
        runs, checks, failed = {}, {}, {}
        for name, (lib, _, info) in libs.items():
            runs[name] = runner(name, lib, info, inputs, dy)
            if name in PROBES:
                continue
            got = [x.clone() for x in runs[name]()]
            again = runs[name]()
            torch.cuda.synchronize()
            errs = {}
            for n, g, w, lim in zip(("dr", "dk", "dw", "dv", "du"), got,
                                    want, lims):
                try:
                    errs[n] = close_to(f"{name} wkv6_bwd {n}", g, w, lim)[1]
                except AssertionError as exc:
                    errs[n] = str(exc)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                errs["repeat"] = "two launches differ"
            if all(isinstance(e, float) for e in errs.values()):
                checks[name] = max(errs.values())
            else:
                failed[name] = errs
                print(f"  {name:8s} FAILED its check, not timed: {errs}",
                      flush=True)
            del got
        del want, lims
        rows = [{"kernel": n, "failed": e} for n, e in failed.items()]
        for name in names:
            if name in failed:
                continue
            ms = cuda_ms(runs[name], args.reps)
            share = checks.get(name)
            rows.append({"kernel": name, "ms": ms, "share_of_limit": share})
            check = ("timing only" if share is None else
                     f"{share:.3f} of the limit, bitwise repeat")
            print(f"  {name:12s} {ms:8.4f} ms a launch ({ms / bound:6.2f}x "
                  f"the bound; {check})", flush=True)
        rec["shapes"].append({"bh": bh, "t": t, "bound_ms": bound,
                              "bytes": nbytes, "flops": flops, "rows": rows})
        del runs, inputs, dy
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wkv6_bwd_variants.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
