"""What bounds one warp of the split ``lru_scan`` kernel, measured on one
CUDA card: the forward kernel as it is against variants of its own source,
each at a model shard's (1, 4096, 2048) and the prefill's (4, 4096, 4096),
with one span (the ring streams all T steps) and with spans of 64 steps.

  base        ``src/repro_torch/kernels/csrc/lru_scan.cu`` as it is
  ahead3      3 stages loaded ahead (``kA``) instead of 7, a ring of 4
  nostore     probe: h stored only where a < 0, which never holds (its
              result is wrong); the walk without its per-step stores
  nowait      probe: no ``cp.async.wait_group`` (the steps read whatever
              the ring holds; wrong); the copies issued, never waited for
  nocopy      probe: no copies (wrong); the walk over a ring never filled

Variants are made by replacing exact lines of the source: the script is
tied to the source revision it ships with and stops with an error when a
line it replaces is gone. ``ahead3`` computes the same function and is
held against the plain version (rtol = atol = 1e-5) before it is timed;
the probes are not. Each time is the mean of
``--reps`` launches by CUDA events after a warm-up, on
``chip_smoke.lru_case``'s inputs.

    python3 experiments/torch_lru_split_probe.py [--reps 20]

Prints one line per (variant, shape, spans) and a JSON record (also
written to ``chiprun_out/lru_split_probe.json``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SRC = ROOT / "src/repro_torch/kernels/csrc/lru_scan.cu"
AHEAD = "constexpr int kA = 7;      // stages loaded ahead of the one being walked\n"
STORE = "                      if (store) __stcs(o, y);\n"
WAIT = "      cp_wait<kA>();\n"
COPY = "          cp_async<V>(slot + (j * kG + i) * kC + col, g, ok);\n"
VARIANTS = {
    "base": [],
    "ahead3": [(AHEAD, AHEAD.replace("7", "3"))],
    "nostore": [(STORE, STORE.replace("(store)", "(store && v[0] < 0.f)"))],
    "nowait": [(WAIT, "\n")],
    "nocopy": [(COPY, "          (void)g;\n")],
}
SHAPES = ((1, 4096, 2048), (4, 4096, 4096))


def build_variant(name, edits):
    from repro_torch.kernels import build

    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the line {old!r} is gone from "
                             f"{SRC.name}")
        text = text.replace(old, new)
    out_dir = ROOT / "build" / "lru_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib_path = out_dir / f"lib{name}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.lru_scan_launch.argtypes = [vp] * 3 + [i] * 5 + [vp] * 3
    return lib


def launcher(lib, klru, a, x, span):
    """A launch of ``lib``'s forward kernel with spans of ``span`` steps."""
    import torch

    b, t, d = a.shape
    n = -(-t // span)

    def fn():
        h = torch.empty_like(a)
        sync = agg = None
        if n > 1:
            ctas = n * b * -(-d // klru.CHANNELS)
            sync = torch.zeros(1 + ctas, dtype=torch.int32, device=a.device)
            agg = torch.empty(2 * klru.CHANNELS * ctas, device=a.device)
        err = lib.lru_scan_launch(
            a.data_ptr(), x.data_ptr(), h.data_ptr(), b, t, d, n, span,
            None if sync is None else sync.data_ptr(),
            None if agg is None else agg.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return h
    return fn


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    from chip_smoke import HBM_BYTES_PER_S, cuda_ms, lru_case
    from repro_torch.kernels import lru_scan as klru

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    libs = {name: build_variant(name, edits)
            for name, edits in VARIANTS.items()}
    rows = []
    for shape in SHAPES:
        a, x = lru_case(*shape, seed=7, dtype=torch.float32)
        want = klru.lru_scan_plain(a, x)
        bound = 1e3 * klru.lru_scan_cost(*shape)[0] / HBM_BYTES_PER_S
        for span in (shape[1], 64):
            for name, lib in libs.items():
                fn = launcher(lib, klru, a, x, span)
                if not name.startswith("no"):
                    torch.testing.assert_close(fn(), want, rtol=1e-5,
                                               atol=1e-5)
                ms = cuda_ms(fn, args.reps)
                rows.append({"variant": name, "shape": list(shape),
                             "span": span, "ms": ms, "bound_ms": bound})
                print(f"{name:8s} {shape} span {span}: {ms:.4f} ms (bound "
                      f"{bound:.4f})", flush=True)
        del a, x, want
    rec = {"card": card, "reps": args.reps, "rows": rows}
    out = ROOT / "chiprun_out" / "lru_split_probe.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(card)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
