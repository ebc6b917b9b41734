"""The split ``lru_scan`` and ``lru_scan_bwd`` kernels across span lengths,
measured on one CUDA card, beside the one-thread-a-channel kernels they
replace.

At each shape the RG-LRU kernels run at (one model shard of a (data 2,
model 2) recurrentgemma-9b step, the single-device training step, the
prefill, a long T at a small B D), each kernel runs with:

  pick      the spans ``kernels.lru_scan.split_bounds`` picks on this card
  one       one span of T (no split: the ring streams the whole T)
  L=<n>     spans of n steps (at most 64 of them)
  old       ``--old``'s source (the kernels before the split, built here
            with their own C signatures), timed first and last

and, as a yardstick of what the card moves when it reads and writes at
once, ``Tensor.copy_`` of a (B, T, D) float32 array into another.

Every variant is held against the plain version (float32 forward, float64
backward) at rtol = atol = 1e-5 and run twice, bitwise, before it is
timed. ``ms`` is the mean of ``--reps`` launches by CUDA events after a
warm-up, as ``chip_smoke.py`` times them (the wrapper's host work
included: where the host takes longer than the card, that is what it
measures); ``host_ms`` the host's time to issue one; ``graph_ms`` the
same ``--reps`` launches captured in a CUDA graph and replayed, which
leaves the card's time alone (the flags' fill and the kernel). Inputs are
``chip_smoke.lru_case``'s (a in [0.3, 0.999], x normal; the time does not
depend on the values); the bound is the bytes each kernel must move over
3.35 TB/s.

    python3 experiments/torch_lru_split_sweep.py [--reps 20] [--old FILE]

Prints one line per (shape, kernel, variant), the card's name and power
limit, and a JSON record (also written to
``chiprun_out/lru_split_sweep.json``).
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

SHAPES = ((1, 4096, 2048), (2, 4096, 4096), (4, 4096, 4096),
          (1, 32768, 1024))
SPANS = (64, 128, 256, 512, 1024)
TOL = dict(rtol=1e-5, atol=1e-5)


def load_old(path):
    """The kernels of ``path`` (the one-thread-a-channel source), built
    with ``nvcc`` into ``build/`` and bound with their C signatures."""
    from repro_torch.kernels import build

    out = ROOT / "build" / "lru_scan_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.lru_scan_launch.argtypes = [vp] * 3 + [i] * 3 + [vp]
    lib.lru_scan_bwd_launch.argtypes = [vp] * 5 + [i] * 3 + [vp]
    return lib


def old_fwd(lib, a, x):
    import torch

    h = torch.empty_like(a)
    err = lib.lru_scan_launch(a.data_ptr(), x.data_ptr(), h.data_ptr(),
                              *a.shape,
                              torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return h


def old_bwd(lib, a, h, dh):
    import torch

    da, dx = torch.empty_like(a), torch.empty_like(a)
    err = lib.lru_scan_bwd_launch(
        a.data_ptr(), h.data_ptr(), dh.data_ptr(), da.data_ptr(),
        dx.data_ptr(), *a.shape, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return da, dx


def timed(fn, reps):
    """(CUDA-event ms a launch, host ms a launch, ms a launch replayed
    from a CUDA graph of ``reps`` launches)."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    w0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - w0) / reps
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    out = ms, host, e0.elapsed_time(e1) / reps
    del graph
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from chip_smoke import HBM_BYTES_PER_S, lru_case
    from repro_torch.kernels import build
    from repro_torch.kernels import lru_scan as klru

    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    build.load("lru_scan")
    print(build.BUILD_LOG["lru_scan"])
    old = load_old(args.old) if args.old else None
    sms = klru.device_sms("cuda")
    rows = []
    for shape in SHAPES:
        b, t, d = shape
        a, x = lru_case(*shape, seed=7, dtype=torch.float32)
        dh = torch.randn_like(a)
        want = klru.lru_scan_plain(a, x)
        wda, wdx = klru.lru_scan_backward_plain(a.double(), want.double(),
                                                dh.double())
        pick = klru.split_span(b, t, d, sms)
        spans = {"pick": pick, "one": t}
        spans.update({f"L={n}": n for n in SPANS
                      if n < t and -(-t // n) <= klru.MAX_SPLITS})
        fwd = {name: (lambda n=n: klru._launch(a, x, n))
               for name, n in spans.items()}
        bwd = {name: (lambda n=n: klru._launch_bwd(a, want, dh, n))
               for name, n in spans.items()}
        if old is not None:
            fwd = {"old": lambda: old_fwd(old, a, x), **fwd,
                   "old again": lambda: old_fwd(old, a, x)}
            bwd = {"old": lambda: old_bwd(old, a, want, dh), **bwd,
                   "old again": lambda: old_bwd(old, a, want, dh)}
        for kernel, fns, nbytes in (
                ("lru_scan", fwd, klru.lru_scan_cost(*shape)[0]),
                ("lru_scan_bwd", bwd, klru.lru_scan_bwd_cost(*shape)[0])):
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            for name, fn in fns.items():
                one, two = fn(), fn()
                if kernel == "lru_scan":
                    torch.testing.assert_close(one, want, **TOL)
                    same = torch.equal(one, two)
                else:
                    torch.testing.assert_close(one[0].double(), wda, **TOL)
                    torch.testing.assert_close(one[1].double(), wdx, **TOL)
                    same = all(map(torch.equal, one, two))
                assert same, f"{kernel} {name} {shape}: not bitwise"
                del one, two
                ms, host, graph = timed(fn, args.reps)
                span = spans.get(name)
                row = {"shape": list(shape), "kernel": kernel,
                       "variant": name, "span": span,
                       "splits": -(-t // span) if span else None,
                       "ms": ms, "host_ms": host, "graph_ms": graph,
                       "bound_ms": bound, "share": bound / ms}
                rows.append(row)
                print(f"{shape} {kernel:13s} {name:9s} span {span} "
                      f"splits {row['splits']}: {ms:.4f} ms (host "
                      f"{host:.4f}, graph {graph:.4f}; bound {bound:.4f}, "
                      f"{bound / ms:.2f} of it)", flush=True)
        # Yardstick: a device copy moves 8 B an element (a read, a write),
        # the bytes of the forward's mix at two thirds of its volume.
        h = torch.empty_like(a)
        ms, host, graph = timed(lambda: h.copy_(a), args.reps)
        rows.append({"shape": list(shape), "kernel": "copy_",
                     "variant": "a into h", "ms": ms, "graph_ms": graph,
                     "tb_per_s": 8 * a.numel() / ms / 1e9})
        print(f"{shape} copy_ a into h: {ms:.4f} ms "
              f"({rows[-1]['tb_per_s']:.2f} TB/s read + write)", flush=True)
        del a, x, h, dh, want, wda, wdx
        torch.cuda.empty_cache()
    rec = {"card": card, "sms": sms, "reps": args.reps, "rows": rows}
    out = ROOT / "chiprun_out" / "lru_split_sweep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(card)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
