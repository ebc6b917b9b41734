"""One ``rwkv6-3b`` training step on one CUDA card, timed and split by
kernel: ``chip_smoke.py`` [16c]'s path (full width and depth, B 2 x S
4096, AdamW, ``remat="full"``, ``wb_lora`` drawn non-zero) without its
checks, so that two trees of the repository can be compared in one run.

It imports the ``repro_torch`` beside it (``ROOT/src``, ROOT the parent of
this file's directory): copied into another checkout's ``experiments/``,
it measures that checkout. ``--steps`` steps are timed on the host clock
around synchronised steps (the first includes the kernels' first use),
then one more step runs under ``torch.profiler``: device ms in
``wkv6_bwd``, in ``wkv6`` (forward and recompute), in matrix products
(cuBLAS, CUTLASS, nvjet kernels) and in every other kernel. If the
profiler sees no device time, the split is reported as not measured and
the step's CUDA-event total stands alone.

    python3 experiments/torch_rwkv_train_step.py [--steps 4] [--tag NAME]

Prints the card, the step times and the split, and one JSON line (also
appended to ``chiprun_out/rwkv_train_step.jsonl``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCH, BATCH, SEQ = "rwkv6-3b", 2, 4096
WB_LORA_STD = 0.15          # wb_lora is zero at init (chip_smoke.py's)
KERNELS = ("wkv6_bwd", "wkv6")
MATMUL = ("gemm", "xmma", "nvjet", "cutlass")


def split(prof):
    """Device ms by class from a finished profiler, with the kernel count
    and the largest kernels."""
    from torch.autograd import DeviceType

    ms = {**{k: 0.0 for k in KERNELS}, "matmul": 0.0, "other": 0.0}
    top, n = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.device_time_total / 1e3
        name = e.key.lower()
        kind = next((k for k in KERNELS if k in name), None) or (
            "matmul" if any(w in name for w in MATMUL) else "other")
        ms[kind] += t
        n += e.count
        top.append((t, e.count, e.key[:90]))
    top.sort(reverse=True)
    return ms, n, [{"ms": t, "count": c, "name": k} for t, c, k in top[:10]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--tag", default=str(ROOT))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{args.tag}: {smi}", flush=True)
    cfg = get_config(ARCH)
    ocfg = OptimizerConfig(total_steps=args.steps + 1, warmup_steps=1)
    state = init_state(cfg, ocfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for w in state["params"]["stage0"]["b0"]["wb_lora"]:
        w.normal_(0.0, WB_LORA_STD, generator=g)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0, device="cuda")
    step = make_train_step(cfg, ocfg)
    step_ms, losses = [], []
    for _ in range(args.steps):
        b = data.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["loss"]))
    steady = statistics.median(step_ms[1:])
    b = data.next()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        state, m = step(state, b)
        ev[1].record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ms, n, top = split(prof)
    busy = sum(ms.values())
    rec = {"tag": args.tag, "device": smi, "arch": ARCH, "batch": BATCH,
           "seq": SEQ, "step_ms": step_ms, "steady_step_ms": steady,
           "tokens_per_s": BATCH * SEQ / (steady / 1e3), "losses": losses,
           "profiled_wall_ms": wall,
           "profiled_event_ms": ev[0].elapsed_time(ev[1]),
           "device_ms": ms if busy else None, "kernels": n,
           "busy_share": busy / wall if busy else None, "top": top}
    print(f"{args.tag}: step ms " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f" (median after the first {steady:.1f}, "
          f"{rec['tokens_per_s']:,.0f} tokens/s)", flush=True)
    if busy:
        print(f"{args.tag}: profiled step wall {wall:.1f} ms, {n} kernels, "
              f"device busy {busy / wall:.1%}: " + ", ".join(
                  f"{k} {v:.1f}" for k, v in ms.items()) + " ms", flush=True)
    else:
        print(f"{args.tag}: the profiler saw no device time (split not "
              f"measured); CUDA events {rec['profiled_event_ms']:.1f} ms",
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "rwkv_train_step.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
