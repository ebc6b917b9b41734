"""``chip_smoke.py`` [17a]'s sharded step on several cards: tinyllama-1.1b
at full width and depth, B 4 x S 4096, bf16 compute over f32 masters,
AdamW, trained

  single   on one card (``make_train_step`` without a mesh);
  1card    sharded over a (data 2, model 2) mesh of 4 shards on cuda:0;
  4cards   the same mesh with a shard a card (cuda:0-3), where torch sees
           4 cards.

Each run starts from the same state (seed 0, drawn on cuda:0 and placed
by a copy) and takes the same batches: one warm-up step, ``--steps``
timed steps (host clock around steps synchronised on every card), then
one step under ``torch.profiler``, whose device time (summed over the
cards) is split into DMA copies (``Memcpy`` events: the peer copies
between cards), copy kernels (casts, ``torch.cat``, assembling a
working copy on its own card), matrix products and the rest. The first
step's loss of each sharded run is held to the single run's within 3e-2
(the reference's bf16 bound).

    python3 experiments/torch_sharded_train_cards.py      # 4 cards

Prints a line a run and a JSON record; writes it to
``chiprun_out/torch_sharded_train_cards.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ = 4, 4096
LOSS_ATOL = 3e-2


def sync_all():
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def profile_split(fn):
    """Device ms of one call of ``fn`` under ``torch.profiler``, summed
    over every card: ``memcpy`` (DMA copies, the peer copies between
    cards), ``copy`` (copy kernels), ``matmul`` and ``other``; the host's
    wall ms and each class's share of the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync_all()
        wall = 1e3 * (time.perf_counter() - t0)
    ms = {"memcpy": 0.0, "copy": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = ("memcpy" if "memcpy" in name else "copy" if "copy" in name
                else "matmul" if any(w in name for w in (
                    "gemm", "xmma", "nvjet", "cutlass")) else "other")
        ms[kind] += e.device_time_total / 1e3
        kernels += e.count
    busy = sum(ms.values())
    return {"wall_ms": wall, "kernels": kernels,
            "device_ms": ms if busy else None,
            "shares": {k: v / busy for k, v in ms.items()} if busy
            else None}


def run(name, cfg, ocfg, ctx, steps):
    import torch
    from repro_torch import sharding
    from repro_torch.launch import specs
    from repro_torch.training import SyntheticLM, init_state, make_train_step

    import chip_smoke as c

    c.free_device_memory()
    state = init_state(cfg, ocfg, 0, device="cuda:0")
    if ctx is not None:
        placed = specs.place_state(state, ctx)
        del state
        state = placed
        c.free_device_memory()
    with sharding.use(ctx):
        step = make_train_step(cfg, ocfg)
    data = SyntheticLM(cfg, BATCH, SEQ, seed=0, device="cuda:0")
    for d in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(d)
    state, m = step(state, data.next())
    first_loss = float(m["loss"])
    ms = []
    for _ in range(steps):
        b = data.next()
        sync_all()
        t0 = time.perf_counter()
        state, m = step(state, b)
        sync_all()
        ms.append(1e3 * (time.perf_counter() - t0))
    b = data.next()
    held = {}

    def one():
        held["s"], _ = step(state, b)

    prof = profile_split(one)
    peaks = [torch.cuda.max_memory_allocated(d) / 2**30
             for d in range(torch.cuda.device_count())]
    del held, state
    c.free_device_memory()
    med = statistics.median(ms)
    out = {"run": name, "first_loss": first_loss, "step_ms": ms,
           "median_ms": med, "tokens_per_s": BATCH * SEQ / (med / 1e3),
           "peak_gib": peaks, **prof}
    print(f"{name}: step ms " + ", ".join(f"{x:.1f}" for x in ms)
          + f" (median {med:.1f}, {out['tokens_per_s']:,.0f} tokens/s); "
          f"first loss {first_loss:.5f}; profiled step wall "
          f"{prof['wall_ms']:.1f} ms, {prof['kernels']} kernels, device ms "
          f"{prof['device_ms']}; peak GiB "
          + ", ".join(f"{p:.2f}" for p in peaks if p), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh

    _, smi = c.phase_card()
    n = torch.cuda.device_count()
    print(smi, "cards", n, flush=True)
    cfg = get_config(c.TRAIN_ARCH)
    ocfg = c.train_ocfg(2 + args.steps)
    runs = [("single", None),
            ("1card", sharding.make_ctx(make_mesh(
                (2, 2), ("data", "model"), ["cuda:0"] * 4)))]
    if n >= 4:
        runs.append(("4cards", sharding.make_ctx(make_mesh(
            (2, 2), ("data", "model")))))
    out = [run(name, cfg, ocfg, ctx, args.steps) for name, ctx in runs]
    for r in out[1:]:
        gap = abs(r["first_loss"] - out[0]["first_loss"])
        if not gap <= LOSS_ATOL:
            raise AssertionError(f"{r['run']}: first loss {r['first_loss']}"
                                 f" against {out[0]['first_loss']}")
    rec = {"nvidia_smi": smi, "cards": n, "runs": out}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_sharded_train_cards.json").write_text(
        json.dumps(rec, indent=1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
