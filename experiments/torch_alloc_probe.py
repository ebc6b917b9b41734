"""Which ops allocate on the card what the ``meta`` trace does not see.

``analysis.cost.CostMode`` counts a storage for each new output of each
op. A CUDA kernel may also allocate scratch of its own, which lives only
inside the op, and an op may keep more than its outputs. This script runs
a call on the card under a dispatch mode that, around each op, reads
``torch.cuda.memory_allocated`` and ``max_memory_allocated``: it prints
the ops whose peak inside the op exceeds what was live before it plus
its new outputs by more than ``--min-mib``, and the ops whose live bytes
after the op differ from that sum.

    python3 experiments/torch_alloc_probe.py          # [16a]'s step, 2 layers
    python3 experiments/torch_alloc_probe.py --layers 22 --kind prefill
    python3 experiments/torch_alloc_probe.py --kind ops   # ops alone

Needs one CUDA card.
"""
import argparse
import dataclasses
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--kind", default="train",
                    choices=["train", "prefill", "ops"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--min-mib", type=float, default=8.0)
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    if args.kind == "train":
        ocfg = OptimizerConfig(total_steps=2, warmup_steps=1)
        state = init_state(cfg, ocfg, 0, device="cuda")
        batch = SyntheticLM(cfg, args.batch, args.seq,
                            seed=0).next()
        step = make_train_step(cfg, ocfg)

        def fn():
            return step(state, batch)
    elif args.kind == "ops":
        fn = _ops
    else:
        model = transformer.init_model(cfg, 0, device="cuda")
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq),
                               device="cuda")

        def fn():
            with torch.no_grad():
                return transformer.forward(model, cfg, tokens)

    mib = 2 ** 20
    scratch, kept = Counter(), Counter()

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            ins = {t.untyped_storage().data_ptr() for t in _tensors(a, kw)}
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = func(*a, **(kw or {}))
            torch.cuda.synchronize()
            outs = _tensors((out,), None)
            new = {t.untyped_storage().data_ptr(): t.untyped_storage()
                   .nbytes() for t in outs
                   if t.untyped_storage().data_ptr() not in ins}
            made = sum(new.values())
            extra = torch.cuda.max_memory_allocated() - before - made
            if extra > args.min_mib * mib:
                scratch[(str(func), _shapes(a))] = max(
                    scratch[(str(func), _shapes(a))], extra)
            drift = torch.cuda.memory_allocated() - before - made
            if abs(drift) > args.min_mib * mib:
                kept[(str(func), _shapes(a))] += drift
            return out

    fn()                                   # warm: workspaces, kernels
    torch.cuda.synchronize()
    with Probe():
        fn()
    print(f"{args.arch} {args.kind}, {args.layers} layers, B {args.batch}, "
          f"S {args.seq}")
    print("ops whose peak inside the op exceeds live + new outputs:")
    for (name, shapes), b in scratch.most_common(20):
        print(f"  {b / mib:10.1f} MiB  {name} {shapes}")
    print("ops whose live bytes after differ from live + new outputs:")
    for (name, shapes), b in kept.most_common(20):
        print(f"  {b / mib:10.1f} MiB  {name} {shapes}")


def _ops():
    """Isolated calls of the ops the step's probe names, contiguous and
    not, float32 and bfloat16."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((4, 32, 512, 4096), device="cuda", generator=g,
                        dtype=dt, requires_grad=True)
        y = torch.softmax(x, dim=-1)
        y.backward(torch.ones_like(y))                  # contiguous grad
        y = torch.softmax(x.float(), dim=-1).to(dt)
        y.backward(torch.ones_like(y))                  # through a cast
        z = torch.randn((4, 512, 32000), device="cuda", generator=g,
                        dtype=dt)
        torch.logsumexp(z.float(), dim=-1)
        w = torch.randn((4, 4096, 2048), device="cuda", generator=g,
                        dtype=dt)
        w.sum((0, 1))
        w.float().sum((0, 1))
        w.float().mean(-1)
        w.transpose(0, 1).sum((0, 1))
    return None


def _tensors(a, kw):
    import torch

    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(a)
    if kw:
        walk(kw)
    return out


def _shapes(a):
    import torch

    return tuple(tuple(x.shape) if isinstance(x, torch.Tensor) else None
                 for x in a if isinstance(x, torch.Tensor))


if __name__ == "__main__":
    main()
