"""The MoE combine two ways, in one process on one card, at olmoe-1b-7b's
full width (d 2048, 64 experts, top-8, capacity factor 1.25):

  index_add    every kept pair's weighted output added to its token by
               one ``index_add`` (CUDA atomics: a token's k terms land
               in any order);
  fixed_order  ``moe._combine``: the pairs laid out (T, k) by a stable
               sort by token and the k terms added one after another.

At a training step's shape (B 4, S 4096: 16,384 tokens, C 2,560) it
gives, for each, the CUDA-event ms (median of ``REPS``) of the combine's
forward, of its forward and backward, and of one MoE layer's forward
and backward (``moe._apply_local``, bf16 compute, float32 weights), and
whether two runs on the same inputs give the same output and the same
gradients bit for bit. At a decode step's shape (4 tokens, C 1) it
gives the host's µs a combine (the decode step is host-bound).

    python3 experiments/torch_moe_combine.py

Prints the card's name and power limit, a line a variant and a JSON
record; writes it to ``chiprun_out/torch_moe_combine.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

BATCH, SEQ, REPS, HOST_REPS = 4, 4096, 20, 200


def index_add_combine(out_buf, dispatch_info, weights, t_tok: int):
    """The combine as one ``index_add`` of the sorted pairs."""
    import torch

    slot, keep, st, order = dispatch_info
    e, c, d = out_buf.shape
    rows = out_buf.reshape(e * c, d)
    vals = torch.where(keep[:, None], rows[slot.clamp(max=e * c - 1)], 0)
    w_sorted = weights.reshape(-1)[order]
    out = out_buf.new_zeros((t_tok, d))
    return out.index_add(0, st, vals * w_sorted[:, None].to(out_buf.dtype))


def cuda_ms(fn, reps):
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def main() -> int:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import Node

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    cfg = get_config("olmoe-1b-7b")
    k, e = cfg.top_k, cfg.n_experts
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = Node(moe.init_moe(cfg, gen))
    p.router.requires_grad_()
    variants = {"index_add": index_add_combine, "fixed_order": moe._combine}
    keep = moe._combine
    out = {"card": smi, "batch": BATCH, "seq": SEQ, "reps": REPS}

    t_tok = BATCH * SEQ
    x = torch.randn(BATCH, SEQ, cfg.d_model, device="cuda",
                    generator=gen).bfloat16()
    xt = x.reshape(t_tok, -1)
    cap = moe._capacity(t_tok, k, e, cfg.capacity_factor)
    with torch.no_grad():
        w, ids = moe._route(xt, p.router, k)
        buf, info = moe._dispatch(xt, ids, e, cap)
        ob = moe._expert_ffn(buf, p.w_gate, p.w_up, p.w_down, cfg)
    dy = torch.randn(t_tok, cfg.d_model, device="cuda",
                     generator=gen).bfloat16()
    dlayer = dy.reshape(x.shape)
    for name, fn in variants.items():
        obg = ob.detach().requires_grad_()
        wg = w.detach().requires_grad_()

        def fwd(fn=fn):
            with torch.no_grad():
                return fn(ob, info, w, t_tok)

        def fwd_bwd(fn=fn, obg=obg, wg=wg):
            y = fn(obg, info, wg, t_tok)
            return (y, *torch.autograd.grad(y, (obg, wg), dy))

        def layer(fn=fn):
            moe._combine = fn
            try:
                xg = x.detach().requires_grad_()
                y = moe._apply_local(p, xg, cfg)
                return (y, *torch.autograd.grad(y, (xg, p.router), dlayer))
            finally:
                moe._combine = keep

        rec = {"combine_fwd_ms": cuda_ms(fwd, REPS),
               "combine_fwd_bwd_ms": cuda_ms(fwd_bwd, REPS),
               "layer_fwd_bwd_ms": cuda_ms(layer, REPS)}
        a, b = fwd_bwd(), fwd_bwd()
        rec["combine_repeats_bitwise"] = [bool(torch.equal(u, v))
                                          for u, v in zip(a, b)]
        a, b = layer(), layer()
        rec["layer_repeats_bitwise"] = [bool(torch.equal(u, v))
                                        for u, v in zip(a, b)]
        del a, b
        out[name] = rec
    del ob, buf, dy, x, xt
    torch.cuda.empty_cache()

    t_dec = 4
    xd = torch.randn(t_dec, cfg.d_model, device="cuda",
                     generator=gen).bfloat16()
    with torch.no_grad():
        wd, idd = moe._route(xd, p.router, k)
        cd = moe._capacity(t_dec, k, e, cfg.capacity_factor)
        bd, infod = moe._dispatch(xd, idd, e, cd)
        obd = moe._expert_ffn(bd, p.w_gate, p.w_up, p.w_down, cfg)
        for name, fn in variants.items():
            out[name]["decode_host_us"] = host_us(
                lambda fn=fn: fn(obd, infod, wd, t_dec), HOST_REPS)
    for name in variants:
        r = out[name]
        print(f"{name}: combine forward {r['combine_fwd_ms']:.3f} ms, "
              f"forward + backward {r['combine_fwd_bwd_ms']:.3f} ms, a MoE "
              f"layer's forward + backward {r['layer_fwd_bwd_ms']:.3f} ms at "
              f"{t_tok} tokens (C {cap}); output and gradients bitwise "
              f"on a second run: combine {r['combine_repeats_bitwise']}, "
              f"layer {r['layer_repeats_bitwise']}; decode (4 tokens, C "
              f"{cd}) {r['decode_host_us']:.1f} us a combine on the host")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_moe_combine.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
