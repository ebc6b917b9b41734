"""How far rounding moves a MoE train step: olmoe-1b-7b at full width on
2 layers, B 4, at a capacity factor of E / k (nothing drops), one
``make_train_step`` (AdamW at lr 0, so the parameters stay as they
are) from the same state and batch

  again    the single-device step run a second time (``index_add``'s
           atomics add a token's k expert outputs in any order);
  sharded  the step over a (data 2, model 2) mesh of 4 shards of cuda:0
           (heads and experts over the model axis: the attention
           output is the sum of two rounded partials);

each against the first single-device run, in bf16 compute at S 4096 and
in float32 (TF32 off) at S 1024. For each it counts the tokens whose
set of top-k experts differs, by layer (from the router's ids recorded
in the forward), and gives the loss difference and each gradient leaf's
largest difference (the first moment, 0.1 g) over that leaf's largest
value.

    python3 experiments/torch_moe_route_flips.py

Prints a line a comparison and a JSON record; writes it to
``chiprun_out/torch_moe_route_flips.json``.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LAYERS, BATCH = 2, 4


def main() -> int:
    import torch
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, transformer
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves

    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("olmoe-1b-7b")
    ocfg = OptimizerConfig(lr=0.0, warmup_steps=1, total_steps=2)
    ctx = sharding.make_ctx(make_mesh((2, 2), ("data", "model"),
                                      ["cuda:0"] * 4))
    seen = []
    route = moe._route

    def recording(xt, router, k):
        w, ids = route(xt, router, k)
        if torch.is_grad_enabled():
            seen.append(ids.detach())
        return w, ids

    def sets(ids):
        return torch.sort(ids, -1)[0]

    def run(state, cfg, batch, mesh):
        """One step; the forward's ids of each layer as (B, S, k), the
        loss and the first moments (m is zeroed after: lr 0 leaves the
        parameters as they were)."""
        seen.clear()
        if mesh:
            with sharding.use(ctx):
                new, m = make_train_step(cfg, ocfg)(state, batch)
        else:
            new, m = make_train_step(cfg, ocfg)(state, batch)
        torch.cuda.synchronize()
        s = batch["tokens"].shape[1]
        n = len(transformer.layer_kinds(cfg))
        if mesh:   # per dp row: each layer's two model shards, then recompute
            per_row = [seen[r * 2 * n:(r + 1) * 2 * n] for r in range(2)]
            ids = [torch.cat([torch.cat([row[2 * layer + j].reshape(
                BATCH // 2, s // 2, -1) for j in range(2)], 1)
                for row in per_row], 0) for layer in range(n)]
        else:
            ids = [x.reshape(BATCH, s, -1) for x in seen[:n]]
        opt = new["opt"]
        ms = [sharding.gather_tensor(x) if isinstance(x, sharding.Sharded)
              else x.clone() for x in leaves(opt["m"])]
        for tree in (opt["m"], opt["v"]):
            for x in leaves(tree):
                for piece in (x.pieces.values()
                              if isinstance(x, sharding.Sharded) else (x,)):
                    piece.zero_()
        opt["step"].zero_()
        return [sets(i) for i in ids], float(m["loss"]), ms

    moe._route = recording
    out = {}
    try:
        for dtype, seq in (("bfloat16", 4096), ("float32", 1024)):
            cfg = dataclasses.replace(
                base, n_layers=LAYERS, compute_dtype=dtype,
                capacity_factor=base.n_experts / base.top_k)
            state = init_state(cfg, ocfg, 0, device="cuda")
            batch = SyntheticLM(cfg, BATCH, seq, seed=0,
                                device="cuda").next()
            ids0, loss0, m0 = run(state, cfg, batch, False)
            rec = {}
            for name in ("again", "sharded"):
                st = specs.place_state(state, ctx) if name == "sharded" \
                    else state
                ids, loss, ms = run(st, cfg, batch, name == "sharded")
                flips = [int((a != b).any(-1).sum()) for a, b in
                         zip(ids, ids0)]
                shares = [float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(ms, m0)]
                rec[name] = {"tokens": BATCH * seq, "flipped": flips,
                             "loss_diff": loss - loss0,
                             "max_leaf_share": max(shares),
                             "leaf_shares": shares}
                print(f"{dtype} S {seq} {name}: tokens whose top-"
                      f"{cfg.top_k} set differs, by layer {flips} of "
                      f"{BATCH * seq}; loss {loss:.6f} against {loss0:.6f};"
                      f" largest gradient-leaf difference "
                      f"{max(shares):.3e} of the leaf's largest")
                del st, ms
                torch.cuda.empty_cache()
            out[f"{dtype}_S{seq}"] = rec
            del state, m0
            torch.cuda.empty_cache()
    finally:
        moe._route = route
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_moe_route_flips.json").write_text(json.dumps(out,
                                                                indent=1))
    print(json.dumps({k: {n: {kk: vv for kk, vv in r.items()
                              if kk != "leaf_shares"}
                          for n, r in v.items()} for k, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
