"""How far one bf16 training step's gradients move under rounding alone,
beside how far the sharded step's move from the single-device step's, on
one CUDA card: ``chip_smoke.py`` [17b]'s models (full width, its 4
layers, B 2 x S 4096, AdamW, ``remat="full"``; rwkv6-3b's ``wb_lora``
drawn non-zero) and [17a]'s tinyllama-1.1b on the same 4 layers, each
from one state and one batch:

  * ``tp``: the sharded step over (data 2, model 2) of ``cuda:0`` against
    the single-device bf16 step;
  * ``dp``: the same over (data 2, model 1);
  * ``tp_f32_sums``: ``tp`` with every sum over the model axis adding
    its partials in float32 and rounding the total once;
  * ``floor``: the single-device bf16 step against the single-device
    float32 step (TF32 off), bf16's own rounding;
  * ``nudge``: the single-device bf16 step from the state with each
    element of its embedding table scaled by 1 + 2^-8 or 1 - 2^-8 (a
    random sign from a seed: a perturbation of the size of one bf16
    rounding) against the single-device bf16 step, how far such a
    perturbation carries;
  * ``tp_f32``: the sharded step over (data 2, model 2) against the
    single-device step, both float32 (TF32 off);
  * ``nudge_f32``: ``nudge`` in float32, by 1 +- 2^-22 (a float32
    rounding or two).

Each is the largest share, over the gradient leaves (AdamW's first
moments), of ``chip_smoke.leaf_limit`` at ``SHARD_GRAD_RTOL`` (5e-2 of
the reference leaf's largest |element|, at least 1e-6 of the step's
largest), with the five worst leaves and the loss difference.

It imports the ``repro_torch`` and ``chip_smoke.py`` beside it (ROOT the
parent of this file's directory).

    python3 experiments/torch_tp_bf16_noise.py [--archs rwkv6-3b,...]

Prints one line a comparison and, last, one JSON line of every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCHS = ("rwkv6-3b", "recurrentgemma-9b", "tinyllama-1.1b")
LAYERS, BATCH, SEQ = 4, 2, 4096


def leaf_names(tree, pre=""):
    """Each tensor's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{pre}/{k}")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree)
                for n in leaf_names(x, f"{pre}[{i}]")]
    return [pre]


def shares(got, want, names, rtol):
    """Each leaf's max |got - want| over its limit; the largest and the
    five worst leaves."""
    import chip_smoke as cs

    top = max(float(w.abs().max()) for w in want)
    out = sorted(((float((g - w).abs().max())
                   / cs.leaf_limit(rtol, w, top), n)
                  for g, w, n in zip(got, want, names)), reverse=True)
    return {"max": out[0][0], "worst": [[round(s, 4), n] for s, n in out[:5]],
            "above_1": [[round(s, 4), n] for s, n in out if s > 1]}


SUMS = ("sum_heads", "sum_ff", "sum_vocab", "sum_tmix", "sum_cmix",
        "sum_rec", "sum_xattn")


def psum_f32(parts):
    """``sharding.psum`` with the partials added in float32 and the total
    rounded once to their dtype."""
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.to(total.device).float()
    return [total.to(p.device, p.dtype) for p in parts]


def compare(arch):
    import torch

    import chip_smoke as cs
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import transformer
    from repro_torch.training import SyntheticLM, init_state, make_train_step
    from repro_torch.training.tree import leaves, unflatten

    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    ocfg = cs.train_ocfg(1)
    base = init_state(cfg, ocfg, 0, device="cuda")
    if arch == cs.RWKV_ARCH:
        cs.draw_wb_lora(base)
    batch = SyntheticLM(cfg, BATCH, SEQ, seed=0, device="cuda").next()
    names = leaf_names(base["opt"]["m"])
    base = unflatten(base, [x.cpu() for x in leaves(base)])

    def copy():
        return unflatten(base, [x.to("cuda", copy=True)
                                for x in leaves(base)])

    def moments(state):
        return [sharding.gather_tensor(m) if isinstance(m, sharding.Sharded)
                else m for m in leaves(state["opt"]["m"])]

    def run(c, shape=None, nudge=0.0):
        state = copy()
        if nudge:
            e = state["params"]["embed"]
            g = torch.Generator(device=e.device).manual_seed(5)
            sign = torch.randint(0, 2, e.shape, generator=g,
                                 device=e.device) * 2 - 1
            e.mul_(1 + nudge * sign)
        b = {k: v.clone() for k, v in batch.items()}
        if shape is None:
            new, m = make_train_step(c, ocfg)(state, b)
        else:
            ctx = cs.shard_ctx(shape)
            state = specs.place_state(state, ctx)
            with sharding.use(ctx):
                new, m = make_train_step(c, ocfg)(state, b)
        out = [x.cpu() for x in moments(new)]
        loss = float(m["loss"])
        del new, state, m
        cs.free_device_memory()
        return out, loss

    one, l1 = run(cfg)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    f32, l32 = run(cfg32)
    rows = {"floor": dict(shares(one, f32, names, cs.SHARD_GRAD_RTOL),
                          loss_diff=l1 - l32)}
    got, loss = run(cfg32, cs.SHARD_MESH)
    rows["tp_f32"] = dict(shares(got, f32, names, cs.SHARD_GRAD_RTOL),
                          loss_diff=loss - l32)
    got, loss = run(cfg32, nudge=2 ** -22)
    rows["nudge_f32"] = dict(shares(got, f32, names, cs.SHARD_GRAD_RTOL),
                             loss_diff=loss - l32)
    del f32
    got, loss = run(cfg, nudge=2 ** -8)
    rows["nudge"] = dict(shares(got, one, names, cs.SHARD_GRAD_RTOL),
                         loss_diff=loss - l1)
    for key, shape in (("dp", (2, 1)), ("tp", cs.SHARD_MESH),
                       ("tp_f32_sums", cs.SHARD_MESH)):
        keep = {h: getattr(transformer, h) for h in SUMS}
        if key == "tp_f32_sums":
            for h in SUMS:
                setattr(transformer, h, psum_f32)
        try:
            got, loss = run(cfg, shape)
        finally:
            for h, f in keep.items():
                setattr(transformer, h, f)
        rows[key] = dict(shares(got, one, names, cs.SHARD_GRAD_RTOL),
                         loss_diff=loss - l1)
        del got
    del base, one
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args(argv)

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_tp_bf16_noise: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"card": smi, "layers": LAYERS, "batch": BATCH, "seq": SEQ}
    for arch in args.archs.split(","):
        rows = compare(arch)
        out[arch] = rows
        for key, r in rows.items():
            print(f"{arch} {key}: max {r['max']:.3f} of the limit, loss "
                  f"diff {r['loss_diff']:+.3e}; worst {r['worst']}",
                  flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
