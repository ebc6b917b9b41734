"""Whether rwkv6-3b's sharded training step departs from the
single-device step by its math or by rounding: ``chip_smoke.py``
[17b]'s model (full width, its 4 layers, B 2 x S 4096, AdamW,
``remat="full"``, ``wb_lora`` drawn non-zero), one state and one batch,
its gradient leaves (AdamW's first moments) read from

  * ``one64`` / ``tp64``: the single-device step and the step over
    (data 2, model 2), both in float64 (every ``.float()`` of the model
    made a float64 cast and ``wkv6`` its plain step-by-step version in
    float64: no kernel runs, the gradients are exact but for float64
    rounding and one float32 rounding of each gradient element);
  * ``one32`` / ``tp32``: the same two in float32 (TF32 off), the
    kernels on the card;
  * ``jit32``: ``one32`` with a float32 rounding's worth of noise (each
    element times 1 + e 2^-23 in float64, e uniform on [-1, 1], and
    rounded back: it moves by at most one ulp) placed where the
    sharded step rounds differently: on the output of each time mix and
    channel mix (the sums over the model axis of the partials of
    ``w_out_t`` and ``wv_c``) and on the gradient leaving each one's
    input (the sum over the axis of each shard's input gradient);
  * ``one16`` / ``tp16`` / ``jit16``: the same in bf16, the noise
    e 2^-7 (again at most one bf16 ulp).

For each comparison, each leaf's max |got - want| as a share of
``chip_smoke.leaf_limit`` at ``SHARD_GRAD_RTOL`` (5e-2 of the reference
leaf's largest |element|), the largest, the five worst leaves, every
``u`` and ``mu`` leaf, and the loss difference. ``--smoke`` runs the
smoke config on ``--device cpu`` (a dry run of the script: 4 CPU
shards).

    python3 experiments/torch_tp_f64_witness.py [--smoke --device cpu]

Prints one line a comparison and, last, one JSON line of every number.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH, LAYERS, BATCH, SEQ, MESH = "rwkv6-3b", 4, 2, 4096, (2, 2)
WB_LORA_STD = 0.15            # chip_smoke.draw_wb_lora's
COMPARISONS = (("tp_f64", "tp64", "one64"),
               ("one_f32_vs_f64", "one32", "one64"),
               ("tp_f32_vs_f64", "tp32", "one64"),
               ("tp_f32", "tp32", "one32"),
               ("jitter_f32", "jit32", "one32"),
               ("tp_bf16", "tp16", "one16"),
               ("jitter_bf16", "jit16", "one16"))


def leaf_names(tree, pre=""):
    """Each tensor's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{pre}/{k}")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree)
                for n in leaf_names(x, f"{pre}[{i}]")]
    return [pre]


def shares(got, want, names):
    """Each leaf's max |got - want| over its limit: the largest, the five
    worst leaves and the ``u`` / ``mu`` leaves."""
    import chip_smoke as cs

    top = max(float(w.abs().max()) for w in want)
    out = [(float((g.double() - w.double()).abs().max())
            / cs.leaf_limit(cs.SHARD_GRAD_RTOL, w, top), n)
           for g, w, n in zip(got, want, names)]
    worst = sorted(out, reverse=True)
    return {"max": worst[0][0],
            "worst": [[s, n] for s, n in worst[:5]],
            "u_mu": [[s, n] for s, n in out
                     if n.rsplit("/", 1)[-1].split("[")[0] in ("u", "mu")]}


class Jitter:
    """An autograd identity that multiplies its input by 1 + e eps_f
    going forward and its gradient by 1 + e' eps_b going back (e, e'
    uniform on [-1, 1] from one generator; in float64, rounded back to
    the tensor's dtype)."""

    def __init__(self, seed, device):
        import torch

        self.gen = torch.Generator(device=device).manual_seed(seed)

    def noise(self, x, eps):
        import torch

        e = torch.rand(x.shape, generator=self.gen, device=x.device,
                       dtype=torch.float64) * 2 - 1
        return (x.double() * (1 + eps * e)).to(x.dtype)

    def __call__(self, x, eps_f, eps_b):
        import torch

        jit = self

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                return jit.noise(t, eps_f) if eps_f else t.clone()

            @staticmethod
            def backward(ctx, g):
                return jit.noise(g, eps_b)

        return Fn.apply(x)


@contextlib.contextmanager
def jittered(eps, device):
    """``rwkv.time_mix`` and ``rwkv.channel_mix`` (the single-device
    sublayers) with :class:`Jitter`'s noise of ``eps`` on their output
    (both ways) and on their input's gradient."""
    from repro_torch.models import rwkv

    jit = Jitter(27, device)
    saved = rwkv.time_mix, rwkv.channel_mix

    def wrap(fn):
        def run(p, x, cfg, *a, **k):
            return jit(fn(p, jit(x, 0.0, eps), cfg, *a, **k), eps, eps)
        return run

    rwkv.time_mix, rwkv.channel_mix = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        rwkv.time_mix, rwkv.channel_mix = saved


@contextlib.contextmanager
def float64():
    """Every ``Tensor.float()`` a float64 cast, and ``rwkv.wkv6`` its
    plain version in float64 with the plain backward: the model's float32
    islands (the decay, the WKV rows, the norms, the loss) in float64."""
    import torch

    from repro_torch.kernels import wkv6 as kw6
    from repro_torch.models import rwkv

    class F64(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return kw6.wkv6_scan(*args)

        @staticmethod
        def backward(ctx, dy):
            return kw6.wkv6_backward_plain(*ctx.saved_tensors, dy)

    def wkv6_f64(*args):
        return F64.apply(*(x.double().contiguous() for x in args))

    saved = torch.Tensor.float, rwkv.wkv6
    torch.Tensor.float = torch.Tensor.double
    rwkv.wkv6 = wkv6_f64
    try:
        yield
    finally:
        torch.Tensor.float, rwkv.wkv6 = saved


def compare(cfg, device):
    import torch

    from repro_torch import sharding
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)
    from repro_torch.training.tree import leaves, unflatten

    ocfg = OptimizerConfig(total_steps=1, warmup_steps=1)
    base = init_state(cfg, ocfg, 0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    for w in base["params"]["stage0"]["b0"]["wb_lora"]:
        w.normal_(0.0, WB_LORA_STD, generator=g)
    batch = SyntheticLM(cfg, BATCH, SEQ, seed=0, device=device).next()
    names = leaf_names(base["opt"]["m"])
    base = unflatten(base, [x.cpu() for x in leaves(base)])
    n = MESH[0] * MESH[1]
    ctx = sharding.make_ctx(make_mesh(MESH, ("data", "model"),
                                      devices=[device] * n))

    def run(dtype, sharded=False, scope=contextlib.nullcontext()):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        state = unflatten(base, [x.to(device, copy=True)
                                 for x in leaves(base)])
        b = {k: v.clone() for k, v in batch.items()}
        with scope:
            if sharded:
                state = specs.place_state(state, ctx)
                with sharding.use(ctx):
                    new, m = make_train_step(c, ocfg)(state, b)
            else:
                new, m = make_train_step(c, ocfg)(state, b)
        got = [(sharding.gather_tensor(x) if isinstance(x, sharding.Sharded)
                else x).cpu() for x in leaves(new["opt"]["m"])]
        loss = float(m["loss"])
        del new, state, m
        if device != "cpu":
            torch.cuda.empty_cache()
        return got, loss

    runs = {"one64": run("float64", scope=float64()),
            "tp64": run("float64", True, float64()),
            "one32": run("float32"), "tp32": run("float32", True),
            "jit32": run("float32", scope=jittered(2.0 ** -23, device)),
            "one16": run("bfloat16"), "tp16": run("bfloat16", True),
            "jit16": run("bfloat16", scope=jittered(2.0 ** -7, device))}
    rows = {}
    for key, got, want in COMPARISONS:
        (a, la), (b, lb) = runs[got], runs[want]
        rows[key] = dict(shares(a, b, names), loss_diff=la - lb,
                         loss=la)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a dry run on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, smoke

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_tp_f64_witness: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global SEQ, LAYERS
    if args.smoke:
        cfg = smoke(ARCH)
        SEQ, LAYERS = 64, cfg.n_layers
    else:
        cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    smi = "" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = compare(cfg, args.device)
    out = {"card": smi, "arch": cfg.name, "layers": LAYERS, "batch": BATCH,
           "seq": SEQ, "mesh": list(MESH), **rows}
    for key, r in rows.items():
        print(f"{key}: max {r['max']:.4g} of the limit, loss diff "
              f"{r['loss_diff']:+.3e}; worst "
              + ", ".join(f"{n} {s:.4g}" for s, n in r["worst"]),
              flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
