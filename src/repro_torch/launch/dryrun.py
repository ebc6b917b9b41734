"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on the
``meta`` device (the port of ``repro.launch.dryrun``).

The reference proves its distribution config coherent without hardware
by lowering and compiling each cell's jitted step against
``ShapeDtypeStruct`` stand-ins on the (data 16, model 16) mesh and the
(pod 2, data 16, model 16) one. Here the same cells run the port's own
sharded steps on a mesh of ``meta`` devices
(``make_production_mesh(devices=["meta"] * n)``): shapes only, nothing
allocated, no kernel launched. The state is a shape-only init
(``init_model(device="meta")``) placed by the port's specs; the step runs
under ``analysis.cost.CostMode`` (FLOPs, bytes, each position's live
bytes) and ``sharding.accounting`` (the collectives), which stand in for
XLA's ``cost_analysis()``, ``memory_analysis()`` and the HLO scan:

  train    ``training.make_train_step(param_shardings=...)`` with the
           reference's ``_ACCUM_OVERRIDES`` and ``_OPT_OVERRIDES``
  prefill  ``transformer.forward_tp`` on each row of model shards and
           each shard's logits from its head columns
  decode   ``transformer.decode_step_tp`` on the cache placed by
           ``launch.specs.cache_shardings``

A record has the reference's keys; ``compile_s`` holds the trace's
seconds. It is a host tool by design and needs no card; its check
against the card is ``chip_smoke.py``'s phase [20]. The single
controller issues every position's ops, so a cell of 256 positions
issues 256 times the ops of one device: the big training cells take
long (``--cell-timeout`` ends a cell and records its time).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --sweep [--multi-pod] [--variants]
      [--jobs N] [--cell-timeout S]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback

import torch

from .. import sharding as shlib
from ..analysis.collectives import collective_bytes
from ..analysis.cost import CostMode
from ..configs import (SHAPES, applicable, cache_specs, get_config,
                       input_specs)
from ..configs.archs import ARCHS
from ..models import transformer
from ..models.common import tree_of
from ..tensorized import cpd_logits
from ..training import OptimizerConfig, init_state, make_train_step
from ..training.tree import leaves, unflatten
from . import specs as speclib
from .mesh import make_production_mesh

# HBM-driven overrides for the >=100B archs: bf16 optimizer moments.
_OPT_OVERRIDES = {
    "command-r-plus-104b": {"state_dtype": "bfloat16"},
    "qwen3-moe-235b-a22b": {"state_dtype": "bfloat16"},
}

# Microbatching (gradient accumulation) for cells whose activations exceed
# device memory at one shot.
_ACCUM_OVERRIDES = {
    ("command-r-plus-104b", "train_4k"): 8,
    ("qwen3-moe-235b-a22b", "train_4k"): 8,
    ("whisper-large-v3", "train_4k"): 2,
    ("recurrentgemma-9b", "train_4k"): 4,
}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def _opt_cfg(arch: str) -> OptimizerConfig:
    return OptimizerConfig(**_OPT_OVERRIDES.get(arch, {}))


def production_mesh(multi_pod: bool = False):
    """The reference's production mesh over ``meta`` devices."""
    return make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod
                                                    else 256))


def _batch_bytes(batch, specs, ctx) -> int:
    """A position's bytes of the batch laid out by ``specs``."""
    total = 0
    for k, t in batch.items():
        n = t.numel() * t.element_size()
        for e in specs[k]:
            for a in shlib._axes(e):
                n //= ctx.mesh.shape[a]
        total += n
    return total


def _prefill(cfg, ctx, params, batch) -> dict:
    """The prefill over the mesh: each row of model shards runs
    ``transformer.forward_tp`` on its dp slice with its working copies
    (the masters' dtype, cast at use), and each shard takes its logits
    from its head columns (every column where the head is not split).
    Returns position -> its logits."""
    flat = leaves(params)
    out = {}
    for row in shlib.model_rows(ctx.mesh, ctx.tp_axis):
        views = [transformer.unstack_layers(cfg, unflatten(
            params, [shlib.working_copy(s, pos, ctx) for s in flat]))
            for pos in row]
        kw = {k: [batch[k].at(pos) for pos in row]
              for k in ("embeds", "enc_embeds") if k in batch}
        hs = transformer.forward_tp(views, cfg, [batch["tokens"].at(pos)
                                                 for pos in row], **kw)
        for pos, v, h in zip(row, views, hs):
            out[pos] = (cpd_logits(v.embed_cpd, h) if cfg.cpd_embedding
                        else h @ transformer.head_matrix(v, cfg))
        del views, hs
    return out


def _meta_params(cfg):
    """A shape-only init of the params in the stage layout."""
    model = transformer.init_model(cfg, device="meta")
    return transformer.stack_layers(cfg, _detached(tree_of(model)))


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach()


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cfg=None, mesh=None, want_hlo: bool = False,
               cast_once: bool = False) -> dict:
    """Trace one cell; return its dry-run record (the reference's keys;
    ``compile_s`` is the trace's seconds; ``want_hlo`` adds ``hlo``, the
    collective records one a line, the trace's stand-in for the HLO
    text)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    ctx = shlib.make_ctx(mesh)
    ocfg = _opt_cfg(arch)
    accum = _ACCUM_OVERRIDES.get((arch, shape_name), 1)
    n_dev = mesh.size
    mode = CostMode(shlib.positions(mesh))
    t0 = time.monotonic()
    if shape.step == "train":
        state = init_state(cfg, ocfg, device="meta")
    else:
        params = _meta_params(cfg)
        if shape.step == "decode":   # what the step reads, as the
            params = transformer.decode_params(params)   # reference's jit
    batch = input_specs(cfg, shape)
    extra = 0
    with shlib.use(ctx), shlib.accounting(tracker=mode) as acct, mode:
        if shape.step == "train":
            st_sh = speclib.state_shardings(state, ctx)
            state = speclib.place_state(state, ctx, st_sh)
            extra = _batch_bytes(batch, speclib.batch_shardings(
                cfg, batch, ctx), ctx)
            step_fn = make_train_step(cfg, ocfg, grad_accum=accum,
                                      param_shardings=st_sh["params"],
                                      cast_params_once=cast_once)
            mode.mark_arguments()
            outputs = step_fn(state, batch)
            del state
        else:
            p_sh = shlib.param_sharding_tree(params, ctx)
            params = shlib.place(params, p_sh, ctx)
            batch = shlib.place(batch, speclib.batch_shardings(
                cfg, batch, ctx), ctx)
            if shape.step == "prefill":
                mode.mark_arguments()
                with torch.no_grad():
                    outputs = _prefill(cfg, ctx, params, batch)
            else:
                cache = cache_specs(cfg, shape)
                cache = shlib.place(cache, speclib.cache_shardings(
                    cache, ctx), ctx)
                mode.mark_arguments()
                with torch.no_grad():
                    outputs = transformer.decode_step_tp(
                        params, cache, cfg, batch["token"])
                del cache
            del params
        mem = mode.memory(outputs)
        del outputs
    trace_s = time.monotonic() - t0
    mem["argument"] += extra
    mem["peak"] += extra
    coll = collective_bytes(acct.events, n_dev)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": ("pod2x16x16" if multi_pod else "16x16") if mesh.size in (
            256, 512) else "x".join(str(s) for s in mesh.devices.shape),
        "n_devices": n_dev,
        "step": shape.step,
        "compile_s": round(trace_s, 2),
        "memory": {
            "argument_gb": mem["argument"] / 1e9,
            "output_gb": mem["output"] / 1e9,
            "temp_gb": mem["temp"] / 1e9,
            "alias_gb": mem["alias"] / 1e9,
            "peak_per_device_gb": mem["peak"] / 1e9,
        },
        "cost": {
            "flops_per_device": mode.flops / n_dev,
            "bytes_per_device": mode.bytes / n_dev,
            "transcendentals": mode.transcendentals / n_dev,
            "matmul_flops_per_device": mode.matmul_flops / n_dev,
        },
        "collectives_per_device": coll,
        "kernels": {k: {"calls": v[0], "bytes": v[1], "flops": v[2]}
                    for k, v in mode.kernels.items()},
        "ops": mode.ops,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "grad_accum": accum,
        "cast_once": cast_once,
    }
    if want_hlo:
        rec["hlo"] = "\n".join(
            f"{e.kind} result_bytes={e.result_bytes:.0f} group={e.group} "
            f"devices={e.devices}" for e in acct.events)
    return rec


# -------------------------------------------------------------- variants
def variant_configs(cfg):
    """Configs isolating each cycle of the layers: 'nonloop' (0 layers)
    + one single-cycle variant per stage (+ encoder). Returns [(tag, cfg,
    repetitions_in_full_model)]."""
    out = [("nonloop", dataclasses.replace(
        cfg, n_layers=0, n_enc_layers=0), 0)]
    for i, (pat, rep) in enumerate(cfg.stages()):
        out.append((f"stage{i}", dataclasses.replace(
            cfg, n_layers=len(pat), block_pattern=pat, n_enc_layers=0), rep))
    if cfg.n_enc_layers:
        out.append(("enc", dataclasses.replace(
            cfg, n_layers=0, n_enc_layers=1), cfg.n_enc_layers))
    return out


def lower_cell_with_variants(arch, shape_name, *, multi_pod=False,
                             cfg=None, cast_once=False, mesh=None):
    """The full trace plus one trace a variant (:func:`variant_configs`),
    the reference's record layout. The port's full trace already counts
    every layer, so ``analysis.roofline.corrected_costs`` of the record
    gives back its FLOPs."""
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    cfg = cfg or get_config(arch)
    rec = lower_cell(arch, shape_name, multi_pod=multi_pod, cfg=cfg,
                     mesh=mesh, cast_once=cast_once)
    rec["variants"] = {}
    for tag, vcfg, rep in variant_configs(cfg):
        vrec = lower_cell(arch, shape_name, multi_pod=multi_pod, cfg=vcfg,
                          mesh=mesh, cast_once=cast_once)
        rec["variants"][tag] = {
            "rep": rep,
            "params": vcfg.param_count(),
            "flops_per_device": vrec["cost"]["flops_per_device"],
            "bytes_per_device": vrec["cost"]["bytes_per_device"],
            "collectives_per_device": vrec["collectives_per_device"],
        }
    return rec


# ------------------------------------------------------------------ main
def _cell(args):
    arch, shape_name, multi_pod, variants = args
    fn = lower_cell_with_variants if variants else lower_cell
    rec = fn(arch, shape_name, multi_pod=multi_pod)
    rec["ok"] = True
    return rec


def _run_cell(arch, shape_name, multi_pod, variants, timeout):
    """One cell's record: in this process, or in a child ended after
    ``timeout`` seconds (then ``ok`` is false and the record says so)."""
    t0 = time.monotonic()
    try:
        if timeout is None:
            return _cell((arch, shape_name, multi_pod, variants))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(1) as pool:
            res = pool.apply_async(_cell, ((arch, shape_name, multi_pod,
                                            variants),))
            return res.get(timeout)
    except multiprocessing.TimeoutError:
        return {"arch": arch, "shape": shape_name, "ok": False,
                "error": f"time limit: not traced after "
                         f"{time.monotonic() - t0:.0f} s",
                "trace_s_at_limit": round(time.monotonic() - t0, 1)}
    except Exception as e:  # a failure here is a bug in the system
        return {"arch": arch, "shape": shape_name, "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()}


def run_sweep(multi_pod: bool, variants: bool, archs=None, shapes=None,
              out_dir=OUT_DIR, jobs: int = 1, timeout=None):
    """Trace every applicable cell (``jobs`` at a time, each ended after
    ``timeout`` seconds if given), one JSON record a cell in
    ``out_dir``; a cell with a record there is not traced again."""
    os.makedirs(out_dir, exist_ok=True)
    todo, results = [], []
    for arch in (archs or list(ARCHS)):
        for shape_name in (shapes or list(SHAPES)):
            if not applicable(arch, shape_name):
                print(f"SKIP  {arch} x {shape_name} (documented: "
                      f"full-attention arch, 500k decode)")
                continue
            tag = f"{arch}__{shape_name}__" + (
                "pod2x16x16" if multi_pod else "16x16")
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path):
                print(f"CACHED {tag}")
                with open(path) as f:
                    results.append(json.load(f))
                continue
            todo.append((tag, path, arch, shape_name))

    def finish(tag, path, rec):
        if rec.get("ok"):
            print(f"OK    {tag}: peak/dev "
                  f"{rec['memory']['peak_per_device_gb']:.2f} GB, "
                  f"{rec['compile_s']}s trace", flush=True)
        else:
            print(f"FAIL  {tag}: {rec['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        results.append(rec)

    if jobs <= 1:
        for tag, path, arch, shape_name in todo:
            finish(tag, path, _run_cell(arch, shape_name, multi_pod,
                                        variants, timeout))
        return results
    from concurrent.futures import ThreadPoolExecutor, as_completed
    order = {"train": 0, "prefill": 1, "decode": 2}   # the longest first
    todo.sort(key=lambda c: order[SHAPES[c[3]].step])
    with ThreadPoolExecutor(jobs) as ex:
        futs = {ex.submit(_run_cell, arch, shape_name, multi_pod, variants,
                          timeout): (tag, path)
                for tag, path, arch, shape_name in todo}
        for fut in as_completed(futs):
            finish(*futs[fut], fut.result())
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="also trace 0-layer/1-cycle variants for roofline")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once (each in a child process "
                         "when --cell-timeout is given)")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds after which a cell's trace is ended")
    args = ap.parse_args()
    if args.sweep:
        res = run_sweep(args.multi_pod, args.variants,
                        archs=[args.arch] if args.arch else None,
                        shapes=[args.shape] if args.shape else None,
                        out_dir=args.out, jobs=args.jobs,
                        timeout=args.cell_timeout)
        bad = [r for r in res if not r.get("ok")]
        print(f"\n{len(res) - len(bad)}/{len(res)} cells OK")
        raise SystemExit(1 if bad else 0)
    assert args.arch and args.shape, "--arch and --shape (or --sweep)"
    fn = lower_cell_with_variants if args.variants else lower_cell
    rec = fn(args.arch, args.shape, multi_pod=args.multi_pod)
    print(json.dumps({k: v for k, v in rec.items() if k != "hlo"}, indent=2))


if __name__ == "__main__":
    main()
