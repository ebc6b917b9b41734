"""The port's dry-run and roofline tools (``repro_torch.configs``
``input_specs`` / ``cache_specs``, ``launch.specs.cache_shardings``,
``analysis.cost``, ``analysis.collectives``, ``analysis.roofline``,
``analysis.report``, ``launch.dryrun``) against the JAX reference, on
the CPU.

- The stand-ins of every cell of ``cells(ARCHS)`` at full width equal
  the reference's ``input_specs`` and ``jax.eval_shape`` of its cache in
  shape and dtype (the port's per-layer cache leaves stacked to the
  reference's (rep, ...) layout; a position counter, a Python int here,
  stands for the reference's int32 scalar).
- ``cache_shardings`` equals the reference's over a
  ``jax.sharding.AbstractMesh`` for every decode cell on (16, 16) and
  (2, 16, 16).
- ``analyze`` and ``corrected_costs`` (the reference's ``HW`` passed in)
  and the three tables equal the reference's exactly on the same records,
  variants included; ``collective_bytes`` equals the reference's HLO scan
  of the same collectives.
- The cost counter's FLOPs, bytes and peak equal hand-worked values on
  small programs (``wkv6`` and ``lru_scan`` on ``meta`` charged their
  formulas).
- ``lower_cell`` on smoke cells over a (2, 4) mesh of ``meta`` devices:
  FLOPs and collective bytes > 0 (as the reference's
  ``test_dryrun_entry_small_mesh``); the all-gather bytes of a dense
  train cell equal the fsdp gathers worked out from
  ``param_sharding_tree``; the full FLOPs equal nonloop + sum rep x
  (variant - nonloop) exactly; ``memory.argument_gb`` equals the
  reference's ``memory_analysis().argument_size_in_bytes`` (one
  ``python -c`` child with 8 forced host devices) but for the host-side
  counters: the train state's two int32 step counters (8 bytes) and a
  decode cache's position counters (4 bytes each), Python ints here.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.analysis import hlo as jhlo
from repro.analysis import report as jreport
from repro.analysis import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch import configs, sharding
from repro_torch.analysis import collectives, report, roofline
from repro_torch.analysis.cost import CostMode
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import wkv6 as kw6
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer

REPO = Path(__file__).resolve().parents[1]
CELLS = configs.cells(configs.ARCHS)
DECODE = [c for c in CELLS if configs.SHAPES[c[1]].step == "decode"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny CPU tensors and meta traces: one intra-op thread, so that the
    other test workers keep the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype_name(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


# --------------------------------------------------------------------------
# input_specs / cache_specs / cache_shardings
# --------------------------------------------------------------------------
def _stack(cfg, cache) -> dict:
    """The port's per-layer cache in the reference's stage layout: each
    leaf (shape, dtype) with the stage's repetitions in front."""
    out, i = {}, 0
    for s, (pat, rep) in enumerate(cfg.stages()):
        stage = {}
        for j in range(len(pat)):
            cyc = [cache[i + c * len(pat) + j] for c in range(rep)]
            stage[f"b{j}"] = _stack_leaves(cyc)
        out[f"stage{s}"] = stage
        i += rep * len(pat)
    return out


def _stack_leaves(cyc, name=""):
    """A leaf's stacked (shape, dtype). A cache position (``len``) is a
    0-d int64 tensor in the port, whose index ops take int64 slots, and
    an int32 array in the reference: it stacks as the reference's."""
    first = cyc[0]
    if isinstance(first, dict):
        return {k: _stack_leaves([c[k] for c in cyc], k) for k in first}
    if isinstance(first, torch.Tensor):
        assert all(c.shape == first.shape for c in cyc)
        if name == "len":
            assert first.shape == () and first.dtype == torch.int64
            return ((len(cyc),), "int32")
        return ((len(cyc),) + tuple(first.shape), _dtype_name(first.dtype))
    assert isinstance(first, int)
    return ((len(cyc),), "int32")


def _shapes(jtree):
    if isinstance(jtree, dict):
        return {k: _shapes(v) for k, v in jtree.items()}
    return (tuple(jtree.shape), _dtype_name(jtree.dtype))


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_and_cache_specs_match_reference(arch, shape_name):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape, jshape = configs.SHAPES[shape_name], jconfigs.SHAPES[shape_name]
    got = configs.input_specs(cfg, shape)
    want = jconfigs.input_specs(jcfg, jshape)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert (tuple(got[k].shape), _dtype_name(got[k].dtype)) == \
            _shapes(want[k]), k
    if shape.step == "decode":
        cache = configs.cache_specs(cfg, shape)
        assert all(t.device.type == "meta" for c in cache
                   for t in _tensor_leaves(c))
        assert _stack(cfg, cache) == _shapes(jconfigs.cache_specs(jcfg,
                                                                  jshape))


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _norm(spec) -> tuple:
    spec = list(spec or ())
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", DECODE)
def test_cache_shardings_match_reference(arch, shape_name, multi_pod):
    cfg, shape = configs.get_config(arch), configs.SHAPES[shape_name]
    jmesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    jctx = jsh.make_ctx(AbstractMesh(jmesh_shape, axes))
    tctx = sharding.make_ctx(make_production_mesh(
        multi_pod=multi_pod, devices=["meta"] * math.prod(jmesh_shape)))
    jspec = jax.tree.map(lambda s: s.spec, jspecs.cache_shardings(
        jconfigs.cache_specs(jconfigs.get_config(arch),
                             jconfigs.SHAPES[shape_name]), jctx))
    got = specs.cache_shardings(configs.cache_specs(cfg, shape), tctx)
    stacked = _stack_specs(cfg, got)
    n = 0
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    for path, want in jax.tree_util.tree_leaves_with_path(jspec,
                                                          is_leaf=is_spec):
        keys = [p.key for p in path]
        mine = stacked
        for k in keys:
            mine = mine[k]
        assert want[0] is None
        for s in mine:
            assert _norm(s) == _norm(tuple(want)[1:]), (keys, s, want)
            n += 1
    assert n == sum(len(_spec_list(c)) for c in got)


def _spec_list(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _spec_list(v)]
    return [tree]


def _stack_specs(cfg, specs_):
    out, i = {}, 0
    for s, (pat, rep) in enumerate(cfg.stages()):
        out[f"stage{s}"] = {
            f"b{j}": _zip([specs_[i + c * len(pat) + j] for c in range(rep)])
            for j in range(len(pat))}
        i += rep * len(pat)
    return out


def _zip(cyc):
    if isinstance(cyc[0], dict):
        return {k: _zip([c[k] for c in cyc]) for k in cyc[0]}
    return list(cyc)


# --------------------------------------------------------------------------
# roofline, report, collectives
# --------------------------------------------------------------------------
def _records(seed=0):
    """Synthetic dry-run records of every cell (variants on some, one
    failed cell, one multi-pod record)."""
    rng = np.random.default_rng(seed)
    recs = []
    for i, (arch, shape_name) in enumerate(CELLS):
        cfg = configs.get_config(arch)
        rec = {
            "arch": arch, "shape": shape_name, "mesh": "16x16",
            "n_devices": 256, "step": configs.SHAPES[shape_name].step,
            "compile_s": round(float(rng.uniform(1, 300)), 2), "ok": True,
            "memory": {k: float(rng.uniform(0.1, 60)) for k in (
                "argument_gb", "output_gb", "temp_gb", "alias_gb",
                "peak_per_device_gb")},
            "cost": {"flops_per_device": float(rng.uniform(1e11, 1e15)),
                     "bytes_per_device": float(rng.uniform(1e9, 1e12)),
                     "transcendentals": 0.0},
            "collectives_per_device": {"total": float(rng.uniform(1e6,
                                                                  1e11))},
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "grad_accum": 1, "cast_once": False,
        }
        if i % 3 == 0:
            nl = {"flops_per_device": float(rng.uniform(1e9, 1e11)),
                  "bytes_per_device": float(rng.uniform(1e8, 1e10)),
                  "collectives_per_device": {"total": float(
                      rng.uniform(1e5, 1e8))}, "rep": 0, "params": 10 ** 6}
            rec["variants"] = {"nonloop": nl}
            for tag, rep in (("stage0", 7), ("stage1", 1), ("enc", 0)):
                rec["variants"][tag] = {
                    "flops_per_device": nl["flops_per_device"] * float(
                        rng.uniform(0.5, 3)),
                    "bytes_per_device": nl["bytes_per_device"] * float(
                        rng.uniform(0.5, 3)),
                    "collectives_per_device": {"total": float(
                        rng.uniform(1e5, 1e9))},
                    "rep": rep, "params": int(rng.integers(1e5, 1e9))}
        recs.append(rec)
    recs.append({"arch": "olmo-1b", "shape": "train_4k", "ok": False,
                 "error": "x"})
    recs.append({**recs[1], "mesh": "pod2x16x16", "n_devices": 512})
    return recs


@pytest.mark.parametrize("opt_bf16", [False, True])
def test_analyze_and_corrected_costs_match_reference(opt_bf16):
    for rec in _records():
        if not rec.get("ok"):
            continue
        assert roofline.corrected_costs(rec, opt_bf16) == \
            jroof.corrected_costs(rec, opt_bf16)
        assert roofline.analyze(rec, hw=jroof.HW, opt_bf16=opt_bf16) \
            .as_dict() == jroof.analyze(rec, hw=jroof.HW,
                                        opt_bf16=opt_bf16).as_dict()
        assert roofline.model_flops(rec) == jroof.model_flops(rec)


def test_hw_is_the_h100_datasheet():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 50e9}
    assert roofline.NVLINK_BW == 450e9


@pytest.mark.parametrize("table", ["dryrun", "roofline", "hillclimb"])
def test_report_tables_match_reference(table, tmp_path, monkeypatch):
    """The three tables on the same records (the port's ``analyze`` given
    the reference's ``HW``, so that both render the same numbers)."""
    monkeypatch.setattr(report, "analyze",
                        functools.partial(roofline.analyze, hw=jroof.HW))
    recs = _records()
    dry, hc = tmp_path / "dry", tmp_path / "hc"
    dry.mkdir()
    hc.mkdir()
    for i, r in enumerate(recs):
        (dry / f"{i:03d}.json").write_text(json.dumps(r))
    for i, r in enumerate(_records(1)[:6]):
        if r.get("ok"):
            r["opt_tag"] = f"opt{i % 2}"
            (hc / f"{i:03d}.json").write_text(json.dumps(r))
    assert report.load_records(str(dry)) == jreport.load_records(str(dry))
    if table == "dryrun":
        got, want = report.dryrun_table(recs), jreport.dryrun_table(recs)
    elif table == "roofline":
        got, want = report.roofline_table(recs), jreport.roofline_table(recs)
    else:
        got = report.hillclimb_table(str(dry), str(hc))
        want = jreport.hillclimb_table(str(dry), str(hc))
    assert got == want
    assert got.count("\n") >= 3


_KINDS = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute"]


def test_collective_bytes_match_reference_hlo_scan():
    """The ring formulas on recorded collectives equal the reference's
    scan of HLO lines of the same collectives (every device takes part)."""
    rng = np.random.default_rng(3)
    events, lines = [], []
    for i in range(40):
        kind = _KINDS[i % len(_KINDS)]
        n = int(rng.choice([2, 4, 8, 16]))
        elems = int(rng.integers(1, 5000)) * n
        events.append(sharding.CollectiveEvent(kind, 4 * elems, n, 256))
        lines.append(f"  %c{i} = f32[{elems}]{{0}} {kind}(f32[{elems}]{{0}} "
                     f"%p{i}), replica_groups=[{256 // n},{n}]<=[256]")
    got = collectives.collective_bytes(events, 256)
    want = jhlo.collective_bytes("\n".join(lines))
    assert got["counts"] == want["counts"]
    assert set(got) == set(want)
    for k in want:
        if k != "counts":
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


# --------------------------------------------------------------------------
# the cost counter
# --------------------------------------------------------------------------
def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _case_matmul():
    a, b = _meta(64, 128), _meta(128, 32)
    with CostMode() as m:
        c = a @ b
        d = torch.relu(c)
    out = 64 * 32 * 4
    return m, {"flops": 2 * 64 * 128 * 32,
               "bytes": (64 * 128 + 128 * 32) * 4 + out + 2 * out,
               "peak": 2 * out, "kernels": {}}, (c, d)


def _case_views():
    x = _meta(8, 16)
    with CostMode() as m:
        y = x.view(16, 8).t().detach()[2:].expand(3, 6, 16)
    return m, {"flops": 0, "bytes": 0, "peak": 0, "kernels": {}}, y


def _case_bmm_frees():
    a, b = _meta(4, 8, 16, dtype=torch.bfloat16), _meta(4, 16, 2,
                                                        dtype=torch.bfloat16)
    with CostMode() as m:
        c = torch.bmm(a, b)            # 64 bf16: 128 B
        big = torch.empty(1000)        # an allocation: 4000 B, no bytes
        del big
        e = c.float()                  # 256 B
    return m, {"flops": 2 * 4 * 8 * 16 * 2,
               "bytes": (4 * 8 * 16 + 4 * 16 * 2 + 4 * 8 * 2) * 2
               + 128 + 256,
               "peak": 128 + 4000, "kernels": {}}, (c, e)


def _case_wkv6():
    bh, t = 6, 40
    r, k, w, v = (_meta(bh, t, 64) for _ in range(4))
    u = _meta(bh, 64)
    with CostMode() as m:
        y = kw6.wkv6(r, k, w, v, u)
    fb, ff = kw6.wkv6_cost(bh, t, 64, 64)
    return m, {"flops": ff, "bytes": fb, "peak": bh * t * 64 * 4,
               "kernels": {"wkv6": [1, fb, ff]}}, y


def _case_wkv6_grad():
    """Through ``WKV6Fn``: the forward and the backward kernel charged
    once each (the backward's scratch of saved states in its peak)."""
    bh, t = 6, 40
    r, k, w, v = (_meta(bh, t, 64, grad=True) for _ in range(4))
    u = _meta(bh, 64, grad=True)
    with CostMode() as m:
        y = kw6.wkv6(r, k, w, v, u)
        g = torch.autograd.grad(y.sum(), [r, k, w, v, u])
    fb, ff = kw6.wkv6_cost(bh, t, 64, 64)
    bb, bf = kw6.wkv6_bwd_cost(bh, t, 64, 64)
    states = bh * -(-t // kw6.BWD_CHUNK) * 64 * 64 * 4
    return m, {"flops": ff + bf, "min_bytes": fb + bb,
               "min_peak": states + 5 * bh * t * 64 * 4,
               "kernels": {"wkv6": [1, fb, ff], "wkv6_bwd": [1, bb, bf]}}, \
        (y, g)


def _case_lru_scan():
    a, x = _meta(2, 50, 24), _meta(2, 50, 24)
    with CostMode() as m:
        h = klru.lru_scan(a, x)
    nb, nf = klru.lru_scan_cost(2, 50, 24)
    return m, {"flops": nf, "bytes": nb, "peak": 2 * 50 * 24 * 4,
               "kernels": {"lru_scan": [1, nb, nf]}}, h


def _case_positions():
    """Owners: a tensor placed over (model 2) is half on each position;
    each position's result of a psum is its own copy. Inside the sum
    every position also holds the running total and the copy in flight
    (a ring all-reduce's buffers): the peak is the piece, the product,
    those two and its own result."""
    mesh = make_mesh((1, 2), ("data", "model"), ["meta"] * 2)
    m = CostMode(sharding.positions(mesh))
    x = _meta(4, 8)
    with sharding.accounting(tracker=m) as acct, m:
        s = sharding.place_tensor(x, (None, "model"), mesh)
        live0 = list(m.live)
        tot = sharding.psum([s.at((0, 0)) * 2, s.at((0, 1)) * 2])
    assert live0 == [64, 64]
    assert acct.events == [sharding.CollectiveEvent("all-reduce", 64, 2, 2)]
    return m, {"live": [64 + 64, 64 + 64], "peak": 5 * 64,
               "kernels": {}}, (s, tot)


def _case_fsdp_gather():
    mesh = make_mesh((2, 1), ("data", "model"), ["meta"] * 2)
    ctx = sharding.make_ctx(mesh)
    m = CostMode(sharding.positions(mesh))
    with sharding.accounting(tracker=m) as acct, m:
        s = sharding.place_tensor(_meta(8, 4), ("data", None), mesh)
        w = sharding.working_copy(s, (0, 0), ctx)
    assert acct.events == [sharding.CollectiveEvent("all-gather", 128, 2, 1)]
    return m, {"live": [64 + 128, 64], "kernels": {}}, (s, w)


CASES = {"matmul": _case_matmul, "views": _case_views,
         "bmm_frees": _case_bmm_frees, "wkv6": _case_wkv6,
         "wkv6_grad": _case_wkv6_grad,
         "lru_scan": _case_lru_scan, "positions": _case_positions,
         "fsdp_gather": _case_fsdp_gather}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cost_counter_hand_worked(case):
    m, want, keep = CASES[case]()
    got = {"flops": m.flops, "bytes": m.bytes, "kernels": m.kernels,
           "live": m.live, "peak": max(m.peak)}
    for key, val in want.items():
        if key.startswith("min_"):
            assert got[key[4:]] >= val, (key, got[key[4:]], val)
        else:
            assert got[key] == val, (key, got[key], val)
    del keep


def test_cost_counter_flops_equal_flop_counter_mode():
    """The matmul FLOPs of a smoke forward and a train step's backward on
    ``meta`` equal ``FlopCounterMode``'s count of the same calls on the
    CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = dataclasses.replace(configs.smoke("qwen2.5-3b"),
                              compute_dtype="float32")
    counts = []
    for dev in ("meta", "cpu"):
        model = transformer.init_model(cfg, 0, device=dev)
        for p in model.parameters():
            p.requires_grad_(True)
        tok = torch.zeros((2, 64), dtype=torch.int64, device=dev)
        mode = CostMode() if dev == "meta" else FlopCounterMode(display=False)
        with mode:
            out = transformer.forward(model, cfg, tok)
            loss = out.float().square().mean()
            torch.autograd.grad(loss, [p for p in model.parameters()
                                       if p.dim() >= 2][:3],
                                allow_unused=True)
        counts.append(mode.matmul_flops if dev == "meta"
                      else mode.get_total_flops())
    assert counts[0] == counts[1] > 0


# --------------------------------------------------------------------------
# lower_cell on smoke cells
# --------------------------------------------------------------------------
def _smoke(arch):
    return dataclasses.replace(configs.smoke(arch), remat="full")


def _mesh(shape=(2, 4)):
    return make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))


@pytest.fixture(scope="module")
def train_rec():
    return dryrun.lower_cell("tinyllama-1.1b", "train_4k",
                             cfg=_smoke("tinyllama-1.1b"), mesh=_mesh())


def test_lower_cell_small_mesh(train_rec):
    assert train_rec["cost"]["flops_per_device"] > 0
    assert train_rec["collectives_per_device"]["total"] > 0
    assert train_rec["n_devices"] == 8 and train_rec["step"] == "train"
    assert train_rec["memory"]["peak_per_device_gb"] >= \
        train_rec["memory"]["argument_gb"] > 0


def test_train_all_gather_bytes_are_the_fsdp_gathers(train_rec):
    """Each position gathers every fsdp-split leaf's model-axis slice
    whole over the dp axes once a step (float32 masters): R (n-1)/n a
    leaf."""
    cfg = _smoke("tinyllama-1.1b")
    ctx = sharding.make_ctx(_mesh())
    tree = dryrun._meta_params(cfg)
    want = 0.0
    for t, spec in zip(_leaves(tree), _leaves(
            sharding.param_sharding_tree(tree, ctx))):
        tp = dp = 1
        for e in spec:
            for a in sharding._axes(e):
                if a == "model":
                    tp *= ctx.mesh.shape[a]
                else:
                    dp *= ctx.mesh.shape[a]
        if dp > 1:
            want += t.numel() * 4 / tp * (dp - 1) / dp
    assert want > 0
    assert train_rec["collectives_per_device"]["all-gather"] == \
        pytest.approx(want, rel=1e-12)


def _leaves(tree):
    """Tensors (or specs: tuples) in order; a list is a stacked leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,shape_name", [
    ("tinyllama-1.1b", "train_4k"), ("recurrentgemma-9b", "decode_32k"),
    ("rwkv6-3b", "prefill_32k")])
def test_full_flops_equal_the_variants_sum(arch, shape_name):
    """The port counts every layer, so the reference's scan correction is
    an identity on FLOPs: full = nonloop + sum rep x (variant -
    nonloop), exactly."""
    rec = dryrun.lower_cell_with_variants(arch, shape_name,
                                          cfg=_smoke(arch),
                                          mesh=_mesh((2, 2)))
    v = rec["variants"]
    nl = v["nonloop"]["flops_per_device"]
    total = nl + sum(x["rep"] * (x["flops_per_device"] - nl)
                     for k, x in v.items() if k != "nonloop")
    assert rec["cost"]["flops_per_device"] == total > 0
    assert roofline.corrected_costs(rec)[0] == total
    if arch == "rwkv6-3b":
        assert rec["kernels"]["wkv6"]["calls"] == 4 * _smoke(arch).n_layers


_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
from repro.configs import smoke
from repro.launch.dryrun import lower_cell
from repro.launch.mesh import make_mesh

mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch, shape in json.loads(sys.argv[2]):
    cfg = dataclasses.replace(smoke(arch), remat="full")
    rec = lower_cell(arch, shape, cfg=cfg, mesh=mesh)
    out[arch + "|" + shape] = rec["memory"]["argument_gb"]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""

ARG_CELLS = [("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
             ("tinyllama-1.1b", "decode_32k"), ("rwkv6-3b", "decode_32k"),
             ("whisper-large-v3", "decode_32k")]


@pytest.fixture(scope="module")
def ref_arguments(tmp_path_factory):
    path = tmp_path_factory.mktemp("refdry") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_CHAOS", None)
    env.pop("REPRO_LADDER", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        json.dumps(ARG_CELLS)], env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(path.read_text())


def _host_counters(arch, shape_name) -> int:
    """Bytes the reference keeps on the device that the port keeps on the
    host (the train state's step counters, a decode cache's ``kv_len``),
    less the 4 bytes more of each cache position (``len``), an int64
    tensor in the port and an int32 array in the reference."""
    step = configs.SHAPES[shape_name].step
    if step == "train":
        return 8
    if step == "decode":
        cfg = _smoke(arch)
        cache = configs.cache_specs(cfg, configs.SHAPES[shape_name])
        leaves = [v for c in cache for v in _flat(c)]
        return 4 * sum(isinstance(v, int) for v in leaves) - 4 * sum(
            isinstance(v, torch.Tensor) and v.dim() == 0 for v in leaves)
    return 0


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("arch,shape_name", ARG_CELLS)
def test_argument_bytes_match_reference(ref_arguments, arch, shape_name):
    rec = dryrun.lower_cell(arch, shape_name, cfg=_smoke(arch),
                            mesh=_mesh())
    got = round(rec["memory"]["argument_gb"] * 1e9)
    want = round(ref_arguments[arch + "|" + shape_name] * 1e9)
    assert want - got == _host_counters(arch, shape_name), (got, want)
