#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds its CUDA kernels from this checkout, holds each against its
plain PyTorch version, drives the main path through the user entry points
(``build_flycoo`` -> ``engine.init`` -> ``engine.all_modes`` -> ``cp_als``)
at the paper's nell1 tensor (scale 0.1, rank 32) and the 5-mode twitch
tensor (scale 0.01), checks the outputs against the COO oracle
``mttkrp_ref``, and times the kernels at the main path's shapes.

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Every phase raises on failure. The second-to-last line of standard output
is the kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
Per-mode details go to ``chiprun_out/chip_smoke.json``.

Tolerances (float32 throughout, TF32 off). An output element is a sum of
n float32 terms ``val * prod F`` (n = the nonzeros of its row), summed in
an order that differs between the kernel (shared-memory atomics) and
``index_add_``. With ``s`` the sum of the terms' absolute values (the same
function on absolute inputs) and ``u = 2**-24``:
  * MTTKRP outputs against ``mttkrp_ref`` computed in float64 from the
    same inputs: ``LAMBDA * (sqrt(n) + N) * u * s`` per element, the
    probabilistic bound of float32 summation of n terms in any order
    (Higham and Mary, 2019) plus N - 1 roundings per product, N the mode
    count. At n = 1e6 that is 1.2e-4 of ``s``.
  * ``out_rel`` of a kernel against its plain version, both float32:
    twice that, one share for each side.
  * The limit is held against itself: the gather kernel run with 2% of
    the hottest row's terms marked as pads (a kernel that skips work) must
    fail it.
  * remap outputs and the layout after a full rotation: bitwise.
  * CPD fits, cuda_fused against the torch backend from the same initial
    factors: ``FIT_ATOL`` (the per-mode differences above, through three
    sweeps of R x R solves).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

U = 2.0 ** -24                 # float32 unit roundoff
LAMBDA = 2.0
GATE_DROP = 0.02               # share of the hottest row's terms dropped
FIT_ATOL = 1e-5
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
RANK = 32
SOURCE = "src/repro_torch/kernels/csrc/mttkrp_compact.cu"
REPLACES = {
    "mttkrp_fused_remap_compact": "src/repro/kernels/mttkrp_kernel.py:583",
    "mttkrp_fused_gather_compact": "src/repro/kernels/mttkrp_kernel.py:466",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# Helpers.
# --------------------------------------------------------------------------
def limit(abs_sum, terms, nmodes, sides=1):
    """Per-element limit on a float32 sum of ``terms`` products whose
    absolute values sum to ``abs_sum`` (see the module docstring)."""
    return sides * LAMBDA * (terms.double().sqrt() + nmodes) * U * abs_sum


def close_to(name, got, want, lim):
    """|got - want| <= lim elementwise; returns (max error, max error as
    a share of its element's limit)."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.double() - want.double()).abs()
    bad = err > lim
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off; max err "
            f"{float(err.max()):.3e}, max |want| {float(want.abs().max()):.3e}")
    if not err.numel():
        return 0.0, 0.0
    share = torch.where(lim > 0, err / lim, 0.0)
    return float(err.max()), float(share.max())


def exact(name, got, want):
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


def kernel_args(factors, d, state):
    plan = state.statics[d]
    inputs = tuple(f for w, f in enumerate(factors) if w != d)
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p)
    return inputs, kw


def run_remap(kmt, L, inputs, kw, smax, nxt, plain=False):
    if plain:
        return kmt.mttkrp_fused_remap_compact_plain(
            L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"], L["bpart"],
            L["uidx"], L["nuniq"], inputs, smax=smax, next_mode=nxt, **kw)
    return kmt.mttkrp_fused_remap_compact(
        L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"], L["bpart"],
        L["uidx"], L["nuniq"], inputs, smax=smax, next_mode=nxt,
        pstart=L["pstart"], **kw)


def run_gather(kmt, L, inputs, kw, plain=False):
    if plain:
        return kmt.mttkrp_fused_gather_compact_plain(
            L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"],
            L["nuniq"], inputs, **kw)
    return kmt.mttkrp_fused_gather_compact(
        L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"], L["nuniq"],
        inputs, pstart=L["pstart"], **kw)


def row_stats(kmt, L, inputs, kw):
    """The plain gather on absolute inputs and on ones: per ``out_rel``
    element, the absolute sum of its terms and their count."""
    import torch

    abs_sum = run_gather(kmt, dict(L, val=L["val"].abs()),
                         tuple(f.abs() for f in inputs), kw, plain=True)
    terms = run_gather(kmt, dict(L, val=torch.ones_like(L["val"])),
                       tuple(torch.ones_like(f) for f in inputs), kw,
                       plain=True)
    return abs_sum, terms


def check_mode_kernels(kmt, state, L, factors, d, tag):
    """Both kernels against their plain versions on mode ``d``'s layout
    ``L``; returns each kernel's max |kernel - plain| on ``out_rel``."""
    inputs, kw = kernel_args(factors, d, state)
    nxt = (d + 1) % state.nmodes
    got = run_remap(kmt, L, inputs, kw, state.smax, nxt)
    want = run_remap(kmt, L, inputs, kw, state.smax, nxt, plain=True)
    lim = limit(*row_stats(kmt, L, inputs, kw), state.nmodes, sides=2)
    errs = {"mttkrp_fused_remap_compact": close_to(
        f"{tag} mode {d} remap out_rel", got[0], want[0], lim)[0]}
    for name, g, w in zip(("nval", "nidx", "nalpha"), got[1:], want[1:]):
        exact(f"{tag} mode {d} {name}", g, w)
    gout = run_gather(kmt, L, inputs, kw)
    errs["mttkrp_fused_gather_compact"] = close_to(
        f"{tag} mode {d} gather out_rel", gout, want[0], lim)[0]
    return errs


def gate_check(kmt, state, factors):
    """The kernel-vs-plain limit must reject a kernel that skips work: the
    gather kernel run with the last ``GATE_DROP`` of the hottest row's
    slots marked as pads. Returns what the check reads on that row."""
    import torch
    from repro_torch.engine.api import mode_layout

    d = state.mode
    plan = state.statics[d]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    inputs, kw = kernel_args(factors, d, state)
    abs_sum, terms = row_stats(kmt, L, inputs, kw)
    hot = int(terms[:, 0].argmax())
    slot = torch.arange(L["val"].shape[0], device=L["val"].device)
    gid = (L["bpart"].index_select(0, slot // plan.block_p).long()
           * plan.rows_pp + L["lrow"].long())
    hits = torch.nonzero((L["lrow"] >= 0) & (gid == hot)).squeeze(1)
    k = int(hits.numel() * GATE_DROP)
    lrow = L["lrow"].clone()
    lrow[hits[hits.numel() - k:]] = -1
    got = run_gather(kmt, dict(L, lrow=lrow), inputs, kw)[hot]
    want = run_gather(kmt, L, inputs, kw, plain=True)[hot]
    lim = limit(abs_sum[hot], terms[hot], state.nmodes, sides=2)
    err = (got.double() - want.double()).abs()
    out = {"mode": d, "row_terms": hits.numel(), "dropped": k,
           "elements_caught": int((err > lim).sum()), "elements": err.numel(),
           "max_err_over_limit": float((err / lim).max()),
           "max_err_over_abs_sum": float((err / abs_sum[hot]).max())}
    if out["elements_caught"] == 0:
        raise AssertionError(f"the limit misses a kernel that drops {k} of "
                             f"the hottest row's {hits.numel()} terms: {out}")
    return out


def mttkrp_oracle(indices, values, factors, dims):
    """Per mode: ``mttkrp_ref`` in float64 from the same float32 inputs,
    and the per-element limit of a float32 result against it."""
    import torch
    from repro_torch.core import mttkrp_ref

    f64 = [f.double() for f in factors]
    abs64 = [f.abs() for f in f64]
    out = []
    for d, dim in enumerate(dims):
        terms = torch.bincount(indices[:, d], minlength=dim)[:, None]
        out.append((mttkrp_ref(indices, values, f64, d, dim),
                    limit(mttkrp_ref(indices, values.abs(), abs64, d, dim),
                          terms, len(dims))))
    return out


def cuda_ms(fn, reps):
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` launches after
    one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def byte_bound(L, plan, d, smax, n, rank, remap):
    """Bytes the function must move on this run's data: each input read
    once, each output written once; the dedup tables read to ``nuniq``,
    and of each input factor only the rows that the alive slots use."""
    import torch

    s = plan.padded_nnz
    nm1 = n - 1
    alive = L["lrow"] >= 0
    rows_used = sum(int(torch.unique(L["idx"][:, w][alive]).numel())
                    for w in range(n) if w != d)
    b = 4 * (s * (2 + nm1)                      # val, lrow, upos
             + plan.kappa + 1                   # pstart
             + int(L["nuniq"].sum())            # uidx entries used
             + nm1 * plan.nblocks               # nuniq
             + rows_used * rank                 # factor rows used
             + plan.relabeled_rows * rank)      # out_rel
    if remap:
        b += 4 * (2 * s * n + smax * (1 + 2 * n))
    return b, rows_used


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------
def phase_card():
    import numpy
    import torch
    from repro_torch.kernels import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {numpy.__version__} | count "
        f"{torch.cuda.device_count()}")
    log(smi)
    t0 = time.perf_counter()
    build.build_all()
    log(f"[1] nvcc build {time.perf_counter() - t0:.1f} s")
    for lib, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                log(f"[1] {lib}: {line.strip()}")
    return name, smi


def phase_kernels(kmt):
    """Kernels against plain versions, nmodes 3-6: random, heavy dedup,
    empty partitions, trivial (dedup-off) tables."""
    import torch
    from repro_torch import engine
    from repro_torch.core import random_tensor, zipf_tensor
    from repro_torch.engine import ExecutionConfig

    cases = [
        ("random3", random_tensor((230, 170, 110), 7000, seed=3, rows_pp=16,
                                  block_p=128), 32, True),
        ("zipf4-heavy-dedup", zipf_tensor((500, 400, 300, 200), 20000,
                                          a=2.0, seed=4, rows_pp=16,
                                          block_p=128), 32, True),
        ("random5-empty-parts", random_tensor((64, 50, 40, 30, 20), 40,
                                              seed=5, rows_pp=2, block_p=32),
         16, True),
        ("zipf6-trivial-tables", zipf_tensor((40, 30, 20, 10, 8, 6), 3000,
                                             a=1.5, seed=6, rows_pp=8,
                                             block_p=32), 8, False),
    ]
    from repro_torch.engine.api import mode_layout

    g = torch.Generator(device="cuda").manual_seed(0)
    for tag, t, rank, dedup in cases:
        empty = sum(int((p.part_nnz == 0).sum()) for p in t.plans)
        heavy = [float(t.dedup_tables(d)[2].sum()
                       / max(1, (t.plans[d].part_nnz.sum()) * (t.nmodes - 1)))
                 for d in range(t.nmodes)]
        state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                               dedup=dedup))
        factors = [torch.randn((d, rank), generator=g, device="cuda")
                   for d in t.dims]
        err = 0.0
        for _ in range(t.nmodes):
            d = state.mode
            L = mode_layout(state, (state.val, state.idx, state.alpha), d)
            err = max(err, *check_mode_kernels(kmt, state, L, factors, d,
                                               tag).values())
            _, state = engine.mttkrp(state, factors)
        torch.cuda.synchronize()
        log(f"[2] {tag}: nmodes {t.nmodes} R {rank} empty partitions "
            f"{empty} unique-rows/slot {min(heavy):.3f} max|err| {err:.2e} ok")
        if tag.endswith("empty-parts") and empty == 0:
            raise AssertionError("empty-partition case has none")


def main_path(kmt, report):
    """Phases 3-4: nell1 through the entry points, both kernel paths."""
    import torch
    from repro_torch import engine
    from repro_torch.core import (build_flycoo, cp_als, init_factors, spec,
                                  synthesize)
    from repro_torch.engine import ExecutionConfig

    t0 = time.perf_counter()
    ts = spec("nell1", scale=0.1)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    for d in range(n):
        t.dedup_tables(d)
    log(f"[3] nell1 scale 0.1: dims {ts.dims} nnz {t.nnz} host setup "
        f"{time.perf_counter() - t0:.1f} s")
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    idx_d = torch.from_numpy(indices).cuda()
    val_d = torch.from_numpy(values).cuda()
    oracle = mttkrp_oracle(idx_d, val_d, factors, t.dims)

    # ---- main path: fused EC + remap (the default rotation) ------------
    torch.cuda.reset_peak_memory_stats()
    kmt.reset_launch_counts()
    state0 = engine.init(t, cfg)
    outs, state1 = engine.all_modes(state0, factors)
    res = cp_als(t, RANK, iters=3, config=cfg, factors=factors)
    torch.cuda.synchronize()
    remap_launches = kmt.LAUNCHES["mttkrp_fused_remap_compact"]
    peak = torch.cuda.max_memory_allocated()
    if remap_launches == 0:
        raise AssertionError("main path never launched "
                             "mttkrp_fused_remap_compact")
    errs, shares = zip(*(close_to(f"nell1 mode {d} vs mttkrp_ref", outs[d],
                                  *oracle[d]) for d in range(n)))
    for name in ("val", "idx", "alpha"):
        exact(f"nell1 layout {name} after rotation", getattr(state1, name),
              getattr(state0, name))
    ref = cp_als(t, RANK, iters=3, factors=factors,
                 config=ExecutionConfig(backend="torch", rank_hint=RANK))
    fits = res.fits
    if not all(map(lambda f: f == f and abs(f) < 1e30, fits)):
        raise AssertionError(f"non-finite fits {fits}")
    fit_diff = max(abs(a - b) for a, b in zip(fits, ref.fits))
    if fit_diff > FIT_ATOL:
        raise AssertionError(f"fits {fits} vs torch backend {ref.fits}")
    gate = gate_check(kmt, state0, factors)
    log(f"[3] all_modes == mttkrp_ref on 3 modes (max err {max(errs):.3e}, "
        f"{max(shares):.2e} of the limit); layout bitwise back; remap "
        f"launches {remap_launches}; cp_als fits {fits} (torch backend "
        f"{ref.fits}, max diff {fit_diff:.2e}); peak {peak / 2**30:.2f} GiB")
    log(f"[3] limit check: {gate}")
    report["nell1"] = {"dims": ts.dims, "nnz": t.nnz, "fits": fits,
                       "torch_fits": ref.fits, "fit_diff": fit_diff,
                       "max_err": max(errs), "max_err_share": max(shares),
                       "gate_check": gate, "peak_bytes": peak}

    # ---- the same rotation with fuse_remap=False ------------------------
    cfg_g = ExecutionConfig(backend="cuda_fused", rank_hint=RANK,
                            fuse_remap=False)
    kmt.reset_launch_counts()
    state_g = engine.init(t, cfg_g)
    outs_g, state_g1 = engine.all_modes(state_g, factors)
    torch.cuda.synchronize()
    gather_launches = kmt.LAUNCHES["mttkrp_fused_gather_compact"]
    if gather_launches == 0:
        raise AssertionError("fuse_remap=False never launched "
                             "mttkrp_fused_gather_compact")
    for d in range(n):
        close_to(f"nell1 fuse_remap=False mode {d}", outs_g[d], *oracle[d])
    for name in ("val", "idx", "alpha"):
        exact(f"nell1 fuse_remap=False layout {name}",
              getattr(state_g1, name), getattr(state_g, name))
    log(f"[4] fuse_remap=False all_modes == mttkrp_ref; gather launches "
        f"{gather_launches}")
    return t, state0, factors, {"mttkrp_fused_remap_compact": remap_launches,
                                "mttkrp_fused_gather_compact":
                                    gather_launches}


def phase_twitch(kmt):
    import torch
    from repro_torch import engine
    from repro_torch.core import build_flycoo, init_factors, spec, synthesize
    from repro_torch.engine import ExecutionConfig

    t0 = time.perf_counter()
    ts = spec("twitch", scale=0.01)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(1),
                           t.dims, RANK)
    state0 = engine.init(t, cfg)
    log(f"[5] twitch scale 0.01: dims {ts.dims} nnz {t.nnz} host setup "
        f"{time.perf_counter() - t0:.1f} s")
    outs, state1 = engine.all_modes(state0, factors)
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, t.dims)
    for d in range(n):
        close_to(f"twitch mode {d} vs mttkrp_ref", outs[d], *oracle[d])
    for name in ("val", "idx", "alpha"):
        exact(f"twitch layout {name}", getattr(state1, name),
              getattr(state0, name))
    log("[5] 5-mode all_modes == mttkrp_ref; layout bitwise back")


def phase_times(kmt, t, state0, factors, report, reps):
    """Per mode at the main path's shapes: both kernels against their
    plain versions, then kernel, plain version and torch backend times
    (CUDA events), byte bound, partition imbalance. Returns the rows and
    each kernel's max |kernel - plain| over the modes."""
    from repro_torch import engine
    from repro_torch.engine.api import mode_layout
    from repro_torch.engine.backends import ec_torch

    n = t.nmodes
    rows = []
    errs = dict.fromkeys(REPLACES, 0.0)
    state = state0
    for _ in range(n):
        d = state.mode
        plan = state.statics[d]
        L = mode_layout(state, (state.val, state.idx, state.alpha), d)
        for kname, err in check_mode_kernels(kmt, state, L, factors, d,
                                             "nell1").items():
            errs[kname] = max(errs[kname], err)
        inputs, kw = kernel_args(factors, d, state)
        nxt = (d + 1) % n
        smax = state.smax
        alive = L["lrow"] >= 0
        flops = int(alive.sum()) * RANK * n     # N-1 multiplies + 1 add
        row = {"mode": d, "dim": plan.dim, "kappa": plan.kappa,
               "rows_pp": plan.rows_pp, "nblocks": plan.nblocks,
               "slots": plan.padded_nnz}
        lb = t.plans[d].load_balance()
        row["part_nnz_max"], row["part_nnz_mean"] = lb["max"], lb["mean"]
        row["max_degree"] = lb["max_degree"]

        def torch_step():
            out = ec_torch(L, factors, d, plan=plan, config=state.config)
            return out, kmt.remap_plain(L["val"], L["idx"], L["alpha"],
                                        smax=smax, next_mode=nxt)

        for kname, fn, plain, yard, remap in (
                ("mttkrp_fused_remap_compact",
                 lambda: run_remap(kmt, L, inputs, kw, smax, nxt),
                 lambda: run_remap(kmt, L, inputs, kw, smax, nxt, True),
                 torch_step, True),
                ("mttkrp_fused_gather_compact",
                 lambda: run_gather(kmt, L, inputs, kw),
                 lambda: run_gather(kmt, L, inputs, kw, True),
                 lambda: ec_torch(L, factors, d, plan=plan,
                                  config=state.config), False)):
            nbytes, rows_used = byte_bound(L, plan, d, smax, n, RANK, remap)
            row[kname] = {
                "ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, reps),
                "torch_backend_ms": cuda_ms(yard, reps),
                "bytes": nbytes, "factor_rows_used": rows_used,
                "flops": flops,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      flops / F32_FLOP_PER_S),
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / F32_FLOP_PER_S else "operations")}
            log(f"[6] mode {d} {kname}: {row[kname]['ms']:.3f} ms (plain "
                f"{row[kname]['plain_ms']:.3f}, torch backend "
                f"{row[kname]['torch_backend_ms']:.3f}, bound "
                f"{row[kname]['bound_ms']:.4f}) | part_nnz max "
                f"{lb['max']:.0f} mean {lb['mean']:.1f} kappa {plan.kappa}")
        rows.append(row)
        _, state = engine.mttkrp(state, factors)
    report["times"] = rows
    return rows, errs


def kernels_record(rows, launches, errs):
    out = []
    for kname in ("mttkrp_fused_remap_compact",
                  "mttkrp_fused_gather_compact"):
        per = [r[kname] for r in rows]
        bytes_ms = 1e3 * sum(p["bytes"] for p in per) / HBM_BYTES_PER_S
        ops_ms = 1e3 * sum(p["flops"] for p in per) / F32_FLOP_PER_S
        out.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "torch_backend_ms": sum(p["torch_backend_ms"] for p in per),
            "per": "one rotation over the 3 modes of nell1 (scale 0.1, "
                   "R 32); library_ms null: no single PyTorch call "
                   "computes MTTKRP",
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (phases 1-2)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed launches per measurement (after a warm-up)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import mttkrp as kmt

    t_start = time.perf_counter()
    name, smi = phase_card()
    phase_kernels(kmt)
    if args.quick:
        log(f"quick run passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    report = {"device": name, "nvidia_smi": smi}
    t, state0, factors, launches = main_path(kmt, report)
    phase_twitch(kmt)
    rows, errs = phase_times(kmt, t, state0, factors, report, args.reps)
    kernels = kernels_record(rows, launches, errs)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
