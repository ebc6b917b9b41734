"""The port's sharding context, parameter rules, specs, production mesh,
single-controller moves, gradient compression and pipeline schedule
(``repro_torch.sharding``, ``launch.specs``, ``launch.mesh``,
``training.compression``, ``training.pipeline``) against the JAX
reference, on the CPU.

The rules (``param_tags``, ``param_sharding_tree``, ``resolve``,
``state_shardings``, ``batch_shardings``) need no devices on either
side: the reference's run over a ``jax.sharding.AbstractMesh`` of the
same shape, in process. What needs devices on the reference's side
(``shard`` under ``jit``, ``compressed_grad_sync`` in a ``shard_map``
over 4 pods, ``pipeline_apply`` over 4 stages) runs in one child process
with ``--xla_force_host_platform_device_count=8`` (the module fixture
``ref``). The port's meshes are ``devices=["cpu"] * n``.

Tolerances: specs and mesh shapes exactly; placement and gather
bitwise; compression 1e-5 (float32 products and a QR of a 64 x 16
matrix, in another order), its error feedback 1e-5; the pipeline 1e-6
against the port's own sequential stages and 1e-5 against the
reference's (the reference's own test bound); the elastic restore
bitwise.
"""
import dataclasses
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
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import init_state as jinit_state
from repro_torch import configs, sharding
from repro_torch.core import cp_als
from repro_torch.core.distributed import build_sharded_flycoo
from repro_torch.engine import ExecutionConfig, dist as edist
from repro_torch.engine.api import init as engine_init
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.training import (CheckpointManager, OptimizerConfig,
                                  init_state)
from repro_torch.training.compression import (compress_allreduce,
                                              compressed_grad_sync)
from repro_torch.training.pipeline import pipeline_apply
from repro_torch.training.tree import leaves

REPO = Path(__file__).resolve().parents[1]
ARCHS = [("tinyllama-1.1b", False), ("olmo-1b", False), ("qwen2.5-3b", False),
         ("tinyllama-1.1b", True), ("rwkv6-3b", False),
         ("recurrentgemma-9b", False)]
MESHES = [((2, 4), ("data", "model")), ((4, 1), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _cfg(mod, arch, cpd):
    kw = dict(cpd_embedding=True, cpd_rank=16) if cpd else {}
    return dataclasses.replace(mod.smoke(arch), **kw)


def _ctx_pair(shape, axes, fsdp=True):
    jctx = jsh.make_ctx(AbstractMesh(shape, axes), fsdp=fsdp)
    n = int(np.prod(shape))
    tctx = sharding.make_ctx(make_mesh(shape, axes, ["cpu"] * n), fsdp=fsdp)
    return jctx, tctx


def _norm(spec) -> tuple:
    """A spec without its trailing ``None``s (``P()`` == ``P(None)``)."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _compare_params(jtree, ttree):
    """Every port spec (per layer under a ``stage`` key) equal to the
    reference's (its leading layer entry dropped); returns the count."""
    n = 0
    if isinstance(ttree, dict):
        assert sorted(ttree) == sorted(jtree)
        return sum(_compare_params(jtree[k], ttree[k]) for k in ttree)
    if isinstance(ttree, list):
        want = tuple(jtree.spec)
        assert want[0] is None
        for t in ttree:
            assert _norm(t) == _norm(want[1:]), (t, want)
        return len(ttree)
    assert _norm(ttree) == _norm(jtree.spec), (ttree, jtree.spec)
    return n + 1


@pytest.fixture(scope="module")
def states():
    """Reference shapes (``eval_shape``) and port states (CPU) of every
    ported arch's smoke config, AdamW and Adafactor."""
    out = {}
    for arch, cpd in ARCHS:
        for name in ("adamw", "adafactor"):
            ocfg = dict(name=name)
            jst = jax.eval_shape(lambda: jinit_state(
                _cfg(jconfigs, arch, cpd), JOptimizerConfig(**ocfg),
                jax.random.PRNGKey(0)))
            tst = init_state(_cfg(configs, arch, cpd),
                             OptimizerConfig(**ocfg), device="cpu")
            out[arch, cpd, name] = jst, tst
    return out


@pytest.mark.parametrize("shape,axes", MESHES)
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_sharding_tree_matches_reference(states, shape, axes, fsdp):
    """``param_tags`` + the divisibility guard, leaf by leaf, for every
    ported arch (the dense three, CPD tinyllama, rwkv6, recurrentgemma)."""
    jctx, tctx = _ctx_pair(shape, axes, fsdp)
    for (arch, cpd, name), (jst, tst) in states.items():
        if name != "adamw":
            continue
        jt = jsh.param_sharding_tree(jst["params"], jctx)
        tt = sharding.param_sharding_tree(tst["params"], tctx)
        assert _compare_params(jt, tt) == len(leaves(tst["params"]))


@pytest.mark.parametrize("shape,axes", MESHES)
def test_param_tags_and_resolve_match_reference(shape, axes):
    """The raw rules (before the guard) on every name they know, stacked
    and not, and ``resolve`` of each tag."""
    jctx, tctx = _ctx_pair(shape, axes)
    for tag in ("dp", "tp", None):
        assert tctx.resolve(tag) == tuple(jctx.resolve(tag))
    assert tctx.data_axis == jctx.data_axis
    names = ["embed", "head", "wq", "wk", "wv", "wo", "w_gate", "w_up",
             "w_down", "router", "w_in_rec", "w_in_gate", "w_out_rec", "wr",
             "wk_t", "wv_t", "wg", "w_out_t", "wk_c", "wv_c", "scale", "u"]
    for name in names:
        for shape_ in [(6, 8), (8, 6, 3), (8, 4, 3), (3, 8, 5)]:
            for stacked in (False, True):
                if name in ("embed", "head") and (stacked or
                                                  len(shape_) != 2):
                    continue
                path = (("stage0", "b0", name) if stacked else (name,))
                jshape = ((2,) + shape_) if stacked else shape_
                want = jsh.param_tags(path, jshape, jctx)
                got = sharding.param_tags(path, shape_, tctx)
                assert got == (tuple(want[1:]) if stacked else want), (
                    name, shape_, stacked)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_state_and_batch_shardings_match_reference(states, shape, axes):
    """``state_shardings``: ``m`` / ``v`` mirror the params, Adafactor's
    ``f`` is replicated; ``batch_shardings``: dp when it divides the
    batch."""
    jctx, tctx = _ctx_pair(shape, axes)
    for (arch, cpd, name), (jst, tst) in states.items():
        js = jspecs.state_shardings(jst, jctx)
        ts = specs.state_shardings(tst, tctx)
        _compare_params(js["params"], ts["params"])
        if name == "adamw":
            for k in ("m", "v"):
                _compare_params(js["opt"][k], ts["opt"][k])
        else:
            for s in leaves(jax.tree.map(lambda x: x.spec, js["opt"]["f"])):
                assert _norm(s) == ()
            for s in _spec_leaves(ts["opt"]["f"]):
                assert _norm(s) == ()
        assert ts["step"] is None and ts["opt"]["step"] is None
        assert _norm(js["step"].spec) == ()
    cfg = configs.smoke("tinyllama-1.1b")
    for b in (8, 6, 2, 1):
        batch = {"tokens": torch.zeros((b, 16), dtype=torch.int32),
                 "targets": torch.zeros((b, 16), dtype=torch.int32)}
        jb = jspecs.batch_shardings(
            cfg, {k: jax.ShapeDtypeStruct((b, 16), np.int32)
                  for k in batch}, jctx)
        tb = specs.batch_shardings(cfg, batch, tctx)
        for k in batch:
            assert _norm(tb[k]) == _norm(jb[k].spec), (b, k)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for x in tree for s in _spec_leaves(x)]
    return [tree]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(multi_pod, monkeypatch):
    """Shape and axis names of the reference's production mesh (its
    ``_mesh`` patched to make an ``AbstractMesh``: it needs 256 or 512
    chips),
    and the port's built on 256 / 512 CPU devices; without ``devices=``
    the port raises where torch sees fewer cards."""
    monkeypatch.setattr(jmesh, "_mesh", lambda s, a: AbstractMesh(s, a))
    want = jmesh.make_production_mesh(multi_pod=multi_pod)
    n = 512 if multi_pod else 256
    got = make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * n)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    with pytest.raises(RuntimeError, match="cards"):
        make_production_mesh(multi_pod=multi_pod)


def test_place_gather_bitwise_and_blocks():
    """``place`` splits by spec (one piece per distinct device and block:
    replicas on one device shared), ``gather`` is bitwise, ``working_copy``
    gathers the dp dims and keeps the model slice, ``psum`` sums in
    position order."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    ctx = sharding.make_ctx(mesh)
    x = torch.randn(8, 6, 4, generator=torch.Generator().manual_seed(0))
    spec = ctx.resolve("dp", "tp", None)
    assert spec == (("pod", "data"), "model", None)
    s = sharding.place_tensor(x, spec, mesh)
    assert len(s.pieces) == 8
    assert torch.equal(sharding.gather_tensor(s), x)
    # (pod 1, data 0, model 1): row block 2 of 4, column block 1 of 2
    assert torch.equal(s.at((1, 0, 1)), x[4:6, 3:6])
    w = sharding.working_copy(s, (1, 0, 1), ctx)
    assert torch.equal(w, x[:, 3:6])
    r = sharding.place_tensor(x, (None, None, None), mesh)
    assert len(r.pieces) == 1 and torch.equal(r.at((1, 1, 1)), x)
    parts = [torch.full((3,), float(i)) for i in range(4)]
    assert all(torch.equal(p, torch.full((3,), 6.0))
               for p in sharding.psum(parts))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.place_tensor(torch.zeros(3, 4), ("data", None),
                              make_mesh((2,), ("data",), ["cpu"] * 2))


def test_shard_keeps_values_and_checks_rank():
    x = torch.zeros(4, 3)
    assert sharding.shard(x, "dp", "tp") is x      # no context: a no-op
    _, tctx = _ctx_pair((2, 4), ("data", "model"))
    with sharding.use(tctx):
        assert sharding.current() is tctx
        assert sharding.shard(x, "dp", None) is x
        with pytest.raises(ValueError, match="2 tags for rank-1"):
            sharding.shard(torch.zeros(4), "dp", None)
    assert sharding.current() is None


# --------------------------------------------------------------------------
# What the reference needs devices for: one child process
# --------------------------------------------------------------------------
SHARD_CASES = [((8, 6), ("dp", "tp")), ((6, 8), ("dp", "tp")),
               ((4, 4, 3), ("dp", None, "tp")), ((3, 16), (None, "tp")),
               ((16, 2), ("tp", "dp")), ((5,), ("dp",))]

_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from functools import partial
from jax.sharding import PartitionSpec as P
from repro import sharding as shlib
from repro.launch.mesh import make_mesh
from repro.training.compression import compressed_grad_sync
from repro.training.pipeline import pipeline_apply

out = {}
cases = json.loads(sys.argv[2])
meshes = json.loads(sys.argv[3])
for mi, (shape, axes) in enumerate(meshes):
    ctx = shlib.make_ctx(make_mesh(tuple(shape), tuple(axes)))
    for ci, (xs, tags) in enumerate(cases):
        x = jnp.zeros(tuple(xs), jnp.float32)
        with shlib.use(ctx):
            y = jax.jit(lambda t: shlib.shard(t, *tags))(x)
        spec = list(y.sharding.spec)
        spec += [None] * (len(xs) - len(spec))
        out[f"shard_{mi}_{ci}"] = np.array(json.dumps(
            [list(e) if isinstance(e, tuple) else e for e in spec]))

# compression: 4 pods, a compressed leaf "w" and an exact one "b"
mesh = make_mesh((4,), ("pod",))
try:
    from jax import shard_map
    sm = partial(shard_map, mesh=mesh,
                 in_specs=(P("pod"), P("pod"), P("pod"), P()),
                 out_specs=(P("pod"), P("pod"), P("pod"), P("pod")),
                 check_vma=False)
except ImportError:
    from jax.experimental.shard_map import shard_map
    sm = partial(shard_map, mesh=mesh,
                 in_specs=(P("pod"), P("pod"), P("pod"), P()),
                 out_specs=(P("pod"), P("pod"), P("pod"), P("pod")),
                 check_rep=False)
gw = jax.random.normal(jax.random.PRNGKey(0), (4, 64, 128))
gb = jax.random.normal(jax.random.PRNGKey(2), (4, 32))
gw2 = jax.random.normal(jax.random.PRNGKey(3), (4, 64, 128))
key = jax.random.PRNGKey(1)

def body(w, b, w2, key):
    g = {"b": b[0], "w": w[0]}
    synced, err = compressed_grad_sync(g, key, rank=16, axis_name="pod")
    s2, e2 = compressed_grad_sync({"b": b[0], "w": w2[0]}, key, rank=16,
                                  axis_name="pod", error=err)
    return (synced["w"][None], err["w"][None], synced["b"][None],
            s2["w"][None])

sw, ew, sb, sw2 = jax.jit(sm(body))(gw, gb, gw2, key)
keys = jax.random.split(key, 2)        # leaves "b", "w" in order
out.update(gw=gw, gb=gb, gw2=gw2, sw=sw, ew=ew, sb=sb, sw2=sw2,
           q0w=jax.random.normal(keys[1], (128, 16), jnp.float32))

# pipeline: 4 stages, 4 microbatches
mesh = make_mesh((4,), ("pp",))
ws = jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16)) * 0.3
x = jax.random.normal(jax.random.PRNGKey(1), (8, 16))
y = jax.jit(lambda w, t: pipeline_apply(
    lambda w, h: jnp.tanh(h @ w), w, t, mesh=mesh, n_micro=4))(ws, x)
out.update(ws=ws, px=x, py=y)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("refshard") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_CHAOS", None)
    env.pop("REPRO_LADDER", None)
    cases = [[list(s), list(t)] for s, t in SHARD_CASES]
    meshes = [[list(s), list(a)] for s, a in MESHES]
    import json
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        json.dumps(cases), json.dumps(meshes)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mi", range(len(MESHES)))
def test_shard_dropping_rule_matches_reference(ref, mi):
    """The tags ``shard`` keeps (``fit_tags``) are the spec the
    reference's ``shard`` puts on its output under ``jit`` (where jax
    leaves out the axes of size 1 of an output's spec)."""
    import json
    shape, axes = MESHES[mi]
    _, tctx = _ctx_pair(shape, axes)
    sizes = dict(zip(axes, shape))

    def big(spec):
        out = []
        for e in spec:
            keep = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                         if a is not None and sizes[a] > 1)
            out.append(None if not keep else keep[0] if len(keep) == 1
                       else keep)
        return _norm(out)

    for ci, (xs, tags) in enumerate(SHARD_CASES):
        want = [tuple(e) if isinstance(e, list) else e
                for e in json.loads(str(ref[f"shard_{mi}_{ci}"]))]
        got = tctx.resolve(*sharding.fit_tags(xs, tags, tctx))
        assert big(got) == big(want), (shape, xs, tags)


def _pods(n=4):
    return make_mesh((n,), ("pod",), ["cpu"] * n)


def test_compressed_grad_sync_matches_reference(ref):
    """4 pod positions, the reference's Q0: the compressed leaf, its
    error feedback (the residual g + e - approx, and a second call that
    takes it), and the exact mean of the small leaf."""
    q0 = torch.from_numpy(ref["q0w"])
    grads = [{"b": torch.from_numpy(ref["gb"][k]),
              "w": torch.from_numpy(ref["gw"][k])} for k in range(4)]
    synced, err = compressed_grad_sync(grads, 16, q0s=[None, q0])
    tol = dict(rtol=1e-5, atol=1e-5)
    for k in range(4):
        np.testing.assert_allclose(synced[k]["w"].numpy(), ref["sw"][k],
                                   **tol)
        np.testing.assert_allclose(err[k]["w"].numpy(), ref["ew"][k], **tol)
        np.testing.assert_allclose(synced[k]["b"].numpy(), ref["sb"][k],
                                   **tol)
        assert torch.equal(synced[k]["w"], synced[0]["w"])
        torch.testing.assert_close(err[k]["w"], grads[k]["w"]
                                   - synced[k]["w"], rtol=0, atol=1e-6)
        assert not err[k]["b"].any()
    grads2 = [{"b": torch.from_numpy(ref["gb"][k]),
               "w": torch.from_numpy(ref["gw2"][k])} for k in range(4)]
    synced2, _ = compressed_grad_sync(grads2, 16, q0s=[None, q0], error=err)
    for k in range(4):
        np.testing.assert_allclose(synced2[k]["w"].numpy(), ref["sw2"][k],
                                   **tol)


def test_compress_allreduce_draws_from_generator():
    """Without a given Q0 the draw comes from the generator: the same
    seed gives the same result; rank >= the matrix's is exact."""
    g = [torch.randn(64, 80, generator=torch.Generator().manual_seed(k))
         for k in range(3)]
    a = compress_allreduce(g, 8, generator=torch.Generator().manual_seed(5))
    b = compress_allreduce(g, 8, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    full = compress_allreduce(g, 64,
                              generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(full[0], sum(g) / 3, rtol=1e-4, atol=1e-4)


def test_pipeline_matches_sequential_and_reference(ref):
    ws = torch.from_numpy(ref["ws"])
    x = torch.from_numpy(ref["px"])
    mesh = make_mesh((4,), ("pp",), ["cpu"] * 4)

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    seq = x
    for s in range(4):
        seq = stage_fn(ws[s], seq)
    for n_micro in (4, 2, 8):
        y = pipeline_apply(stage_fn, ws, x, mesh=mesh, n_micro=n_micro)
        torch.testing.assert_close(y, seq, rtol=1e-6, atol=1e-6)
    y = pipeline_apply(stage_fn, list(ws), x, mesh=mesh, n_micro=4)
    np.testing.assert_allclose(y.numpy(), ref["py"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(stage_fn, ws, x, mesh=mesh, n_micro=3)


# --------------------------------------------------------------------------
# Elastic reshard and the CPD tier under a context
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_elastic_checkpoint_reshard_bitwise(tmp_path, name):
    """Saved on (data 2, model 2), restored on (data 2, model 1): every
    leaf bitwise; the blob equals the one an unsharded save writes (the
    digest is mesh-independent); ``shardings=`` without a context
    raises."""
    cfg = configs.smoke("olmo-1b")
    ocfg = OptimizerConfig(name=name)
    _, ctx4 = _ctx_pair((2, 2), ("data", "model"))
    _, ctx2 = _ctx_pair((2, 1), ("data", "model"))
    plain = init_state(cfg, ocfg, device="cpu")
    with sharding.use(ctx4):
        state4 = init_state(cfg, ocfg, device="cpu")
    assert sharding.is_sharded(state4["params"])
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=False)
    mgr.save(state4, {"step": 0})
    CheckpointManager(str(tmp_path / "b"), async_save=False).save(
        plain, {"step": 0})
    assert os.listdir(tmp_path / "a") == os.listdir(tmp_path / "b")
    with sharding.use(ctx2):
        like = init_state(cfg, ocfg, seed=1, device="cpu")
        restored, data = mgr.restore_latest(
            like=like, shardings=specs.state_shardings(like, ctx2))
    assert data == {"step": 0}
    got = [x for x in leaves(restored) if isinstance(x, sharding.Sharded)]
    assert got and all(x.mesh is ctx2.mesh for x in got)
    for a, b in zip(leaves(sharding.gather(restored)), leaves(plain)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="current mesh"):
        mgr.restore_latest(like=plain, shardings=specs.state_shardings(
            plain, ctx2))


def _coo_tensor():
    rng = np.random.default_rng(0)
    dims = (24, 18, 12)
    idx = np.unique(np.stack([rng.integers(0, d, 600) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    return build_sharded_flycoo(idx, val, dims, n_dev=4, rows_pp=4,
                                block_p=8, schedule="compact")


def test_cpd_tier_takes_a_sharding_ctx():
    """``shard_state(state, ctx)`` equals the explicit ``Mesh`` +
    ``DistConfig(data, model)`` path; ``cp_als(mesh=ctx)`` equals
    ``cp_als(mesh=Mesh)`` on the data axis (the ctx's tp axis is never
    used there); anything else raises ``TypeError`` naming both types."""
    t = _coo_tensor()
    cfg = ExecutionConfig(device="cpu")
    state = engine_init(t, cfg)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    ctx = sharding.make_ctx(mesh)
    a = edist.shard_state(state, ctx)
    b = edist.shard_state(state, mesh, edist.DistConfig(
        data_axis="data", model_axis="model"))
    assert a.dist == b.dist and a.dist.model_axis == "model"
    for f in ("val", "idx", "alpha"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert torch.equal(x, y)
    r1 = cp_als(t, 4, iters=3, config=cfg, mesh=ctx,
                generator=torch.Generator().manual_seed(0))
    data = make_mesh((2,), ("data",), ["cpu"] * 2)
    r2 = cp_als(t, 4, iters=3, config=cfg, mesh=data,
                generator=torch.Generator().manual_seed(0))
    assert r1.fits == r2.fits
    for x, y in zip(r1.factors, r2.factors):
        assert torch.equal(x, y)
    with pytest.raises(TypeError, match="Mesh or a repro_torch.sharding."
                       "ShardingCtx"):
        edist.shard_state(state, object())
