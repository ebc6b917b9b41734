"""The decode step as a CUDA graph replays it, and the rotation's CPU half,
against the JAX reference on the CPU.

The decode path reads its position from a 0-d int64 tensor in each cache
(``layers.attention_decode``: RoPE positions, the ring slot, the valid
keys), writes the KV caches in place, and ``serving.Engine`` runs it on
bf16 working copies of the weights it casts at use
(``transformer.decode_working_copies``). Here every arch's smoke config
(float32 compute, the leaves that init makes constant perturbed) takes 6
``decode_step``s against the reference's, from caches of 8 positions
(recurrentgemma-9b: 4, so that its local layers' ring of 4 slots wraps),
with and without the int8 KV cache for tinyllama-1.1b, recurrentgemma-9b
and whisper-large-v3 (whose cross caches hold 8 encoder frames).

Tolerances, those of today's decode tests (``tests/test_torch_dense.py``,
``tests/test_torch_families.py``): logits and float cache leaves rtol =
atol = 2e-5 (matmul and softmax order only); int8 rows bitwise, their
scales rtol 1e-5; positions equal. The working copies' engine (bf16
compute) against the same steps on the float32 masters: tokens and
logits bitwise, and a copy of a leaf the step reads in float32 (a
mutant) must change the logits. The rotation: ``all_modes`` with the ALS
fold through ``solve_ex`` bitwise the loop with ``torch.linalg.solve``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.engine import ExecutionConfig as RConfig
from repro.models import transformer as jtr
from repro_torch import configs, engine, interop
from repro_torch.core import build_flycoo, cpd, init_factors
from repro_torch.engine import ExecutionConfig
from repro_torch.models import layers, transformer
from repro_torch.serving import Engine, ServeConfig

ARCHS = tuple(configs.ARCHS)
KV_QUANT = ("tinyllama-1.1b", "recurrentgemma-9b", "whisper-large-v3")
CASES = [(a, False) for a in ARCHS] + [(a, True) for a in KV_QUANT]
SAME_TOL = dict(rtol=2e-5, atol=2e-5)
SCALE_TOL = dict(rtol=1e-5, atol=0)
B, STEPS, ENC = 2, 6, 8


def _max_len(cfg):
    """Room for the steps in a causal cache; 4 where every attention
    layer is windowed, so that the ring wraps."""
    kinds = set(transformer.layer_kinds(cfg))
    return 4 if "local" in kinds and kinds <= {"local", "rec", "rwkv"} \
        else STEPS + 2


def perturb(tree, seed):
    """The leaves that init makes constant perturbed: biases (zero),
    norm scales (one) and rwkv's decay LoRA ``wb_lora`` (zero)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("bq", "bk", "bv", "b_a", "b_x", "conv_b"):
            a = a + rng.normal(0, 0.3, a.shape)
        elif name in ("scale", "wb_lora"):
            a = a + rng.normal(0, 0.1, a.shape)
        return a.astype(np.float32)

    return walk(tree)


@functools.cache
def pair(arch, kv_quant):
    """(reference cfg, reference params, port cfg, port model) in f32."""
    kw = dict(compute_dtype="float32", kv_quant=kv_quant)
    jcfg = dataclasses.replace(jconfigs.smoke(arch), **kw)
    tcfg = dataclasses.replace(configs.smoke(arch), **kw)
    tree = perturb(jax.tree.map(np.asarray, jtr.init_model(
        jcfg, jax.random.PRNGKey(0))), 7)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            interop.model_params_from_numpy(tree, tcfg, device="cpu"))


def _frames(cfg, seed, b=B):
    e = np.random.default_rng(seed).standard_normal(
        (b, ENC, cfg.d_model)).astype(np.float32)
    return jnp.asarray(e), torch.from_numpy(e)


def _ref_layers(jc, cfg):
    """The reference's stage-stacked cache as one dict a layer, in the
    port's layer order."""
    return [jax.tree.map(lambda a, c=c: np.asarray(a)[c],
                         jc[f"stage{s}"][f"b{j}"])
            for s, (pat, rep) in enumerate(cfg.stages())
            for c in range(rep) for j in range(len(pat))]


@functools.cache
def trajectory(arch, kv_quant):
    """``STEPS`` steps on both sides from fresh caches: (each step's
    logits pair, the port's caches, the reference's, the KV tensors the
    port's first cache held)."""
    jcfg, jparams, tcfg, model = pair(arch, kv_quant)
    max_len = _max_len(tcfg)
    enc = ENC if tcfg.n_enc_layers else 0
    jc = jtr.init_cache(jcfg, B, max_len, enc_len=enc)
    tc = transformer.init_cache(tcfg, B, max_len, device="cpu", enc_len=enc)
    if enc:
        jf, tf = _frames(tcfg, 3)
        jc = jtr.build_cross_caches(jparams, jcfg, jf, jc)
        tc = transformer.build_cross_caches(model, tcfg, tf, tc)
    first = [{k: v for k, v in _self(c).items() if k in ("k", "v")}
             for c in tc]
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (B, STEPS))
    logits = []
    with torch.no_grad():
        for i in range(STEPS):
            tok = toks[:, i:i + 1]
            want, jc = jtr.decode_step(jparams, jc, jcfg,
                                       jnp.asarray(tok, jnp.int32))
            got, tc = transformer.decode_step(model, tc, tcfg,
                                              torch.from_numpy(tok))
            logits.append((got, want))
    return logits, tc, _ref_layers(jc, tcfg), first


def _self(c):
    return c["self"] if "self" in c else c


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("arch,kv_quant", CASES)
def test_decode_logits_match_reference(arch, kv_quant):
    for got, want in trajectory(arch, kv_quant)[0]:
        _close(got, want, SAME_TOL)


def _leaves_match(mine, ref, path=""):
    for name, leaf in mine.items():
        where = f"{path}/{name}"
        if isinstance(leaf, dict):
            _leaves_match(leaf, ref[name], where)
        elif name in ("len", "kv_len"):
            assert int(leaf) == int(ref[name]), where
        elif leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), ref[name], where)
        else:
            _close(leaf, ref[name], SCALE_TOL if name.endswith("_scale")
                   else SAME_TOL)


@pytest.mark.parametrize("arch,kv_quant", CASES)
def test_decode_cache_matches_reference(arch, kv_quant):
    """Every leaf of every layer's cache after the steps; each position a
    0-d int64 tensor, and the KV tensors the ones the fresh cache held
    (written in place)."""
    _, tc, jc, first = trajectory(arch, kv_quant)
    for layer, (mine, ref) in enumerate(zip(tc, jc)):
        _leaves_match(mine, ref, f"layer {layer}")
        if "k" in _self(mine):
            pos = _self(mine)["len"]
            assert pos.dtype == torch.int64 and pos.dim() == 0
            assert int(pos) == STEPS
            for name, t in first[layer].items():
                assert _self(mine)[name] is t


def test_recurrentgemma_ring_wrapped():
    """The smoke recurrentgemma's local ring holds fewer slots than the
    steps, so the cache test above crossed the wrap."""
    _, tc, _, _ = trajectory("recurrentgemma-9b", False)
    ring = [c for c, k in zip(tc, transformer.layer_kinds(
        configs.smoke("recurrentgemma-9b"))) if k == "local"]
    assert ring and all(c["k"].shape[1] < STEPS for c in ring)


# --------------------------------------------------------------------------
# The working copies
# --------------------------------------------------------------------------
@functools.cache
def _bf16_model(arch):
    """The smoke config (bf16 compute, float32 masters) with the constant
    leaves perturbed, so that a bf16 copy of a norm scale shows, and the
    router scaled 50x (its init's scores are all but uniform, and a bf16
    copy's change then vanishes in the bf16 combine weights)."""
    cfg = configs.smoke(arch)
    model = transformer.init_model(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bq", "bk", "bv", "b_a", "b_x", "conv_b",
                        "wb_lora", "w0"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
            elif leaf == "router":
                p.mul_(50.0)
    return cfg, model


def _eager_masters(model, cfg, prompt, n, enc):
    """The greedy loop of ``decode_step`` on the float32 masters: the
    tokens and the logits after the last."""
    cache = transformer.init_cache(cfg, B, 16, device="cpu",
                                   enc_len=0 if enc is None else ENC)
    with torch.no_grad():
        if enc is not None:
            cache = transformer.build_cross_caches(model, cfg, enc, cache)
        for t in range(prompt.shape[1]):
            logits, cache = transformer.decode_step(model, cache, cfg,
                                                    prompt[:, t:t + 1])
        toks = []
        for _ in range(n):
            nxt = logits[:, -1, :cfg.vocab].float().argmax(-1)
            toks.append(nxt)
            logits, cache = transformer.decode_step(model, cache, cfg,
                                                    nxt[:, None])
    return torch.stack(toks, 1), logits


def _engine_run(arch):
    cfg, model = _bf16_model(arch)
    prompt = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab, (B, 4)))
    enc = _frames(cfg, 9)[1] if cfg.n_enc_layers else None
    eng = Engine(model, cfg, ServeConfig(B, 16), device="cpu",
                 enc_embeds=enc, working_copies=True)
    return cfg, model, prompt, enc, eng, eng.generate(prompt, 6)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_working_copies_bitwise_the_masters(arch):
    cfg, model, prompt, enc, eng, toks = _engine_run(arch)
    want_toks, want_logits = _eager_masters(model, cfg, prompt, 6, enc)
    assert torch.equal(toks, want_toks)
    assert torch.equal(eng.last_logits, want_logits)
    assert eng.pos == prompt.shape[1] + 6


class _Casts(TorchDispatchMode):
    """Records the storages that ``aten._to_copy`` reads."""

    def __init__(self):
        super().__init__()
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.read.add(args[0].untyped_storage().data_ptr())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b",
                                  "recurrentgemma-9b", "olmoe-1b-7b",
                                  "whisper-large-v3"])
def test_working_copies_leave_no_weight_cast_a_step(arch):
    """No decode step on the working copies reads a bf16-cast weight's
    float32 master to cast it (the masters' step does)."""
    cfg, model = _bf16_model(arch)
    wp = transformer.decode_working_copies(model, cfg)
    cast = {p.untyped_storage().data_ptr() for p in model.parameters()
            if p.dtype == torch.float32} - {
        t.untyped_storage().data_ptr() for t in _tensors(wp)
        if t.dtype == torch.float32}
    assert cast
    tok = torch.zeros((B, 1), dtype=torch.int64)
    seen = {}
    for name, params in (("working", wp), ("masters", model)):
        cache = transformer.init_cache(cfg, B, 8, device="cpu",
                                       enc_len=ENC if cfg.n_enc_layers else 0)
        if cfg.n_enc_layers:
            cache = transformer.build_cross_caches(
                model, cfg, _frames(cfg, 9)[1], cache)
        with torch.no_grad(), _Casts() as rec:
            transformer.decode_step(params, cache, cfg, tok)
        seen[name] = rec.read & cast
    assert not seen["working"] and seen["masters"]


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("arch,sub,leaf", [
    ("olmoe-1b-7b", "moe", "router"), ("rwkv6-3b", "", "u"),
    ("rwkv6-3b", "", "w0"), ("recurrentgemma-9b", "rec", "lam"),
    ("tinyllama-1.1b", "ln1", "scale")])
def test_a_cast_float32_leaf_changes_the_logits(arch, sub, leaf,
                                                monkeypatch):
    """The bitwise gate catches a wrong pick: a working copy of a leaf
    the step reads in float32 changes the logits."""
    cast = dict(transformer._CAST_AT_USE)
    cast[sub] = cast.get(sub, ()) + (leaf,)
    monkeypatch.setattr(transformer, "_CAST_AT_USE", cast)
    cfg, model, prompt, enc, eng, _ = _engine_run(arch)
    _, want = _eager_masters(model, cfg, prompt, 6, enc)
    assert not torch.equal(eng.last_logits, want)


def test_engine_graph_needs_a_card():
    cfg, model = _bf16_model("tinyllama-1.1b")
    with pytest.raises(ValueError, match="CUDA"):
        Engine(model, cfg, ServeConfig(B, 8), device="cpu", graph=True)


# --------------------------------------------------------------------------
# A full causal cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "whisper-large-v3"])
def test_a_full_causal_cache_refuses_before_any_work(arch):
    """``Engine`` refuses from its host count before any step (the cache
    and the count untouched); a direct ``attention_decode`` at the last
    position raises, with the position a tensor or a Python int."""
    _, _, tcfg, model = pair(arch, False)
    enc = _frames(tcfg, 3, 1)[1] if tcfg.n_enc_layers else None
    eng = Engine(model, tcfg, ServeConfig(1, 6), device="cpu",
                 enc_embeds=enc)
    eng.generate(torch.zeros((1, 3), dtype=torch.long), 2)
    before = [dict(_self(c)) for c in eng.cache]
    k0 = _self(eng.cache[0])["k"].clone()
    with pytest.raises(ValueError, match="max_len 6"):
        eng.generate(torch.zeros((1, 1), dtype=torch.long), 1)
    assert eng.pos == 5
    assert all(_self(c)["len"] is b["len"] for c, b in zip(eng.cache,
                                                            before))
    assert torch.equal(_self(eng.cache[0])["k"], k0)
    attn = model.layers[0].attn
    x = torch.zeros((1, 1, tcfg.d_model))
    for full in (torch.tensor(6), 6):
        cache = {**layers.make_attn_cache(tcfg, 1, 6, "cpu"), "len": full}
        with pytest.raises(ValueError, match="full"):
            layers.attention_decode(attn, x, cache, tcfg)


# --------------------------------------------------------------------------
# The rotation
# --------------------------------------------------------------------------
def _state(nmodes=3, backend="torch"):
    dims = (24, 18, 12) if nmodes == 3 else (9, 8, 7, 6, 5)
    rng = np.random.default_rng(11)
    idx = np.unique(np.stack([rng.integers(0, d, 500) for d in dims], 1)
                    .astype(np.int32), axis=0)
    val = rng.standard_normal(len(idx)).astype(np.float32)
    t = build_flycoo(idx, val, dims, rows_pp=8, block_p=16)
    cfg = ExecutionConfig(backend=backend, device="cpu")
    factors = init_factors(torch.Generator().manual_seed(2), dims, 6)
    return engine.init(t, cfg), factors


def _solve_update(mttkrp_out, grams_other, eps=1e-8):
    """The fold's update with ``torch.linalg.solve``, as before
    ``solve_ex``."""
    v = grams_other[0]
    for g in grams_other[1:]:
        v = v * g
    r = v.shape[0]
    v = v + (eps + 1e-6 * torch.trace(v) / r) * torch.eye(r)
    y = torch.linalg.solve(v.T, mttkrp_out.T).T
    lam = torch.linalg.vector_norm(y, dim=0)
    lam = torch.where(lam < eps, 1.0, lam)
    return (y / lam).contiguous(), lam


def _solve_fold(d, m_d, factors, lam):
    n = len(factors)
    y, lam = _solve_update(m_d, tuple(cpd.gram(factors[w]) for w in range(n)
                                      if w != d))
    return tuple(factors[:d]) + (y,) + tuple(factors[d + 1:]), lam


@pytest.mark.parametrize("backend", ["torch", "cuda_fused"])
@pytest.mark.parametrize("nmodes", [3, 5])
def test_all_modes_fold_through_solve_ex_bitwise(nmodes, backend):
    """Three rotations with the ALS fold (``solve_ex``, no error check)
    against the eager loop with ``torch.linalg.solve``: outputs,
    factors, lambda and layouts bitwise."""
    state, factors = _state(nmodes, backend)
    lam = torch.ones(6)
    a = (state, tuple(factors), lam)
    b = (state, tuple(factors), lam)
    for _ in range(3):
        oa, sa, fa, la = engine.all_modes(a[0], a[1], fold=cpd._als_fold,
                                          carry=a[2])
        ob, sb, fb, lb = engine.all_modes_eager(b[0], b[1], fold=_solve_fold,
                                                carry=b[2])
        for x, y in zip(oa + fa + [la], ob + fb + [lb]):
            assert torch.equal(x, y)
        for name in ("val", "idx", "alpha"):
            assert torch.equal(getattr(sa, name), getattr(sb, name))
        a, b = (sa, tuple(fa), la), (sb, tuple(fb), lb)


def test_all_modes_on_the_cpu_keeps_its_input_and_captures_nothing():
    state, factors = _state()
    before = [t.clone() for t in (state.val, state.idx, state.alpha)]
    outs, nxt = engine.all_modes(state, factors)
    eo, enxt = engine.all_modes_eager(state, factors)
    assert all(torch.equal(x, y) for x, y in zip(outs, eo))
    assert all(torch.equal(t, b) for t, b in zip(
        (state.val, state.idx, state.alpha), before))
    assert not state.graphs and nxt.graphs is state.graphs
    assert nxt.aux_key() == state.aux_key()


@pytest.mark.parametrize("donate", [None, True, False, 0, 1])
def test_execution_config_donate_as_the_reference(donate):
    """The field, its default and ``resolve_donate`` as the reference's
    (on the CPU, auto donates nowhere; the card's auto is tested on the
    card)."""
    mine = ExecutionConfig(device="cpu", donate=donate)
    ref = RConfig(donate=donate)
    assert mine.donate == ref.donate
    assert mine.resolve_donate() == ref.resolve_donate()
    assert ExecutionConfig(device="cpu").donate is RConfig().donate is None


def test_fused_remap_writes_its_next_layout_into_out():
    """The remap wrappers' ``out`` (the rotation graph's layout buffers):
    the same output and next layout, written into the buffers given."""
    state, factors = _state(backend="cuda_fused")
    L = engine.api.mode_layout(state, (state.val, state.idx, state.alpha),
                               0)
    plan = state.statics[0]
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p, smax=state.smax, next_mode=1)
    args = (L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"],
            L["bpart"], L["uidx"], L["nuniq"], tuple(factors[1:]))
    from repro_torch.kernels import mttkrp as kmt

    want = kmt.mttkrp_fused_remap_compact(*args, **kw)
    out = (torch.full_like(state.val, 7.0), torch.full_like(state.idx, 7),
           torch.full_like(state.alpha, 7))
    got = kmt.mttkrp_fused_remap_compact(*args, **kw, out=out)
    assert all(g is o for g, o in zip(got[1:], out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
