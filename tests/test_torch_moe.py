"""The port's MoE family (``models/moe.py``, the ``moe`` block kind:
olmoe-1b-7b and qwen3-moe-235b-a22b) against the JAX reference, on the
CPU.

Inputs come from numpy seeds. The reference's ``init_model`` tree
crosses over as numpy through ``interop.model_params_from_numpy``, with
the norm scales perturbed (one at init, which would hide a dropped
scale; the QK-norm scales too). Compute is float32 on both sides
(``compute_dtype="float32"``). The smoke configs have 8 experts, top-2,
capacity factor 1.25: at B 2, S 32 an expert keeps 20 of its pairs, at
a decode step of B 2 one, so both paths drop pairs; a capacity factor of
16 drops none.

Tolerances (float32 both sides):
  * ``_route``: expert ids equal, weights within 1e-6 (a softmax over 8
    scores of a 128-long dot product, renormalised over 2); the inputs
    hold every token's margin between its k-th and (k+1)-th probability
    above 1e-4, so a flipped expert is a fault and not rounding.
  * ``_dispatch``: the buffer, ``keep`` and ``slot`` bitwise (a stable
    sort and copies: no arithmetic on the values).
  * ``_combine``: rtol = atol = 1e-6 (at most k = 2 products added to a
    token); in bf16, bitwise (each token's k terms added in the
    buffer's dtype in the order of the reference's scatter-add);
    ``_apply_local``: rtol = atol = 1e-5 (three batched products
    over d 128 and d_ff 256 summed in another order).
  * ``forward`` logits and ``decode_step`` logits: rtol = atol = 1e-4
    (the ``SCAN_TOL`` of ``tests/test_torch_dense.py``: two layers of
    attention and experts in another summation order; ~5e-6 is seen on
    logits of size ~4).
  * greedy tokens: equal.
  * one train step against the reference's jitted step: as
    ``tests/test_torch_training.py`` (loss and grad norm rtol 2e-5;
    AdamW's moments rtol 1e-4; parameters within 1e-6 where |g| >= 1e-6,
    2 lr elsewhere); Adafactor's factored statistics rtol 1e-4, atol
    1e-9 (``tests/test_torch_sharded_train.py``'s).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticLM as JSyntheticLM
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import moe, transformer
from repro_torch.models.common import Node
from repro_torch.serving import Engine, ServeConfig
from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                  make_train_step)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, unflatten

MOE = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
LR_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _t(a):
    """A tensor holding a copy of a numpy or jax array."""
    return torch.from_numpy(np.array(a))


def perturb(tree, seed):
    """Every norm scale (one at init) perturbed."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("scale", "q_norm", "k_norm"):
            a = a + rng.normal(0, 0.1, a.shape)
        return a.astype(np.float32)

    return walk(tree)


@functools.cache
def pair(arch, cf=None):
    """(reference cfg, reference params, port cfg, port model) in f32,
    built once a case; ``cf`` replaces the capacity factor."""
    kw = {} if cf is None else dict(capacity_factor=cf)
    jcfg, tcfg = _f32(jconfigs.smoke(arch), **kw), _f32(configs.smoke(arch),
                                                        **kw)
    tree = perturb(_np(jtr.init_model(jcfg, jax.random.PRNGKey(0))), 7)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            interop.model_params_from_numpy(tree, tcfg, device="cpu"))


def _moe_case(seed, t_tok=64, d=128, e=8, spread=1.0):
    """Token rows and a router whose scores spread the experts (std
    ``spread``), with a mean shift toward expert 0 (so the default
    capacity drops)."""
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((t_tok, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * spread / np.sqrt(d)).astype(
        np.float32)
    router[:, 0] += 0.5 * xt.mean(0) / np.linalg.norm(xt.mean(0))
    return xt, router


def _route_pair(xt, router, k):
    want = jmoe._route(jnp.asarray(xt), jnp.asarray(router), k)
    got = moe._route(torch.from_numpy(xt), torch.from_numpy(router), k)
    return got, want


# --------------------------------------------------------------------------
# The MoE functions against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,k,e,t_tok,spread", [(0, 2, 8, 64, 1.0),
                                                    (1, 2, 8, 64, 1.0),
                                                    (2, 8, 64, 16, 2.0)])
def test_route_matches_reference(seed, k, e, t_tok, spread):
    """Top-2 of 8 and top-8 of 64 (olmoe's), the latter on 16 tokens
    with scores of std 2 so that every 8th and 9th probability stand
    apart."""
    xt, router = _moe_case(seed, t_tok=t_tok, e=e, spread=spread)
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(xt @ router))),
                    axis=-1)[:, ::-1]
    assert (probs[:, k - 1] - probs[:, k]).min() > 1e-4
    (tw, ti), (jw, ji) = _route_pair(xt, router, k)
    assert ti.dtype == torch.int64
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, dict(rtol=0, atol=1e-6))


def test_route_ties_go_to_the_lower_index():
    """Equal probabilities (a router with equal columns, small integers
    throughout, so every score is exact) pick the lower expert index, as
    ``lax.top_k`` does."""
    rng = np.random.default_rng(3)
    xt = rng.integers(-3, 4, (16, 32)).astype(np.float32)
    router = np.repeat(rng.integers(-2, 3, (32, 1)), 6, axis=1).astype(
        np.float32) / 8
    router[:, 1] = np.sign(xt.sum(0))         # expert 1 first, then a tie
    (tw, ti), (jw, ji) = _route_pair(xt, router, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    group = [0, 2, 3, 4, 5]                   # the tied experts
    for row in ti.tolist():
        tied = [i for i in row if i != 1]
        assert tied == group[:len(tied)]
    _close(tw, jw, dict(rtol=0, atol=1e-6))


@pytest.mark.parametrize("cf,drops", [(1.25, True), (16.0, False)])
def test_dispatch_matches_reference_bitwise(cf, drops):
    xt, router = _moe_case(5)
    k, e = 2, 8
    _, eids = jmoe._route(jnp.asarray(xt), jnp.asarray(router), k)
    eids = np.array(eids)
    cap = moe._capacity(64, k, e, cf)
    assert cap == jmoe._capacity(64, k, e, cf)
    jbuf, (jslot, jkeep, jst, jorder) = jmoe._dispatch(
        jnp.asarray(xt), jnp.asarray(eids), e, cap)
    buf, (slot, keep, st, order) = moe._dispatch(
        torch.from_numpy(xt), torch.from_numpy(eids).long(), e, cap)
    assert bool((~keep).any()) == drops
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    for a, b in ((slot, jslot), (keep, jkeep), (st, jst), (order, jorder)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cf,drops", [(1.25, True), (16.0, False)])
def test_combine_and_apply_local_match_reference(cf, drops):
    """``_combine`` on the reference's own expert outputs and tables, and
    ``_apply_local`` end to end on the smoke olmoe's MoE weights."""
    cfg = _f32(configs.smoke("olmoe-1b-7b"), capacity_factor=cf)
    jcfg = _f32(jconfigs.smoke("olmoe-1b-7b"), capacity_factor=cf)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    xt = jnp.asarray(x.reshape(64, -1))
    weights, eids = jmoe._route(xt, jp["router"], cfg.top_k)
    cap = jmoe._capacity(64, cfg.top_k, cfg.n_experts, cf)
    jbuf, info = jmoe._dispatch(xt, eids, cfg.n_experts, cap)
    assert bool((~np.asarray(info[1])).any()) == drops
    out_buf = jmoe._expert_ffn(jbuf, jp["w_gate"], jp["w_up"], jp["w_down"],
                               jcfg)
    want = jmoe._combine(out_buf, info, weights, 64)
    slot, keep, st, order = info
    tinfo = (_t(slot).long(), _t(keep), _t(st).long(), _t(order).long())
    got = moe._combine(_t(out_buf), tinfo, _t(weights), 64)
    _close(got, want, dict(rtol=1e-6, atol=1e-6))
    tp = Node({k: _t(v) for k, v in jp.items()})
    got = moe._apply_local(tp, torch.from_numpy(x), cfg)
    _close(got, jmoe._apply_local(jp, jnp.asarray(x), jcfg),
           dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("cf,drops", [(1.25, True), (16.0, False)])
def test_combine_in_bf16_matches_reference_bitwise(cf, drops):
    """``_combine`` on bf16 expert outputs (a bf16 prefill's): every add
    rounds to bf16, a token's terms in the reference's order, so the
    sums are the reference's bit for bit."""
    jcfg = jconfigs.smoke("olmoe-1b-7b")
    jp = jmoe.init_moe(dataclasses.replace(jcfg, capacity_factor=cf),
                       jax.random.PRNGKey(3))
    x = np.random.default_rng(6).standard_normal((64, jcfg.d_model))
    xt = jnp.asarray(x, jnp.bfloat16)
    weights, eids = jmoe._route(xt, jp["router"], jcfg.top_k)
    cap = jmoe._capacity(64, jcfg.top_k, jcfg.n_experts, cf)
    jbuf, info = jmoe._dispatch(xt, eids, jcfg.n_experts, cap)
    assert bool((~np.asarray(info[1])).any()) == drops
    out_buf = jmoe._expert_ffn(jbuf, jp["w_gate"], jp["w_up"], jp["w_down"],
                               jcfg)
    assert out_buf.dtype == jnp.bfloat16
    want = jmoe._combine(out_buf, info, weights, 64).astype(jnp.float32)
    slot, keep, st, order = info
    tinfo = (_t(slot).long(), _t(keep), _t(st).long(), _t(order).long())
    got = moe._combine(_t(out_buf.astype(jnp.float32)).bfloat16(), tinfo,
                       _t(weights), 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


def test_init_moe_shapes_and_dtypes():
    """The router stays float32 under bf16 parameters; the experts take
    ``cfg.pdtype`` and the reference's shapes."""
    cfg = dataclasses.replace(configs.smoke("olmoe-1b-7b"),
                              param_dtype="bfloat16")
    p = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jmoe.init_moe(
        dataclasses.replace(jconfigs.smoke("olmoe-1b-7b"),
                            param_dtype="bfloat16"), jax.random.PRNGKey(0)))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in p.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert p["router"].dtype == torch.float32
    assert p["w_gate"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# The model against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch):
    jcfg, jparams, tcfg, model = pair(arch)
    tok = np.random.default_rng(32).integers(0, tcfg.vocab, (2, 32))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    got = transformer.forward(model, tcfg, torch.from_numpy(tok))
    assert got.shape == want.shape == (2, 32, tcfg.vocab_padded)
    _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_reference(arch):
    """16 steps with the cache carried (one slot an expert a step: C 1 at
    B 2); logits each step, every layer's KV cache after the last."""
    jcfg, jparams, tcfg, model = pair(arch)
    toks = np.random.default_rng(16).integers(0, tcfg.vocab, (2, 16))
    jcache = jtr.init_cache(jcfg, 2, 20)
    tcache = transformer.init_cache(tcfg, 2, 20, device="cpu")
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(tok, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(tok))
        _close(got, want, SCAN_TOL)
    for layer, c in enumerate(tcache):
        for name in ("k", "v"):
            _close(c[name], jcache["stage0"]["b0"][name][layer], SCAN_TOL)
        assert c["len"] == 16


@pytest.mark.parametrize("arch", MOE)
def test_engine_generate_greedy_matches_reference(arch):
    jcfg, jparams, tcfg, model = pair(arch)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 5))
    want = JEngine(jparams, jcfg, JServeConfig(3, 16)).generate(
        jnp.asarray(prompt, jnp.int32), 8)
    got = Engine(model, tcfg, ServeConfig(3, 16), device="cpu").generate(
        torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_without_drops(arch):
    """At a capacity factor of 16 nothing drops, and the decode path
    (one token a step through the KV cache) gives ``forward``'s logits
    (the reference's ``test_moe_decode_matches_forward_without_drops``,
    here in float32 at ``SCAN_TOL``); at the default factor decode drops
    pairs that the prefill keeps, and the two differ."""
    for cf, same in ((16.0, True), (None, False)):
        _, _, tcfg, model = pair(arch, cf)
        tok = torch.from_numpy(np.random.default_rng(17).integers(
            0, tcfg.vocab, (2, 16)))
        want = transformer.forward(model, tcfg, tok)
        cache = transformer.init_cache(tcfg, 2, 16, device="cpu")
        outs = []
        for t in range(16):
            lg, cache = transformer.decode_step(model, cache, tcfg,
                                                tok[:, t:t + 1])
            outs.append(lg)
        got = torch.cat(outs, dim=1)
        assert torch.allclose(got, want, **SCAN_TOL) == same


@pytest.mark.parametrize("arch", MOE)
def test_engine_refuses_a_request_past_the_causal_cache(arch):
    """A ``moe`` layer's KV cache is causal: a request past ``max_len``
    is refused before any work."""
    _, _, tcfg, model = pair(arch)
    eng = Engine(model, tcfg, ServeConfig(2, 12), device="cpu")
    with pytest.raises(ValueError, match="max_len 12"):
        eng.generate(torch.zeros((2, 5), dtype=torch.long), 8)
    assert all(c["len"] == 0 for c in eng.cache)


# --------------------------------------------------------------------------
# One train step against the reference's jitted step
# --------------------------------------------------------------------------
def _grads(tcfg, like, start, batch):
    """The clipped gradients of one step from the parameters ``start``
    (``leaves`` order), read off a port AdamW step's first moment."""
    ocfg = OptimizerConfig(**LR_KW)
    params = unflatten(like, [x.clone() for x in start])
    state = {"params": params, "opt": opt_lib.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    new, _ = make_train_step(tcfg, ocfg)(state, batch)
    return [m / 0.1 for m in leaves(new["opt"]["m"])]


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(arch, name):
    """One ``make_train_step`` from the reference's state on the same
    batch (pairs dropped at the default capacity): the expert leaves are
    the first of stacked rank 4, (L, E, D, F); each layer's (E, D, F)
    takes weight decay and, under Adafactor, the reference's factoring
    over its last two dims (r (E, D), c (E, F)).

    Updated parameters: within 1e-6 where |g| >= 1e-6, within 2 lr
    elsewhere, but for one case under Adafactor: the router column of an
    expert that no token of the batch chose. Its gradient is zero but
    for float32 rounding (the renormalised top-k weights do not depend
    on an unchosen score), so its factored statistic is ~1e-22 on both
    sides, and Adafactor's update, g over the root of that statistic,
    is rounding noise scaled to ~lr on each side (8.5 lr was seen). Such
    columns must be the same on both sides; their values must be
    finite."""
    jcfg, tcfg = _f32(jconfigs.smoke(arch)), _f32(configs.smoke(arch))
    okw = dict(LR_KW, name=name)
    jocfg, tocfg = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jstate = jinit_state(jcfg, jocfg, jax.random.PRNGKey(0))
    tstate = interop.train_state_from_numpy(
        _np(jstate["params"]), _np(jstate["opt"]),
        np.asarray(jstate["step"]), tcfg, device="cpu")
    wg = tstate["params"]["stage0"]["b0"]["moe"]["w_gate"]
    assert len(wg) == tcfg.n_layers and wg[0].shape == (8, 128, 256)
    start = [x.clone() for x in leaves(tstate["params"])]
    jbatch = JSyntheticLM(jcfg, 2, 32, seed=0).next()
    tbatch = SyntheticLM(tcfg, 2, 32, seed=0, device="cpu").next()
    jnew, jm = jax.jit(jmake_train_step(jcfg, jocfg))(jstate, jbatch)
    tnew, tm = make_train_step(tcfg, tocfg)(tstate, tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-5)
    want = interop.train_state_from_numpy(
        _np(jnew["params"]), _np(jnew["opt"]), np.asarray(jnew["step"]),
        tcfg, device="cpu")
    lr = LR_KW["lr"]
    unchosen = {}
    if name == "adamw":
        gm = leaves(want["opt"]["m"])
        for a, b in zip(leaves(tnew["opt"]["m"]), gm):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
        for a, b in zip(leaves(tnew["opt"]["v"]), leaves(want["opt"]["v"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = [m / 0.1 for m in gm]
    else:
        f = tnew["opt"]["f"]["stage0"]["b0"]["moe"]
        assert f["w_gate"]["r"][0].shape == (8, 128)
        assert f["w_gate"]["c"][0].shape == (8, 256)
        for a, b in zip(leaves(tnew["opt"]["f"]), leaves(want["opt"]["f"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        wc = want["opt"]["f"]["stage0"]["b0"]["moe"]["router"]["c"]
        for p, a, b in zip(tnew["params"]["stage0"]["b0"]["moe"]["router"],
                           f["router"]["c"], wc):
            assert torch.equal(a < 1e-16, b < 1e-16)
            unchosen[id(p)] = b < 1e-16
        grads = _grads(tcfg, tnew["params"], start, tbatch)
    for a, b, g in zip(leaves(tnew["params"]), leaves(want["params"]),
                       grads):
        assert bool(torch.isfinite(a).all())
        d = (a - b).abs()
        if id(a) in unchosen:
            d = torch.where(unchosen[id(a)][None, :], 0, d)
        assert float(d.max()) <= 2 * lr
        assert float(torch.where(g.abs() >= 1e-6, d, 0).max()) <= 1e-6


# --------------------------------------------------------------------------
# Configs, init, param counts, the command lines
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_configs_and_param_counts_match_reference(arch):
    for get in ("smoke", "get_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert arch in configs.ARCHS
    cfg = configs.get_config(arch)
    assert transformer.layer_kinds(cfg) == ["moe"] * cfg.n_layers


@pytest.mark.parametrize("arch", MOE)
def test_init_model_tree_matches_reference(arch):
    """Names, shapes and dtypes of the port's init against the
    reference's tree (``moe/{router,w_gate,w_up,w_down}`` in place of
    ``mlp``), and the count of its elements."""
    cfg = jconfigs.smoke(arch)
    tree = jax.eval_shape(lambda: jtr.init_model(cfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "stage0":
            for i in range(leaf.shape[0]):
                want[".".join(["layers", str(i), *keys[2:]])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    model = transformer.init_model(configs.smoke(arch), 3, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    assert "layers.0.moe.w_down" in got and "layers.0.mlp.w_up" not in got
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--max-new", "5",
                      "--max-len", "8", "--seed", "1"])
    assert out.shape == (2, 5)
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


def test_launch_train_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                       "--steps", "2", "--batch", "2", "--seq", "32",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "done: step=2" in capsys.readouterr().out
