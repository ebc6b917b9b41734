"""The port's last three architectures against the JAX reference, on the
CPU: command-r-plus-104b (the parallel block: one shared LayerNorm,
attention and MLP side by side), paligemma-3b (a ``vlm``: stub image
embeddings prepended, a prefix mask over them, MQA with head_dim 256,
GeGLU) and whisper-large-v3 (an encoder-decoder: 2 + 2 layers at smoke
size, sinusoidal positions, QKV biases, GeLU, cross-attention), and the
int8 KV cache (``kv_quant``).

Inputs come from numpy seeds. The reference's ``init_model`` tree
crosses over as numpy through ``interop.model_params_from_numpy`` (the
encoder's stacked ``enc`` stage unstacked into ``Model.enc``), with the
leaves that init makes constant perturbed (the QKV biases are zero and
the norm scales one at init). Compute is float32 on both sides
(``compute_dtype="float32"``).

Tolerances (float32 both sides):
  * ``forward`` logits, ``encode`` and the cross caches: rtol = atol =
    1e-4 (``SCAN_TOL`` of ``tests/test_torch_dense.py``: matmuls over d
    128 and d_ff 256 and softmaxes summed in another order, through two
    or four layers; ~1e-6 is seen).
  * ``decode_step`` logits and caches: rtol = atol = 2e-5 (the same
    algebra, matmul and softmax order only).
  * greedy tokens: equal.
  * ``kv_quant`` decode: the int8 rows bitwise (each is round(x / s) of
    float32 values that agree to ~1e-7 relative; a flip would need x / s
    within ~1e-5 of a half-integer), the scales (amax / 127) rtol 1e-5,
    the logits rtol = atol = 2e-5.
  * one train step against the reference's jitted step: loss and grad
    norm rtol 2e-5; AdamW's moments rtol 1e-4 (atol 1e-7 / 1e-9);
    Adafactor's factored statistics rtol 1e-4, atol 1e-9; parameters
    within 1e-6 where |g| >= 1e-6, within 2 lr elsewhere (Adam's first
    step is sign-like where g is float32 noise) — the limits of
    ``tests/test_torch_moe.py`` — and after Adafactor's step within 1e-6
    plus 1e-4 of the update where |g| >= 1e-6 (see the test).
  * the sharded step against the single-device step: loss and grad norm
    rtol 1e-5, every leaf at the limits above; its loss against the
    reference's rtol 2e-5 (``tests/test_torch_sharded_train.py``'s). A
    step with a model-axis sum dropped, or paligemma's prefix mask
    replaced by a causal one, must miss the loss by more than 1e-4.
  * ``SyntheticLM`` batches: bitwise.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticLM as JSyntheticLM
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs, interop, sharding
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, transformer
from repro_torch.serving import Engine, ServeConfig
from repro_torch.training import (OptimizerConfig, SyntheticLM, init_state,
                                  make_train_step)
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.tree import leaves, unflatten

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_TOL = dict(rtol=2e-5, atol=2e-5)
FAMILIES = ("command-r-plus-104b", "paligemma-3b", "whisper-large-v3")
LR = 1e-3
OKW = dict(lr=LR, warmup_steps=1, total_steps=10)
ENC_LEN = 24                   # encoder frames of the smoke whisper cases


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def perturb(tree, seed):
    """The QKV biases (zero at init) and every norm scale (one)
    perturbed."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("bq", "bk", "bv"):
            a = a + rng.normal(0, 0.3, a.shape)
        elif name == "scale":
            a = a + rng.normal(0, 0.1, a.shape)
        return a.astype(np.float32)

    return walk(tree)


@functools.cache
def pair(arch, **kw):
    """(reference cfg, reference params, port cfg, port model) in f32,
    built once a case; ``kw`` replaces config fields on both sides."""
    jcfg, tcfg = _f32(jconfigs.smoke(arch), **kw), _f32(configs.smoke(arch),
                                                        **kw)
    tree = perturb(_np(jtr.init_model(jcfg, jax.random.PRNGKey(0))), 7)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            interop.model_params_from_numpy(tree, tcfg, device="cpu"))


def _inputs(cfg, b, seed, enc_len=ENC_LEN):
    """The extra model inputs of ``cfg`` from a numpy seed: (reference
    kwargs, port kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "vlm":
        name, n = "embeds", cfg.n_img_tokens
    elif cfg.kind == "audio":
        name, n = "enc_embeds", enc_len
    else:
        return {}, {}
    e = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    return {name: jnp.asarray(e)}, {name: torch.from_numpy(e)}


def _caches(jcfg, jparams, tcfg, model, b, max_len, jkw, tkw):
    """Fresh decode caches on both sides; an encoder-decoder's cross
    caches filled from the same frames."""
    enc_len = ENC_LEN if tcfg.n_enc_layers else 0
    jc = jtr.init_cache(jcfg, b, max_len, enc_len=enc_len)
    tc = transformer.init_cache(tcfg, b, max_len, device="cpu",
                                enc_len=enc_len)
    if tcfg.n_enc_layers:
        jc = jtr.build_cross_caches(jparams, jcfg, jkw["enc_embeds"], jc)
        tc = transformer.build_cross_caches(model, tcfg, tkw["enc_embeds"],
                                            tc)
    return jc, tc


def _self(c):
    return c["self"] if "self" in c else c


# --------------------------------------------------------------------------
# The model against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("b,s", [(2, 28), (1, 508)])
def test_forward_matches_reference(arch, b, s):
    """S + 4 image tokens of paligemma = 32 (one query chunk) or 512;
    whisper's encoder over ``ENC_LEN`` frames."""
    jcfg, jparams, tcfg, model = pair(arch)
    tok = np.random.default_rng(s).integers(0, tcfg.vocab, (b, s))
    jkw, tkw = _inputs(tcfg, b, s + 1)
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32), **jkw)
    got = transformer.forward(model, tcfg, torch.from_numpy(tok), **tkw)
    n_img = tcfg.n_img_tokens if tcfg.kind == "vlm" else 0
    assert got.shape == want.shape == (b, s + n_img, tcfg.vocab_padded)
    _close(got, want, SCAN_TOL)


def test_encode_and_cross_caches_match_reference():
    """whisper's encoder output over ``ENC_LEN`` frames and over 1024 (two
    query chunks of the bidirectional attention), and every decoder
    layer's cross keys and values."""
    jcfg, jparams, tcfg, model = pair("whisper-large-v3")
    for n in (ENC_LEN, 1024):
        jkw, tkw = _inputs(tcfg, 2, n, enc_len=n)
        want = jtr.encode(jparams, jkw["enc_embeds"], jcfg)
        got = transformer.encode(model, tkw["enc_embeds"], tcfg)
        _close(got, want, SCAN_TOL)
    jc, tc = _caches(jcfg, jparams, tcfg, model, 2, 8, *_inputs(tcfg, 2, 3))
    jcross = jc["stage0"]["b0"]["cross"]
    for layer, c in enumerate(tc):
        for name in ("k", "v"):
            assert c["cross"][name].shape == (2, ENC_LEN, tcfg.n_kv_heads,
                                              tcfg.hd)
            _close(c["cross"][name], jcross[name][layer], SCAN_TOL)
        assert c["cross"]["kv_len"] == int(jcross["kv_len"][layer]) == ENC_LEN
        assert c["self"]["len"] == 0


def test_sinusoidal_positions_match_reference():
    """Up to the last bit of the frequencies (each side's float32 ``exp``):
    an angle pos * 10000^(-i/d) then carries up to pos ulps of the
    frequency, so the limit grows with the position (2.4e-4 at 4095 is
    seen)."""
    for seq, d, off in ((7, 128, 0), (1, 1280, 4095), (33, 64, 100)):
        _close(transformer.sinusoidal_pos(seq, d, off),
               jtr.sinusoidal_pos(seq, d, off),
               dict(rtol=0, atol=1e-6 + (off + seq) * 2.0 ** -22))


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_reference(arch):
    """16 steps with the cache carried: logits each step, every layer's
    self-attention KV cache after the last (whisper's cross caches
    unchanged)."""
    jcfg, jparams, tcfg, model = pair(arch)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 16))
    jc, tc = _caches(jcfg, jparams, tcfg, model, 2, 20, *_inputs(tcfg, 2, 5))
    cross0 = [c.get("cross", {}).get("k") for c in tc]
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, jc = jtr.decode_step(jparams, jc, jcfg,
                                   jnp.asarray(tok, jnp.int32))
        got, tc = transformer.decode_step(model, tc, tcfg,
                                          torch.from_numpy(tok))
        _close(got, want, SAME_TOL)
    jb = _self(jc["stage0"]["b0"])
    for layer, c in enumerate(tc):
        for name in ("k", "v"):
            _close(_self(c)[name], jb[name][layer], SAME_TOL)
        assert _self(c)["len"] == int(jb["len"][layer]) == 16
        if cross0[layer] is not None:
            assert c["cross"]["k"] is cross0[layer]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_generate_greedy_matches_reference(arch):
    jcfg, jparams, tcfg, model = pair(arch)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 5))
    jkw, tkw = _inputs(tcfg, 3, 9)
    want = JEngine(jparams, jcfg, JServeConfig(3, 16),
                   enc_embeds=jkw.get("enc_embeds")).generate(
        jnp.asarray(prompt, jnp.int32), 8)
    got = Engine(model, tcfg, ServeConfig(3, 16), device="cpu",
                 enc_embeds=tkw.get("enc_embeds")).generate(
        torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_last_equals_engine_prefill(arch):
    """The prefill (``forward``) and the decode path through the caches
    give the same last-position logits. paligemma decodes causally, as
    the reference does, so only its copy without image tokens
    (``n_img_tokens`` 0: no prefix) agrees; whisper's engine builds its
    cross caches from the same frames ``forward`` encodes."""
    kw = dict(n_img_tokens=0) if arch == "paligemma-3b" else {}
    _, _, tcfg, model = pair(arch, **kw)
    prompt = torch.from_numpy(
        np.random.default_rng(9).integers(0, tcfg.vocab, (2, 24)))
    _, tkw = _inputs(tcfg, 2, 10)
    want = transformer.forward(model, tcfg, prompt, **tkw)[:, -1]
    got = Engine(model, tcfg, ServeConfig(2, 24), device="cpu",
                 enc_embeds=tkw.get("enc_embeds")).prefill(prompt)[:, -1]
    torch.testing.assert_close(got, want, **SCAN_TOL)


def test_paligemma_prefix_mask_matters(monkeypatch):
    """paligemma's image tokens attend to each other both ways: a
    causal-mask variant of its forward misses the reference at the text
    positions too."""
    jcfg, jparams, tcfg, model = pair("paligemma-3b")
    tok = np.random.default_rng(12).integers(0, tcfg.vocab, (2, 12))
    jkw, tkw = _inputs(tcfg, 2, 13)
    want = np.asarray(jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32),
                                  **jkw))
    monkeypatch.setattr(transformer, "_attn_mask_kind",
                        lambda cfg, kind: ("causal", 0))
    causal = transformer.forward(model, tcfg, torch.from_numpy(tok), **tkw)
    assert np.abs(causal.numpy() - want)[:, tcfg.n_img_tokens:].max() > 1e-3


# --------------------------------------------------------------------------
# The int8 KV cache
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES + ("recurrentgemma-9b",))
def test_kv_quant_decode_matches_reference(arch):
    """8 decode steps with ``kv_quant``: every step's logits, and after
    the last every layer's int8 rows (bitwise) and scales; the cache's
    layout (int8 rows, a float32 scale a position and KV head).
    recurrentgemma's local layers keep a ring buffer of 16 slots: 20
    steps wrap it."""
    jcfg, jparams, tcfg, model = pair(arch, kv_quant=True)
    n = 20 if arch == "recurrentgemma-9b" else 8
    toks = np.random.default_rng(14).integers(0, tcfg.vocab, (2, n))
    jc, tc = _caches(jcfg, jparams, tcfg, model, 2, 24, *_inputs(tcfg, 2, 15))
    for i in range(n):
        tok = toks[:, i:i + 1]
        want, jc = jtr.decode_step(jparams, jc, jcfg,
                                   jnp.asarray(tok, jnp.int32))
        got, tc = transformer.decode_step(model, tc, tcfg,
                                          torch.from_numpy(tok))
        _close(got, want, SAME_TOL)
    kinds = transformer.layer_kinds(tcfg)
    seen = 0
    for s, (pat, rep) in enumerate(tcfg.stages()):
        for c in range(rep):
            for j, kind in enumerate(pat):
                layer = seen + c * len(pat) + j
                if kinds[layer] == "rec":
                    continue
                mine = _self(tc[layer])
                ref = _self(jc[f"stage{s}"][f"b{j}"])
                for name in ("k", "v"):
                    assert mine[name].dtype == torch.int8
                    assert mine[f"{name}_scale"].shape == \
                        mine[name].shape[:3] + (1,)
                    np.testing.assert_array_equal(mine[name].numpy(),
                                                  np.asarray(ref[name][c]))
                    _close(mine[f"{name}_scale"], ref[f"{name}_scale"][c],
                           dict(rtol=1e-5, atol=0))
        seen += rep * len(pat)


def test_quantize_rows_matches_reference():
    """``_quantize_rows`` on rows with exact ties (x / s = n + 1/2), an
    all-zero row (the 1e-8 floor) and bf16 input."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, 1, 3, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 0, 1, :4] = [127.0, 0.5, -1.5, 2.5]
    x[1, 0, 1, 4:] = 0.0
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        q, s = layers._quantize_rows(torch.from_numpy(x).to(dt))
        jq, js = jlayers._quantize_rows(jnp.asarray(x, jdt))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0, 0]) == pytest.approx(1e-8)


def test_kv_quant_cache_refuses_past_its_end():
    """The int8 causal cache is refused when full, like the float one."""
    _, _, tcfg, model = pair("command-r-plus-104b", kv_quant=True)
    eng = Engine(model, tcfg, ServeConfig(1, 6), device="cpu")
    with pytest.raises(ValueError, match="max_len 6"):
        eng.generate(torch.zeros((1, 3), dtype=torch.long), 4)
    eng.generate(torch.zeros((1, 3), dtype=torch.long), 3)
    with pytest.raises(ValueError, match="full"):
        layers.attention_decode(model.layers[0].attn,
                                torch.zeros((1, 1, tcfg.d_model)),
                                eng.cache[0], tcfg)


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_synthetic_batches_bitwise_reference(arch):
    """tokens, targets and the stub ``embeds`` / ``enc_embeds`` (bf16,
    the smoke configs' compute dtype), three steps and a resume."""
    cfg, jcfg = configs.smoke(arch), jconfigs.smoke(arch)
    mine, theirs = (SyntheticLM(cfg, 2, 16, seed=7, device="cpu"),
                    JSyntheticLM(jcfg, 2, 16, seed=7))
    for _ in range(3):
        a, b = mine.next(), theirs.next()
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ("tokens", "targets"):
                assert a[k].dtype == torch.int32
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
            else:
                assert a[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    a[k].view(torch.int16).numpy(),
                    np.asarray(b[k]).view(np.int16))
    n_txt = 16 - (cfg.n_img_tokens if cfg.kind == "vlm" else 0)
    assert a["tokens"].shape == (2, n_txt)
    resumed = SyntheticLM(cfg, 2, 16, seed=7, device="cpu")
    resumed.set_state({"step": 2, "seed": 7})
    np.testing.assert_array_equal(resumed.next()["tokens"].numpy(),
                                  a["tokens"].numpy())


def _states(arch, name, **kw):
    jcfg, tcfg = _f32(jconfigs.smoke(arch), **kw), _f32(configs.smoke(arch),
                                                        **kw)
    jstate = jinit_state(jcfg, JOptimizerConfig(name=name, **OKW),
                         jax.random.PRNGKey(0))

    def fresh():
        return interop.train_state_from_numpy(
            _np(jstate["params"]), _np(jstate["opt"]),
            np.asarray(jstate["step"]), tcfg, device="cpu")

    return jcfg, tcfg, jstate, fresh


def _grads(tcfg, like, start, batch):
    """The clipped gradients of one step from the parameters ``start``
    (``leaves`` order), read off a port AdamW step's first moment."""
    ocfg = OptimizerConfig(**OKW)
    params = unflatten(like, [x.clone() for x in start])
    state = {"params": params, "opt": opt_lib.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    new, _ = make_train_step(tcfg, ocfg)(state, batch)
    return [m / 0.1 for m in leaves(new["opt"]["m"])]


def _check_params(new, want, grads, exempt=(), start=None):
    """Updated parameters at the module's limits; the tensors in
    ``exempt`` (by ``id``) only finite on both sides. With ``start`` (the
    parameters before an Adafactor step) the limit where |g| >= 1e-6 is
    1e-6 plus 1e-4 of the reference's update there."""
    starts = leaves(start) if start is not None else [None] * len(grads)
    for a, b, g, s0 in zip(leaves(new), leaves(want), grads, starts):
        if id(a) in exempt:
            assert bool(torch.isfinite(a).all() & torch.isfinite(b).all())
            continue
        d = (a - b).abs()
        assert float(d.max()) <= 2 * LR
        lim = 1e-6 if s0 is None else 1e-6 + 1e-4 * (b - s0).abs()
        assert bool((torch.where(g.abs() >= 1e-6, d, 0) <= lim).all())


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_reference(arch, name):
    """One ``make_train_step`` from the reference's state on the same
    batch (paligemma's loss over its 28 text positions, whisper's
    encoder stacked as ``enc`` in both states): loss, grad norm and
    every leaf of the updated state, but for whisper's key biases under
    Adafactor. Their gradient is zero but for float32 rounding (a
    softmax does not change when one vector is added to every key: q .
    bk is the same for all of them); Adafactor's factored statistic of
    such a leaf, r c of ~1e-30 values, underflows to 0 on both sides and
    its update divides rounding noise by 1e-30. Those leaves (every
    gradient below 1e-9, the 6 ``bk`` tensors) must be finite. Adafactor
    divides g by a factored RMS that can be far below |g| (whisper's
    decoder ``wk`` moves by up to 37 lr), so its update carries g's
    relative error (the moments' 1e-4) times its own size: the
    parameters' limit adds 1e-4 of the update."""
    jcfg, tcfg, jstate, fresh = _states(arch, name)
    tstate = fresh()
    if tcfg.n_enc_layers:
        wq = tstate["params"]["enc"]["b0"]["attn"]["wq"]
        assert len(wq) == tcfg.n_enc_layers
    start = [x.clone() for x in leaves(tstate["params"])]
    jbatch = JSyntheticLM(jcfg, 2, 32, seed=0).next()
    tbatch = SyntheticLM(tcfg, 2, 32, seed=0, device="cpu").next()
    jnew, jm = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(
        name=name, **OKW)))(jstate, jbatch)
    tnew, tm = make_train_step(tcfg, OptimizerConfig(name=name, **OKW))(
        tstate, tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-5)
    want = interop.train_state_from_numpy(
        _np(jnew["params"]), _np(jnew["opt"]), np.asarray(jnew["step"]),
        tcfg, device="cpu")
    if name == "adamw":
        gm = leaves(want["opt"]["m"])
        for a, b in zip(leaves(tnew["opt"]["m"]), gm):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
        for a, b in zip(leaves(tnew["opt"]["v"]), leaves(want["opt"]["v"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = [m / 0.1 for m in gm]
        exempt, before = (), None
    else:
        for a, b in zip(leaves(tnew["opt"]["f"]), leaves(want["opt"]["f"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = _grads(tcfg, tnew["params"], start, tbatch)
        exempt = {id(a) for a, g in zip(leaves(tnew["params"]), grads)
                  if float(g.abs().max()) < 1e-9}
        assert len(exempt) == (6 if arch == "whisper-large-v3" else 0)
        before = unflatten(tnew["params"], start)
    _check_params(tnew["params"], want["params"], grads, exempt, before)


# --------------------------------------------------------------------------
# Sharded training
# --------------------------------------------------------------------------
def _ctx(shape):
    axes = ("data", "model")[:len(shape)]
    return sharding.make_ctx(make_mesh(shape, axes,
                                       ["cpu"] * math.prod(shape)))


def _masked(batch):
    batch["targets"][0, -12:] = -1
    return batch


def _ref_loss(jcfg, jstate):
    jbatch = JSyntheticLM(jcfg, 4, 32, seed=0).next()
    jbatch = dict(jbatch, targets=np.array(jbatch["targets"]))
    jbatch["targets"][0, -12:] = -1
    _, jm = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(**OKW)))(
        jstate, jbatch)
    return float(jm["loss"])


def _sharded(tcfg, fresh, shape):
    batch = _masked(SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next())
    ocfg = OptimizerConfig(**OKW)
    one, m1 = make_train_step(tcfg, ocfg)(
        fresh(), {k: v.clone() for k, v in batch.items()})
    with sharding.use(_ctx(shape)):
        two, m2 = make_train_step(tcfg, ocfg)(fresh(), batch)
    assert sharding.is_sharded(two["params"])
    return one, m1, sharding.gather(two), m2


SHARDED = [("command-r-plus-104b", (2, 2)), ("paligemma-3b", (2, 2)),
           ("whisper-large-v3", (2, 1)), ("whisper-large-v3", (2, 2))]


@pytest.mark.parametrize("arch,shape", SHARDED)
def test_sharded_step_matches_single_device_and_reference(arch, shape):
    """One AdamW step over (data 2, model 2) for command-r (one sum of
    the parallel block's two partials a layer; 4 heads and 2 KV heads
    split over the model axis) and paligemma (its one KV head replicated,
    the prefix mask on each model shard), for whisper over (data 2)
    (dp + fsdp, its encoder's leaves stacked) and over (data 2, model 2)
    (the encoder's bidirectional blocks over the axis, each shard's
    cross-attention on its replica of the encoder's output with 2 of
    the 4 heads, their partials of ``wo`` summed): every gathered leaf
    against the single-device step, the loss against the reference's."""
    jcfg, tcfg, jstate, fresh = _states(arch, "adamw")
    one, m1, two, m2 = _sharded(tcfg, fresh, shape)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    assert int(two["step"]) == int(one["step"]) == 1
    gm = leaves(one["opt"]["m"])
    for a, b in zip(leaves(two["opt"]["m"]), gm):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    for a, b in zip(leaves(two["opt"]["v"]), leaves(one["opt"]["v"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
    _check_params(two["params"], one["params"], [m / 0.1 for m in gm])
    np.testing.assert_allclose(float(m2["loss"]), _ref_loss(jcfg, jstate),
                               rtol=2e-5)


@pytest.mark.parametrize("arch,hook", [
    ("command-r-plus-104b", "sum_heads"),
    ("paligemma-3b", "sum_heads"), ("paligemma-3b", "sum_ff"),
    ("whisper-large-v3", "sum_heads"), ("whisper-large-v3", "sum_xattn")])
def test_dropping_a_model_axis_sum_fails(arch, hook, monkeypatch):
    """Without the sum over the model axis the (2, 2) step's loss misses
    the single-device loss: command-r's one sum takes both partials of
    its parallel block; whisper's ``sum_heads`` serves its encoder's and
    decoder's self-attention, ``sum_xattn`` its cross-attention."""
    _, tcfg, _, fresh = _states(arch, "adamw")
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()
    ocfg = OptimizerConfig(**OKW)
    _, m1 = make_train_step(tcfg, ocfg)(fresh(), dict(batch))
    monkeypatch.setattr(transformer, hook, lambda parts: parts)
    with sharding.use(_ctx((2, 2))):
        _, m2 = make_train_step(tcfg, ocfg)(fresh(), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) > 1e-4


def test_sharded_paligemma_needs_the_prefix_mask(monkeypatch):
    """The sharded step under a causal mask (the block's default before
    the prefix mask was carried into the model-axis path) misses the
    reference's loss: the check above would catch a sharded paligemma
    that trains the wrong function."""
    jcfg, tcfg, jstate, fresh = _states("paligemma-3b", "adamw")
    want = _ref_loss(jcfg, jstate)
    monkeypatch.setattr(transformer, "_attn_mask_kind",
                        lambda cfg, kind: ("causal", 0))
    _, _, _, m2 = _sharded(tcfg, fresh, (2, 2))
    assert abs(float(m2["loss"]) - want) > 1e-4


def test_model_axis_refuses_the_encoder_decoder():
    """A model axis refuses none of the three: whisper under (model 2)
    alone places its state and steps as the single device does (its
    encoder over the axis), and ``check_tp`` passes command-r and
    paligemma."""
    _, tcfg, _, fresh = _states("whisper-large-v3", "adamw")
    ocfg = OptimizerConfig(**OKW)
    with sharding.use(_ctx((1, 2))):
        placed = init_state(tcfg, ocfg, device="cpu")
    assert sharding.is_sharded(placed["params"])
    one, m1, two, m2 = _sharded(tcfg, fresh, (1, 2))
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    gm = leaves(one["opt"]["m"])
    for a, b in zip(leaves(two["opt"]["m"]), gm):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    _check_params(two["params"], one["params"], [m / 0.1 for m in gm])
    for arch in ("command-r-plus-104b", "paligemma-3b"):
        transformer.check_tp(configs.smoke(arch), 2)


def test_sharded_step_refuses_an_encoder_length_first(monkeypatch):
    """A sharded whisper step whose encoder input (600 frames: more than
    one 512-query chunk and no multiple of it) the chunk loop cannot
    take is refused before any block runs, as the single-device
    ``forward`` refuses it."""
    _, tcfg, _, fresh = _states("whisper-large-v3", "adamw")
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()
    batch["enc_embeds"] = torch.zeros((4, 600, tcfg.d_model))
    ran = []
    block = transformer.apply_block_tp
    monkeypatch.setattr(transformer, "apply_block_tp",
                        lambda *a, **k: ran.append(1) or block(*a, **k))
    with pytest.raises(ValueError, match="query chunk"):
        transformer.forward(transformer.unstack_layers(
            tcfg, fresh()["params"]), tcfg, batch["tokens"],
            enc_embeds=batch["enc_embeds"])
    with sharding.use(_ctx((2, 2))):
        step = make_train_step(tcfg, OptimizerConfig(**OKW))
        with pytest.raises(ValueError, match="query chunk"):
            step(fresh(), batch)
    assert ran == []


def _norm(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _compare_params(jtree, ttree) -> int:
    """Every port spec (one a layer for a stacked leaf) equal to the
    reference's (its leading layer entry dropped); returns the count."""
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
    return 1


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_param_sharding_tree_matches_reference(arch, shape):
    """Every leaf's spec, whisper's ``enc`` stage stacked (the
    reference's ``param_tags`` drops its layer axis as a stage's)."""
    axes = ("data", "model")
    jctx = jsh.make_ctx(AbstractMesh(shape, axes))
    tctx = sharding.make_ctx(make_mesh(shape, axes,
                                       ["cpu"] * math.prod(shape)))
    jst = jax.eval_shape(lambda: jinit_state(
        jconfigs.smoke(arch), JOptimizerConfig(), jax.random.PRNGKey(0)))
    tst = init_state(configs.smoke(arch), OptimizerConfig(), device="cpu")
    jt = jsh.param_sharding_tree(jst["params"], jctx)
    tt = sharding.param_sharding_tree(tst["params"], tctx)
    assert _compare_params(jt, tt) == len(leaves(tst["params"]))
    if arch == "whisper-large-v3":
        assert len(tt["enc"]["b0"]["attn"]["wq"]) == 2


# --------------------------------------------------------------------------
# Configs, init, the command lines
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_and_param_counts_match_reference(arch):
    for get in ("smoke", "get_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_model_tree_matches_reference(arch):
    """Names, shapes and dtypes of the port's init against the
    reference's tree: the shared ``ln`` of command-r's parallel block,
    whisper's ``lnx`` / ``xattn`` and ``enc`` / ``enc_ln_f``; the count
    of elements."""
    cfg = jconfigs.smoke(arch)
    tree = jax.eval_shape(lambda: jtr.init_model(cfg, jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("stage0", "enc"):
            top = "layers" if keys[0] == "stage0" else "enc"
            for i in range(leaf.shape[0]):
                want[".".join([top, str(i), *keys[2:]])] = (
                    leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    model = transformer.init_model(configs.smoke(arch), 3, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(tree))
    if arch == "command-r-plus-104b":
        assert "layers.0.ln.scale" in got and "layers.0.ln1.scale" not in got


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--max-new", "5",
                      "--max-len", "8", "--seed", "1"])
    assert out.shape == (2, 5)
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_cpu(arch, tmp_path, capsys):
    launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                       "2", "--seq", "32", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)])
    assert "done: step=2" in capsys.readouterr().out


def test_engine_needs_the_encoder_input():
    _, _, tcfg, model = pair("whisper-large-v3")
    with pytest.raises(ValueError, match="needs enc_embeds"):
        Engine(model, tcfg, ServeConfig(1, 8), device="cpu")
    with pytest.raises(ValueError, match="the encoder needs enc_embeds"):
        transformer.forward(model, tcfg, torch.zeros((1, 4),
                                                     dtype=torch.long))
