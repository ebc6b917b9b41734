"""The port's RecurrentGemma slice against the JAX reference, on the CPU.

Inputs come from numpy seeds. The reference's ``init_model`` tree crosses
over as numpy through ``interop.model_params_from_numpy``, with the leaves
that init makes constant perturbed (the gate and conv biases are zero and
the norm scales one at init, which would hide a swapped or dropped bias).
Compute is float32 on both sides (``compute_dtype="float32"``).

On the CPU the ``lru_scan`` wrapper runs its plain version; the CUDA
kernel is held against that by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.

Tolerances (float32 both sides):
  * ``lru_scan`` plain against ``ops.lru_scan(interpret=True)`` and
    ``ref.lru_scan_ref``: rtol = atol = 1e-5 — the same sequential
    recurrence, the multiply and add possibly fused into one rounding on
    one side (the reference kernel tests allow 2e-3).
  * ``apply_rglru``, ``forward`` logits: rtol = atol = 1e-4 — the
    reference evaluates the recurrence with ``lax.associative_scan`` (a
    log-depth tree of products and sums), the port step by step, so the
    state differs by a few float32 roundings of its size; and the
    matmuls sum in another order.
  * Everything else (conv, gates, RoPE, masks, attention prefill and
    decode, MLP, decode steps; the same algebra, matmul and softmax
    order only): rtol = atol = 2e-5.
  * greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops, ref
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtr
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import configs, interop
from repro_torch.kernels import lru_scan as klru
from repro_torch.launch import serve
from repro_torch.models import layers, rglru, transformer
from repro_torch.models.common import Params
from repro_torch.serving import Engine, ServeConfig

LRU_TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "recurrentgemma-9b"


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def perturb(tree, seed):
    """Perturb the leaves that init makes constant: the RG-LRU's gate and
    conv biases (zero) and every norm scale (one)."""
    rng = np.random.default_rng(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("b_a", "b_x", "conv_b"):
            a = a + rng.normal(0, 0.3, a.shape)
        elif name == "scale":
            a = a + rng.normal(0, 0.1, a.shape)
        return a.astype(np.float32)

    return walk(tree)


def _pair(cfg_j, cfg_t, seed=0):
    tree = perturb(jax.tree.map(np.asarray, jtr.init_model(
        cfg_j, jax.random.PRNGKey(seed))), 7 + seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = interop.model_params_from_numpy(tree, cfg_t, device="cpu")
    return tree, jparams, model


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) in f32:
    the smoke config, layers (rec, rec, local) x 2, window 16."""
    jcfg = _f32(jconfigs.smoke(ARCH))
    tcfg = _f32(configs.smoke(ARCH))
    _, jparams, model = _pair(jcfg, tcfg)
    return jcfg, jparams, tcfg, model


def _block(jparams, j, c=0):
    """The reference's block ``b{j}`` of stage 0, cycle ``c``."""
    return jax.tree.map(lambda a: a[c], jparams["stage0"][f"b{j}"])


# --------------------------------------------------------------------------
# lru_scan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,d,chunk", [
    (1, 32, 8, 8), (2, 64, 16, 16), (3, 128, 32, 32), (2, 64, 128, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_lru_scan_plain_matches_reference(b, t, d, chunk, dtype):
    """The reference kernel tests' shapes and inputs."""
    rng = np.random.default_rng(b * t)
    a = rng.uniform(0.3, 0.999, (b, t, d)).astype(dtype)
    x = rng.standard_normal((b, t, d)).astype(dtype)
    before = dict(klru.LAUNCHES)
    got = klru.lru_scan(_t(a), _t(x))
    assert klru.LAUNCHES == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    ja, jx = jnp.asarray(a), jnp.asarray(x)
    _close(got, ops.lru_scan(ja, jx, chunk=chunk, interpret=True), LRU_TOL)
    _close(got, ref.lru_scan_ref(ja, jx), LRU_TOL)


def test_lru_scan_launch_refuses_before_launching():
    """The CUDA path checks both arguments before it launches and never
    falls back to the plain version: on CPU tensors of a shape it takes
    it raises for the device."""
    rng = np.random.default_rng(0)

    def args(shape=(2, 8, 16), dtype=np.float32):
        return [_t(rng.uniform(0.3, 1, shape).astype(dtype)) for _ in "ax"]

    before = dict(klru.LAUNCHES)
    a, x = args()
    with pytest.raises(ValueError, match="of one shape"):
        klru._launch(a, x[:, :4])
    with pytest.raises(ValueError, match="of one shape"):
        klru._launch(a[0], x[0])
    with pytest.raises(ValueError, match="B <= 65535"):
        klru._launch(*args((65536, 1, 1)))
    with pytest.raises(TypeError, match="float32"):
        klru._launch(*args(dtype=np.float64))
    with pytest.raises(ValueError, match="contiguous"):
        klru._launch(a.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        klru._launch_bwd(a, x, x)
    with pytest.raises(ValueError, match="of one shape"):
        klru._launch_bwd(a, x, x[:, :4])
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        klru._launch(*args())
    with pytest.raises(ValueError, match="of one shape"):
        klru.lru_scan(*args()[:1], _t(np.zeros((2, 8, 15), np.float32)))
    assert klru.LAUNCHES == before


# --------------------------------------------------------------------------
# The RG-LRU block
# --------------------------------------------------------------------------
def test_conv1d_and_gates_match_reference(pair):
    """The causal conv without and with a carried state (its new state
    too), and the recurrence's (a, b)."""
    jcfg, jparams, tcfg, model = pair
    jp, tp = _block(jparams, 0)["rec"], model.layers[0].rec
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 12, tcfg.lru_width)).astype(np.float32)
    st = rng.standard_normal((2, 3, tcfg.lru_width)).astype(np.float32)
    for state in (None, st):
        want, wst = jrglru._conv1d(jp, jnp.asarray(u), jcfg,
                                   None if state is None
                                   else jnp.asarray(state))
        got, gst = rglru._conv1d(tp, _t(u), tcfg,
                                 None if state is None else _t(state))
        _close(got, want, SAME_TOL)
        _close(gst, wst, SAME_TOL)
    wa, wb = jrglru._gates(jp, jnp.asarray(u), jcfg)
    ga, gb = rglru._gates(tp, _t(u), tcfg)
    _close(ga, wa, SAME_TOL)
    _close(gb, wb, SAME_TOL)
    assert 0 < float(ga.min()) and float(ga.max()) < 1


@pytest.mark.parametrize("s", [8, 256])
def test_apply_rglru_matches_reference(pair, s):
    jcfg, jparams, tcfg, model = pair
    x = np.random.default_rng(s).standard_normal((2, s, tcfg.d_model)) \
        .astype(np.float32)
    want = jrglru.apply_rglru(_block(jparams, 1)["rec"], jnp.asarray(x), jcfg)
    got = rglru.apply_rglru(model.layers[1].rec, _t(x), tcfg)
    _close(got, want, SCAN_TOL)


def test_apply_rglru_decode_steps_match_reference(pair):
    """Ten one-token steps from a non-zero cache, the cache carried on
    both sides: output each step, state and conv window after the last."""
    jcfg, jparams, tcfg, model = pair
    jp, tp = _block(jparams, 0)["rec"], model.layers[0].rec
    rng = np.random.default_rng(2)
    w = tcfg.lru_width
    cache = {"h": rng.standard_normal((3, w)).astype(np.float32),
             "conv": rng.standard_normal((3, 3, w)).astype(np.float32)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: _t(v) for k, v in cache.items()}
    for _ in range(10):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        want, jc = jrglru.apply_rglru_decode(jp, jnp.asarray(x), jc, jcfg)
        got, tc = rglru.apply_rglru_decode(tp, _t(x), tc, tcfg)
        _close(got, want, SAME_TOL)
    _close(tc["h"], jc["h"], SAME_TOL)
    _close(tc["conv"], jc["conv"], SAME_TOL)
    assert tc["h"].dtype == torch.float32


# --------------------------------------------------------------------------
# Attention, RoPE, MLP
# --------------------------------------------------------------------------
def test_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.arange(100, 109)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(layers.apply_rope(_t(x), _t(pos), 1e4), want, SAME_TOL)


@pytest.mark.parametrize("kind", ["causal", "window", "prefix", "bidir"])
def test_mask_matches_reference(kind):
    q, k = np.arange(5, 17), np.arange(3, 20)
    want = jlayers._mask(kind, jnp.asarray(q), jnp.asarray(k), 4, 6)
    got = layers._mask(kind, _t(q), _t(k), 4, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mask,s,q_chunk", [
    ("window", 64, 8),       # band (16 + 8) < 64: the banded slice runs
    ("window", 16, 512),     # one chunk, no band
    ("causal", 64, 16),      # four chunks over every key
    ("causal", 24, 512)])
def test_attention_full_matches_reference(pair, mask, s, q_chunk):
    jcfg, jparams, tcfg, model = pair
    x = np.random.default_rng(s + q_chunk).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    want = jlayers.attention_full(_block(jparams, 2)["attn"], jnp.asarray(x),
                                  jcfg, mask=mask, q_chunk=q_chunk)
    got = layers.attention_full(model.layers[2].attn, _t(x), tcfg,
                                mask=mask, q_chunk=q_chunk)
    _close(got, want, SAME_TOL)


@pytest.mark.parametrize("mask,q_offset,use_rope", [
    ("prefix", 0, True), ("window", 5, True), ("bidir", 0, False)])
def test_attention_full_options_match_reference(pair, mask, q_offset,
                                                use_rope):
    """The prefix and bidirectional masks, a query offset, no RoPE."""
    jcfg, jparams, tcfg, model = pair
    x = np.random.default_rng(q_offset).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32)
    kw = dict(mask=mask, q_offset=q_offset, prefix_len=4, use_rope=use_rope)
    want = jlayers.attention_full(_block(jparams, 2)["attn"], jnp.asarray(x),
                                  jcfg, **kw)
    got = layers.attention_full(model.layers[2].attn, _t(x), tcfg, **kw)
    _close(got, want, SAME_TOL)


def test_attention_bias_and_qk_norm_match_reference():
    """The qkv-bias and qk-norm branches (no ported config takes them),
    with the biases and scales drawn non-zero: prefill and five decode
    steps."""
    jcfg, tcfg = (dataclasses.replace(_f32(m.smoke(ARCH)), qkv_bias=True,
                                      qk_norm=True)
                  for m in (jconfigs, configs))
    rng = np.random.default_rng(11)
    jp = {k: np.asarray(v) + (0 if k.startswith("w")
                              else rng.normal(0, 0.3, v.shape))
          for k, v in jlayers.init_attention(jcfg, jax.random.PRNGKey(1))
          .items()}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    tp = Params({k: _t(v) for k, v in jp.items()})
    assert set(jp) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_scale",
                       "k_scale"}
    x = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    _close(layers.attention_full(tp, _t(x), tcfg),
           jlayers.attention_full(jp, jnp.asarray(x), jcfg), SAME_TOL)
    jc = jlayers.make_attn_cache(jcfg, 2, 8)
    tc = layers.make_attn_cache(tcfg, 2, 8, "cpu")
    for i in range(5):
        xi = x[:, i:i + 1]
        want, jc = jlayers.attention_decode(jp, jnp.asarray(xi), jc, jcfg)
        got, tc = layers.attention_decode(tp, _t(xi), tc, tcfg)
        _close(got, want, SAME_TOL)


def test_attention_refuses_lengths_like_reference(pair):
    """Past one query chunk S must be a multiple of it: the reference
    fails reshaping its chunks, the port refuses before any work, at the
    layer (S 20, chunk 8) and through ``forward`` (S 600, chunk 512)."""
    jcfg, jparams, tcfg, model = pair
    x = np.zeros((1, 20, tcfg.d_model), np.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        jlayers.attention_full(_block(jparams, 2)["attn"], jnp.asarray(x),
                               jcfg, mask="window", q_chunk=8)
    with pytest.raises(ValueError, match="not a multiple"):
        layers.attention_full(model.layers[2].attn, _t(x), tcfg,
                              mask="window", q_chunk=8)
    tok = np.zeros((1, 600), np.int64)
    with pytest.raises(TypeError, match="cannot reshape"):
        jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    before = dict(klru.LAUNCHES)
    with pytest.raises(ValueError, match="S=600"):
        transformer.forward(model, tcfg, torch.from_numpy(tok))
    assert klru.LAUNCHES == before


def test_attention_decode_ring_buffer_wraps(pair):
    """Window 16, 40 steps: the ring buffer wraps twice. Output each
    step; the buffer and its length after the last."""
    jcfg, jparams, tcfg, model = pair
    jp, tp = _block(jparams, 2)["attn"], model.layers[2].attn
    jc = jlayers.make_attn_cache(jcfg, 2, 64, windowed=True)
    tc = layers.make_attn_cache(tcfg, 2, 64, "cpu", windowed=True)
    assert tc["k"].shape == (2, tcfg.window, 1, tcfg.hd)
    rng = np.random.default_rng(4)
    for _ in range(40):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        want, jc = jlayers.attention_decode(jp, jnp.asarray(x), jc, jcfg,
                                            mask="window")
        got, tc = layers.attention_decode(tp, _t(x), tc, tcfg, mask="window")
        _close(got, want, SAME_TOL)
    assert tc["len"] == int(jc["len"]) == 40
    _close(tc["k"], jc["k"], SAME_TOL)
    _close(tc["v"], jc["v"], SAME_TOL)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_apply_mlp_matches_reference(act):
    jcfg = dataclasses.replace(_f32(jconfigs.smoke(ARCH)), act=act)
    tcfg = dataclasses.replace(_f32(configs.smoke(ARCH)), act=act)
    jp = jax.tree.map(np.asarray, jlayers.init_mlp(jcfg,
                                                   jax.random.PRNGKey(5)))
    tp = Params({k: _t(v) for k, v in jp.items()})
    x = np.random.default_rng(5).standard_normal((2, 6, tcfg.d_model)) \
        .astype(np.float32)
    want = jlayers.apply_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                             jcfg)
    _close(layers.apply_mlp(tp, _t(x), tcfg), want, SAME_TOL)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [64, 1024])
def test_forward_matches_reference(pair, s):
    """S 64: one query chunk; S 1024: two chunks of 512, each against the
    (16 + 512)-key band."""
    jcfg, jparams, tcfg, model = pair
    tok = np.random.default_rng(s).integers(0, tcfg.vocab, (2, s))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    klru.reset_launch_counts()
    got = transformer.forward(model, tcfg, torch.from_numpy(tok))
    assert klru.LAUNCHES["lru_scan"] == 0     # plain version on the CPU
    assert got.shape == (2, s, tcfg.vocab_padded)
    _close(got, want, SCAN_TOL)


def test_decode_steps_match_reference(pair):
    """24 steps (the window of 16 wraps) with the cache carried; logits
    each step, every layer's cache after the last."""
    jcfg, jparams, tcfg, model = pair
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 24))
    jcache = jtr.init_cache(jcfg, 2, 32)
    tcache = transformer.init_cache(tcfg, 2, 32, device="cpu")
    jstep = jax.jit(lambda p, c, t: jtr.decode_step(p, c, jcfg, t))
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(tok))
        _close(got, want, SAME_TOL)
    kinds = transformer.layer_kinds(tcfg)
    for layer, (c, kind) in enumerate(zip(tcache, kinds)):
        jc = jcache["stage0"][f"b{layer % 3}"]
        names = ("h", "conv") if kind == "rec" else ("k", "v")
        for name in names:
            _close(c[name], jc[name][layer // 3], SAME_TOL)
        if kind == "local":
            assert c["len"] == int(jc["len"][layer // 3]) == 24


@pytest.mark.parametrize("stop", [False, True])
def test_engine_generate_greedy_matches_reference(pair, stop):
    """Greedy tokens equal; with ``stop`` the ``eos_id`` is a token the
    first row emits mid-way, so the done mask is exercised too."""
    jcfg, jparams, tcfg, model = pair
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 5))
    jp = jnp.asarray(prompt, jnp.int32)
    eos = -1
    if stop:
        eos = int(JEngine(jparams, jcfg, JServeConfig(3, 32))
                  .generate(jp, 8)[0, 3])
    want = JEngine(jparams, jcfg, JServeConfig(3, 32, eos_id=eos)) \
        .generate(jp, 8)
    got = Engine(model, tcfg, ServeConfig(3, 32, eos_id=eos),
                 device="cpu").generate(torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if stop:
        assert (got[0, 4:] == 0).all()


def test_forward_last_equals_engine_prefill(pair):
    """The kernel and prefill-attention path (``forward``) and the decode
    recurrence with the ring buffer (prefill, past the window) give the
    same last-position logits."""
    _, _, tcfg, model = pair
    prompt = torch.from_numpy(
        np.random.default_rng(9).integers(0, tcfg.vocab, (2, 40)))
    want = transformer.forward(model, tcfg, prompt)[:, -1]
    got = Engine(model, tcfg, ServeConfig(2, 64), device="cpu") \
        .prefill(prompt)[:, -1]
    torch.testing.assert_close(got, want, **SCAN_TOL)


# --------------------------------------------------------------------------
# Configs, init, interop, devices
# --------------------------------------------------------------------------
def test_configs_match_reference():
    for get in ("smoke", "get_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert dataclasses.asdict(getattr(configs, get)(ARCH)) == want
    cfg = configs.get_config(ARCH)
    assert transformer.layer_kinds(cfg).count("rec") == 26
    assert transformer.layer_kinds(cfg).count("local") == 12
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for name in jconfigs.ARCHS:       # all ten, field by field
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(jconfigs.get_config(name))


def _five_layers(mod):
    """A 5-layer config: two stages, (rec, rec, local) x 1 and (rec, rec)."""
    return dataclasses.replace(mod.smoke(ARCH), n_layers=5)


def test_init_model_tree_matches_reference():
    """Names, shapes and dtypes of the port's init against the
    reference's tree on a 5-layer config with two stages, each stacked
    stage unstacked into layers in order."""
    cfg = _five_layers(jconfigs)
    assert [(p, r) for p, r in cfg.stages()] == [
        (("rec", "rec", "local"), 1), (("rec", "rec"), 1)]
    tree = jax.eval_shape(lambda: jtr.init_model(cfg, jax.random.PRNGKey(0)))
    want, first = {}, 0
    for i, (pat, rep) in enumerate(cfg.stages()):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree[f"stage{i}"])[0]:
            keys = [p.key for p in path]
            j = int(keys[0][1:])
            for c in range(rep):
                want[".".join(["layers", str(first + c * len(pat) + j),
                               *keys[1:]])] = (leaf.shape[1:],
                                               str(leaf.dtype))
        first += rep * len(pat)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if not keys[0].startswith("stage"):
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    model = transformer.init_model(_five_layers(configs), 3, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    assert not any(p.requires_grad for p in model.parameters())
    lam = model.layers[0].rec.lam
    assert 0.9 <= float(lam.min()) and float(lam.max()) <= 0.999


def test_interop_unstacks_two_stages_in_order():
    """(rec, rec, local) x 1 then (rec, rec): layer i of the port holds
    the reference's stage/block/cycle slice of layer i, and the 5-layer
    model's forward and decode match the reference."""
    jcfg, tcfg = _f32(_five_layers(jconfigs)), _f32(_five_layers(configs))
    tree, jparams, model = _pair(jcfg, tcfg, seed=1)
    where = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    for layer, (i, j) in zip(model.layers, where):
        want = tree[f"stage{i}"][f"b{j}"]
        if "rec" in want:
            _close(layer.rec.w_a, want["rec"]["w_a"][0], dict(rtol=0, atol=0))
        else:
            _close(layer.attn.wq, want["attn"]["wq"][0], dict(rtol=0, atol=0))
    assert transformer.layer_kinds(tcfg) == ["rec", "rec", "local", "rec",
                                             "rec"]
    tok = np.random.default_rng(10).integers(0, tcfg.vocab, (2, 32))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    _close(transformer.forward(model, tcfg, torch.from_numpy(tok)), want,
           SCAN_TOL)
    jcache = jtr.init_cache(jcfg, 2, 8)
    tcache = transformer.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(2):
        t = tok[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(t, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(t))
        _close(got, want, SAME_TOL)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.smoke(ARCH)
    with pytest.raises(RuntimeError, match="no card"):
        transformer.init_model(cfg)
    with pytest.raises(RuntimeError, match="no card"):
        transformer.init_cache(cfg, 2, 32)
    model = transformer.init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no card"):
        Engine(model, cfg, ServeConfig(2, 16))
    tree = jax.tree.map(np.asarray,
                        jtr.init_model(jconfigs.smoke(ARCH),
                                       jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no card"):
        interop.model_params_from_numpy(tree, cfg)


def _variant_parity(steps=3, **kw):
    """``forward`` (S 32) and ``steps`` decode steps of the smoke config
    with ``kw`` replaced, against the reference."""
    jcfg = _f32(dataclasses.replace(jconfigs.smoke(ARCH), **kw))
    tcfg = _f32(dataclasses.replace(configs.smoke(ARCH), **kw))
    _, jparams, model = _pair(jcfg, tcfg, seed=2)
    tok = np.random.default_rng(21).integers(0, tcfg.vocab, (2, 32))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    _close(transformer.forward(model, tcfg, torch.from_numpy(tok)), want,
           SCAN_TOL)
    jcache = jtr.init_cache(jcfg, 2, 8)
    tcache = transformer.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(steps):
        t = tok[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(t, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(t))
        _close(got, want, SAME_TOL)
    return model, tcfg


def test_unported_paths_name_their_roadmap_item():
    """What this test once refused (ROADMAP item 12.4b, now ported),
    against the reference: a ``dec`` block beside ``rec`` and ``local``
    layers in a model without an encoder (the reference's prefill then
    cross-attends to the block's own input, its decode to an empty
    encoder cache: the port does the same), the parallel block's shared
    norm on the ``local`` layers, the int8 ring buffer (20 steps wrap
    its 16 slots), and a cross-attention decode over a cache without
    ``kv_len`` (all its slots read). Still refused: an attention layer's
    KV cache without ``max_len``."""
    cfg = configs.smoke(ARCH)
    for kinds in (("rec", "dec"), ("local", "dec")):
        model, tcfg = _variant_parity(block_pattern=kinds)
        assert "dec" in transformer.layer_kinds(tcfg)
    model, tcfg = _variant_parity(parallel_block=True)
    assert hasattr(model.layers[2], "ln") and hasattr(model.layers[0], "ln1")
    _variant_parity(steps=20, kv_quant=True)
    with pytest.raises(ValueError, match="needs max_len"):
        transformer.init_cache(cfg, 2, device="cpu")
    jcfg, tcfg = _f32(jconfigs.smoke(ARCH)), _f32(cfg)
    tree, jparams, model = _pair(jcfg, tcfg)
    rng = np.random.default_rng(22)
    k, v = (rng.standard_normal((1, 8, tcfg.n_kv_heads, tcfg.hd))
            .astype(np.float32) for _ in range(2))
    x = rng.standard_normal((1, 1, tcfg.d_model)).astype(np.float32)
    want, _ = jlayers.attention_decode(
        jax.tree.map(lambda a: jnp.asarray(a[0]),
                     tree["stage0"]["b2"]["attn"]),
        jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                         "len": jnp.zeros((), jnp.int32)}, jcfg,
        use_rope=False, cross=True)
    cache = {"k": torch.from_numpy(k), "v": torch.from_numpy(v), "len": 0}
    got, new = layers.attention_decode(model.layers[2].attn,
                                       torch.from_numpy(x), cache, tcfg,
                                       use_rope=False, cross=True)
    _close(got, want, SAME_TOL)
    assert new is cache


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--max-new", "20",
                      "--max-len", "32", "--seed", "1"])
    assert out.shape == (2, 20)
    assert "generated (2, 20) on cpu" in capsys.readouterr().out
