"""The port's dense attention family (tinyllama-1.1b, olmo-1b,
qwen2.5-3b: the ``attn`` block kind) and the CPD-factorized embedding in
a model, against the JAX reference, on the CPU.

Inputs come from numpy seeds. The reference's ``init_model`` tree
crosses over as numpy through ``interop.model_params_from_numpy``, with
the leaves that init makes constant perturbed (the QKV biases are zero
and the norm scales one at init, which would hide a dropped bias or
scale). Compute is float32 on both sides (``compute_dtype="float32"``).
``tinyllama-cpd`` is tinyllama's smoke config with ``cpd_embedding=True,
cpd_rank=16``: the embedding is ``cpd_embed`` and the tied head
``cpd_logits`` (512 -> 23 x 23 = 529 ids).

Tolerances (float32 both sides):
  * ``forward`` logits: rtol = atol = 1e-4 (matmuls over d 128 and d_ff
    256 and the softmax summed in another order, through two layers; the
    ``SCAN_TOL`` of ``tests/test_torch_rglru.py``).
  * the embedding's gradients through the model: rtol = 1e-4, atol =
    1e-5 of the largest gradient (each element is a sum of products of
    both signs over the logits and the layers, so its error scales with
    the largest terms, not with its own size; ~7e-7 of it is seen).
  * ``decode_step`` logits and caches: rtol = atol = 2e-5 (the same
    algebra, matmul and softmax order only).
  * greedy tokens: equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import transformer as jtr
from repro.models.common import ModelConfig as JModelConfig
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import configs, interop
from repro_torch.configs import shapes
from repro_torch.launch import serve
from repro_torch.models import layers, transformer
from repro_torch.models.common import ModelConfig
from repro_torch.serving import Engine, ServeConfig
from repro_torch.tensorized import dense_table

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_TOL = dict(rtol=2e-5, atol=2e-5)
DENSE = ("tinyllama-1.1b", "olmo-1b", "qwen2.5-3b")
CASES = DENSE + ("tinyllama-cpd",)


def _smoke(mod, case):
    if case == "tinyllama-cpd":
        return dataclasses.replace(mod.smoke("tinyllama-1.1b"),
                                   cpd_embedding=True, cpd_rank=16)
    return mod.smoke(case)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def perturb(tree, seed):
    """Perturb the leaves that init makes constant: the QKV biases (zero)
    and every norm scale (one)."""
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
def pair(case):
    """(reference cfg, reference params, port cfg, port model) in f32,
    built once a case."""
    jcfg, tcfg = _f32(_smoke(jconfigs, case)), _f32(_smoke(configs, case))
    tree = perturb(jax.tree.map(np.asarray, jtr.init_model(
        jcfg, jax.random.PRNGKey(0))), 7)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            interop.model_params_from_numpy(tree, tcfg, device="cpu"))


# --------------------------------------------------------------------------
# The model against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,s", [(2, 32), (1, 1024)])
def test_forward_matches_reference(case, b, s):
    """S 32: one query chunk; S 1024: two chunks of 512, the second
    against every key (the causal mask across chunks)."""
    jcfg, jparams, tcfg, model = pair(case)
    tok = np.random.default_rng(s).integers(0, tcfg.vocab, (b, s))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    got = transformer.forward(model, tcfg, torch.from_numpy(tok))
    assert got.shape == want.shape
    assert got.shape[-1] == (529 if tcfg.cpd_embedding else tcfg.vocab_padded)
    _close(got, want, SCAN_TOL)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_reference(case):
    """4 steps with the cache carried; logits each step, every layer's
    KV cache after the last."""
    jcfg, jparams, tcfg, model = pair(case)
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 4))
    jcache = jtr.init_cache(jcfg, 2, 8)
    tcache = transformer.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(tok, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(tok))
        _close(got, want, SAME_TOL)
    for layer, c in enumerate(tcache):
        jc = jcache["stage0"]["b0"]
        for name in ("k", "v"):
            assert c[name].shape == (2, 8, tcfg.n_kv_heads, tcfg.hd)
            _close(c[name], jc[name][layer], SAME_TOL)
        assert c["len"] == int(jc["len"][layer]) == 4


@pytest.mark.parametrize("case", CASES)
def test_engine_generate_greedy_matches_reference(case):
    jcfg, jparams, tcfg, model = pair(case)
    prompt = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 5))
    want = JEngine(jparams, jcfg, JServeConfig(3, 16)).generate(
        jnp.asarray(prompt, jnp.int32), 8)
    got = Engine(model, tcfg, ServeConfig(3, 16), device="cpu").generate(
        torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", CASES)
def test_forward_last_equals_engine_prefill(case):
    """The prefill attention (``forward``) and the decode path through
    the causal KV cache give the same last-position logits."""
    _, _, tcfg, model = pair(case)
    prompt = torch.from_numpy(
        np.random.default_rng(9).integers(0, tcfg.vocab, (2, 24)))
    want = transformer.forward(model, tcfg, prompt)[:, -1]
    got = Engine(model, tcfg, ServeConfig(2, 24), device="cpu") \
        .prefill(prompt)[:, -1]
    torch.testing.assert_close(got, want, **SCAN_TOL)


@pytest.mark.parametrize("case", ["tinyllama-1.1b", "tinyllama-cpd"])
def test_embedding_grads_through_the_model_match_reference(case):
    """The embedding's gradients of a loss on ``forward``'s logits: the
    CPD factors' (the spMTTKRP backward as an LM layer) or the dense
    table's, against ``jax.grad`` of the reference's forward."""
    jcfg, jparams, tcfg, model = pair(case)
    tok = np.random.default_rng(11).integers(0, tcfg.vocab, (2, 16))
    w = np.random.default_rng(12).standard_normal(
        (2, 16, 529 if tcfg.cpd_embedding else tcfg.vocab_padded)) \
        .astype(np.float32)
    key = "embed_cpd" if tcfg.cpd_embedding else "embed"

    def jloss(sub):
        logits = jtr.forward({**jparams, key: sub}, jcfg,
                             jnp.asarray(tok, jnp.int32))
        return jnp.sum(logits * w)

    want = jax.grad(jloss)(jparams[key])
    leaves = dict(getattr(model, key).named_parameters()) \
        if tcfg.cpd_embedding else {"": model.embed}
    try:
        for p in leaves.values():
            p.requires_grad_(True)
        logits = transformer.forward(model, tcfg, torch.from_numpy(tok))
        (logits * torch.from_numpy(w)).sum().backward()
        for name, p in leaves.items():
            g = np.asarray(want[name] if name else want)
            _close(p.grad, g, dict(rtol=1e-4, atol=1e-5 * np.abs(g).max()))
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
            p.grad = None


def test_head_matrix_matches_reference():
    for case in CASES:
        jcfg, jparams, tcfg, model = pair(case)
        want = jtr.head_matrix(jparams, jcfg)
        got = transformer.head_matrix(model, tcfg)
        _close(got, want, dict(rtol=1e-5, atol=1e-6))
    _, _, tcfg, model = pair("tinyllama-cpd")
    assert torch.equal(transformer.head_matrix(model, tcfg),
                       dense_table(model.embed_cpd).T)


# --------------------------------------------------------------------------
# Configs, shapes, init, param counts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    for get in ("smoke", "get_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        assert dataclasses.asdict(getattr(configs, get)(arch)) == want
    cfg = configs.get_config(arch)
    assert set(transformer.layer_kinds(cfg)) == {"attn"}
    assert len(transformer.layer_kinds(cfg)) == cfg.n_layers


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("size", ["smoke", "get_config"])
def test_param_count_matches_reference(arch, size):
    """``param_count`` and ``active_param_count`` of all ten of the
    reference's archs, full and smoke (built field by field from the
    reference's config: the unported ones have no port config)."""
    jcfg = getattr(jconfigs, size)(arch)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(JModelConfig)})
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    if arch in configs.ARCHS:
        assert cfg == getattr(configs, size)(arch)


def test_shapes_match_reference():
    assert shapes.SHAPES == {k: shapes.ShapeSpec(**dataclasses.asdict(v))
                             for k, v in jshapes.SHAPES.items()}
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SUBQUADRATIC_ARCHS == jshapes.SUBQUADRATIC_ARCHS
    archs = sorted(jconfigs.ARCHS)
    for a in archs:
        for s in jshapes.SHAPES:
            assert shapes.applicable(a, s) == jshapes.applicable(a, s)
    assert configs.cells(archs) == jshapes.cells(archs)
    assert len(shapes.cells(archs)) == 3 * len(archs) + 2


@pytest.mark.parametrize("case", CASES)
def test_init_model_tree_matches_reference(case):
    """Names, shapes and dtypes of the port's init against the
    reference's tree (``embed_cpd/{A,B,C}``, no ``embed`` and no ``head``
    under the CPD embedding; no ``head`` when tied)."""
    cfg = _smoke(jconfigs, case)
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
    model = transformer.init_model(_smoke(configs, case), 3, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    top = {k.split(".")[0] for k in got}
    if case == "tinyllama-cpd":
        assert top == {"embed_cpd", "layers", "ln_f"}
        assert got["embed_cpd.A"] == ((23, 16), "float32")
    assert not any(p.requires_grad for p in model.parameters())


def test_full_cpd_tinyllama_sizes():
    """The CPD tinyllama's factors (179 x 179 ids, rank 64 by default)
    against its dense table, by shape only (no allocation)."""
    cfg = dataclasses.replace(configs.get_config("tinyllama-1.1b"),
                              cpd_embedding=True)
    tree = jax.eval_shape(lambda: jtr.init_model(
        dataclasses.replace(jconfigs.get_config("tinyllama-1.1b"),
                            cpd_embedding=True), jax.random.PRNGKey(0)))
    shapes_ = {k: v.shape for k, v in tree["embed_cpd"].items()}
    assert shapes_ == {"A": (179, 64), "B": (179, 64), "C": (2048, 64)}
    assert cfg.vocab_padded == 32000 and 179 * 179 == 32041
    assert sum(a * b for a, b in shapes_.values()) * 425 < 32000 * 2048


# --------------------------------------------------------------------------
# Refusals: the causal cache, the query chunks, unported features
# --------------------------------------------------------------------------
def test_engine_refuses_a_request_past_the_causal_cache():
    """A prompt plus ``max_new`` over ``max_len`` is refused before any
    work (the cache stays empty); one that fits runs, and a second
    request continues from the first's positions."""
    _, _, tcfg, model = pair("tinyllama-1.1b")
    eng = Engine(model, tcfg, ServeConfig(2, 12), device="cpu")
    prompt = torch.zeros((2, 5), dtype=torch.long)
    with pytest.raises(ValueError, match="max_len 12"):
        eng.generate(prompt, 8)
    assert all(c["len"] == 0 for c in eng.cache)
    assert eng.generate(prompt, 7).shape == (2, 7)
    assert all(c["len"] == 12 for c in eng.cache)
    with pytest.raises(ValueError, match="after 12"):
        eng.prefill(prompt[:, :1])
    with pytest.raises(ValueError, match="full"):
        layers.attention_decode(model.layers[0].attn,
                                torch.zeros((2, 1, tcfg.d_model)),
                                eng.cache[0], tcfg)


def test_windowed_and_recurrent_caches_never_fill():
    """Only a causal cache bounds a request: recurrentgemma's local
    layers keep a ring buffer, rwkv6's state has no length."""
    for arch in ("recurrentgemma-9b", "rwkv6-3b"):
        cfg = configs.smoke(arch)
        model = transformer.init_model(cfg, device="cpu")
        eng = Engine(model, cfg, ServeConfig(1, 4), device="cpu")
        assert eng.generate(torch.zeros((1, 3), dtype=torch.long),
                            20).shape == (1, 20)


def test_forward_refuses_a_length_the_chunks_cannot_take():
    _, _, tcfg, model = pair("olmo-1b")
    with pytest.raises(ValueError, match="S=600"):
        transformer.forward(model, tcfg, torch.zeros((1, 600),
                                                     dtype=torch.long))


def test_engine_takes_the_device_of_a_cpd_model():
    """A CPD model has no ``embed``: the engine reads the device of its
    first parameter, and refuses another device."""
    _, _, tcfg, model = pair("tinyllama-cpd")
    assert not hasattr(model, "embed")
    assert Engine(model, tcfg, ServeConfig(1, 4), device="cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="params are on cpu"):
        Engine(model, tcfg, ServeConfig(1, 4), device="meta")


@pytest.mark.parametrize("arch,match", [
    ("command-r-plus-104b", "parallel_block"),
    ("paligemma-3b", "prefix attention"),
    ("whisper-large-v3", "kinds \\['dec'\\]")])
def test_unported_archs_name_their_roadmap_item(arch, match):
    """The three archs once refused here (ROADMAP item 12.4b, now
    ported; ``tests/test_torch_families.py`` holds them to the
    reference): each config is the reference's, field by field, and its
    smoke model builds with the feature that was refused (``match``): the
    parallel block's one shared norm, the prefix mask over 256 image
    tokens, the encoder's layers and each decoder layer's
    cross-attention."""
    jcfg = jconfigs.get_config(arch)
    assert configs.get_config(arch) == ModelConfig(
        **{f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(JModelConfig)})
    cfg = configs.smoke(arch)
    model = transformer.init_model(cfg, device="cpu")
    layer = model.layers[0]
    if match == "parallel_block":
        assert hasattr(layer, "ln") and not hasattr(layer, "ln1")
    elif match == "prefix attention":
        full = configs.get_config(arch)
        assert transformer._attn_mask_kind(full, "attn") == ("prefix", 256)
    else:
        assert transformer.layer_kinds(cfg) == ["dec"] * cfg.n_layers
        assert len(model.enc) == cfg.n_enc_layers == 2
        assert hasattr(layer, "xattn") and hasattr(layer, "lnx")


def test_sinusoidal_positions_are_refused():
    """Once refused (ROADMAP item 12.4b, now ported): olmo's smoke config
    with ``rope_theta`` 0 takes absolute sinusoidal positions in place of
    RoPE, in ``forward`` and in 4 decode steps (each at its cache
    position), against the reference."""
    kw = dict(rope_theta=0.0, compute_dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke("olmo-1b"), **kw)
    tcfg = dataclasses.replace(configs.smoke("olmo-1b"), **kw)
    tree = perturb(jax.tree.map(np.asarray, jtr.init_model(
        jcfg, jax.random.PRNGKey(1))), 5)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = interop.model_params_from_numpy(tree, tcfg, device="cpu")
    tok = np.random.default_rng(13).integers(0, tcfg.vocab, (2, 32))
    _close(transformer.forward(model, tcfg, torch.from_numpy(tok)),
           jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32)), SCAN_TOL)
    jcache = jtr.init_cache(jcfg, 2, 8)
    tcache = transformer.init_cache(tcfg, 2, 8, device="cpu")
    for i in range(4):
        t = tok[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(t, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(t))
        _close(got, want, SAME_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_cli_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--max-new", "5",
                      "--max-len", "8", "--seed", "1"])
    assert out.shape == (2, 5)
    assert "generated (2, 5) on cpu" in capsys.readouterr().out
