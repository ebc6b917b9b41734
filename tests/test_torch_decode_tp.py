"""The sharded decode step (``transformer.decode_step_tp``) against the
single-device ``decode_step``, on meshes of ``devices=["cpu"] * n``.

Every arch's smoke config in float32 (the MoE archs at capacity factor
E / k, so that a dp slice's routing drops nothing, as the one-device
step's does not), B 4 against a cache of 16 positions, 16 steps, on
(data 2, model 2), (1, 4) and (2, 1): the params placed by
``sharding.param_sharding_tree``, the cache by
``launch.specs.cache_shardings`` (the KV sequence over the model axis:
4 or 8 positions a shard, so that the steps write into every shard).
Archs whose caches are all windowed or recurrent (recurrentgemma-9b,
rwkv6-3b) start from a cache that 12 single-device steps filled, so that
the ring buffer wraps. Whisper's cross caches hold 8 encoder positions
(split over the model axis too).

Tolerances: float32, the model-axis sums and the log-sum-exp merge add in
another order than one device: logits and every float cache leaf within
5e-5 (the largest seen is 8e-6). The sharded cache is carried step to
step. With ``kv_quant`` the two run in lockstep (each step starts from
the single-device cache): an int8 row may round to the neighbouring
step where the float key lies within rounding of a half, so int8 leaves
are within 1, and the logits within 1e-3. The replicas of a block
(recurrent states, the int8 scales) must be equal on every position that
holds one. The mutants, one shard's partial attention without the
log-sum-exp merge (``layers.merge_partials``) and the new key and value
written into every shard (``layers.owns_slot``), must miss the limits by
far.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs, sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, transformer
from repro_torch.models.common import tree_of

ARCHS = ["tinyllama-1.1b", "olmo-1b", "qwen2.5-3b", "command-r-plus-104b",
         "olmoe-1b-7b", "qwen3-moe-235b-a22b", "rwkv6-3b",
         "recurrentgemma-9b", "paligemma-3b", "whisper-large-v3"]
MESHES = [(2, 2), (1, 4), (2, 1)]
B, S, STEPS, ENC = 4, 16, 16, 8
TOL = 5e-5
KVQ_LOGITS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny CPU tensors and meta traces: one intra-op thread, so that the
    other test workers keep the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, kv_quant):
    cfg = dataclasses.replace(configs.smoke(arch), compute_dtype="float32",
                              kv_quant=kv_quant)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


_SETUPS: dict = {}
_TRAJECTORIES: dict = {}


def _setup(arch, kv_quant):
    """The smoke model, its starting cache, its stage-layout tree and the
    token generator, made once a (arch, kv_quant) and shared by the
    meshes (nothing here is modified in place: the single-device steps,
    which write their KV caches in place, run on copies)."""
    key = (arch, kv_quant)
    if key not in _SETUPS:
        _SETUPS[key] = _make_setup(arch, kv_quant)
    cfg, model, cache, tree = _SETUPS[key]
    return cfg, model, cache, tree, torch.Generator().manual_seed(1)


def _make_setup(arch, kv_quant):
    cfg = _cfg(arch, kv_quant)
    model = transformer.init_model(cfg, 0, device="cpu")
    with torch.no_grad():              # norm scales and biases off init
        for i, (name, p) in enumerate(model.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "bq", "bk", "bv", "b_a", "b_x", "conv_b"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                         .manual_seed(i)))
    cache = transformer.init_cache(cfg, B, S, device="cpu",
                                   enc_len=ENC if cfg.n_enc_layers else 0)
    gen = torch.Generator().manual_seed(1)
    if cfg.n_enc_layers:
        cache = transformer.build_cross_caches(
            model, cfg, torch.randn(B, ENC, cfg.d_model, generator=gen),
            cache)
    kinds = set(transformer.layer_kinds(cfg))
    if not kinds & {"attn", "moe", "dec"}:      # no causal cache: wrap
        with torch.no_grad():
            for _ in range(12):
                tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen)
                _, cache = transformer.decode_step(model, cache, cfg, tok)
    gen.manual_seed(1)
    tree = transformer.stack_layers(
        cfg, {k: v for k, v in tree_of(model).items()})
    return cfg, model, cache, _detach(tree)


def _trajectory(arch, kv_quant):
    """The single-device run: each step's token, the cache it starts
    from, its logits and the cache after it (once a (arch, kv_quant))."""
    key = (arch, kv_quant)
    if key not in _TRAJECTORIES:
        cfg, model, cache, _, gen = _setup(arch, kv_quant)
        cache = _clone(cache)
        steps = []
        with torch.no_grad():
            for _ in range(STEPS):
                tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen)
                before = _clone(cache)
                logits, cache = transformer.decode_step(model, cache, cfg,
                                                        tok)
                steps.append((tok, before, logits, _clone(cache)))
        _TRAJECTORIES[key] = steps
    return _TRAJECTORIES[key]


def _clone(tree):
    """A copy of a cache (its tensors cloned, counters kept)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detach(v) for v in tree]
    return tree.detach()


def _place(cfg, tree, cache, shape):
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0]
                                                         * shape[1]))
    ctx = sharding.make_ctx(mesh)
    return (sharding.place(tree, sharding.param_sharding_tree(tree, ctx),
                           ctx),
            ctx)


def _place_cache(cache, ctx):
    return sharding.place(cache, specs.cache_shardings(cache, ctx), ctx)


def _worst(want, got, int_worst):
    """Largest |difference| of the float leaves, and of the int8 leaves
    into ``int_worst``; counters equal."""
    if isinstance(want, (dict, list)):
        keys = want if isinstance(want, dict) else range(len(want))
        return max([0.0] + [_worst(want[k], got[k], int_worst)
                            for k in keys])
    if not isinstance(want, torch.Tensor):
        assert want == got
        return 0.0
    assert want.shape == got.shape and want.dtype == got.dtype
    d = (want.double() - got.double()).abs().max().item()
    if want.dtype == torch.int8:
        int_worst.append(d)
        return 0.0
    return d


@pytest.fixture
def replicas_equal(monkeypatch):
    """Every ``sharding.from_positions`` call must be given equal blocks
    for the positions that share one (the replicas stay equal)."""
    orig = sharding.from_positions

    def check(mesh, spec, shape, values):
        seen = {}
        for pos, v in values.items():
            key = sharding.block_of(mesh, tuple(spec), pos)
            if key in seen:
                assert torch.equal(seen[key], v), (spec, pos)
            else:
                seen[key] = v
        return orig(mesh, spec, shape, values)

    monkeypatch.setattr(sharding, "from_positions", check)


def _run(arch, shape, kv_quant):
    """The largest logits / float-leaf difference and int8 difference over
    the steps, against the single-device run (:func:`_trajectory`)."""
    cfg, _, cache, tree, _ = _setup(arch, kv_quant)
    placed, ctx = _place(cfg, tree, cache, shape)
    pc = _place_cache(cache, ctx)
    worst_logits = worst_leaf = 0.0
    ints = [0.0]
    with torch.no_grad():
        for tok, before, want, cache in _trajectory(arch, kv_quant):
            if kv_quant:
                pc = _place_cache(before, ctx)
            got, pc = transformer.decode_step_tp(placed, pc, cfg, tok)
            worst_logits = max(worst_logits, (want - sharding.gather(got))
                               .abs().max().item())
            if kv_quant:
                worst_leaf = max(worst_leaf, _worst(cache,
                                                    sharding.gather(pc),
                                                    ints))
    if not kv_quant:
        worst_leaf = _worst(cache, sharding.gather(pc), ints)
    return worst_logits, worst_leaf, max(ints)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_tp_matches_single_device(arch, shape, kv_quant,
                                              replicas_equal):
    logits, leaf, ints = _run(arch, shape, kv_quant)
    assert logits <= (KVQ_LOGITS if kv_quant else TOL), logits
    assert leaf <= TOL, leaf
    assert ints <= 1, ints


def _mutant_no_merge(ms, ls, os_):
    return [o / l for o, l in zip(os_, ls)]


@pytest.mark.parametrize("mutant", ["no_merge", "write_every_shard"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3",
                                  "recurrentgemma-9b"])
def test_decode_step_tp_mutants_fail(arch, shape, mutant, monkeypatch):
    if mutant == "no_merge":
        monkeypatch.setattr(layers, "merge_partials", _mutant_no_merge)
    else:
        monkeypatch.setattr(layers, "owns_slot", lambda j, slot, s: True)
    logits, leaf, _ = _run(arch, shape, False)
    assert max(logits, leaf) > 100 * TOL, (logits, leaf)


def test_decode_step_tp_refuses_a_full_causal_cache():
    """A causal cache at its last position refuses the next token on the
    mesh as on one device, before any write."""
    cfg, model, cache, tree, _ = _setup("tinyllama-1.1b", False)
    cache = [{**c, "len": S} for c in cache]
    placed, ctx = _place(cfg, tree, cache, (1, 4))
    tok = torch.zeros((B, 1), dtype=torch.int64)
    with torch.no_grad(), pytest.raises(ValueError, match="full"):
        transformer.decode_step(model, cache, cfg, tok)
    with torch.no_grad(), pytest.raises(ValueError, match="full"):
        transformer.decode_step_tp(placed, _place_cache(cache, ctx), cfg,
                                   tok)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_decode_step_tp_layouts(shape):
    """The new cache keeps the placement of the old one, and the logits
    lie over the dp axes on the batch and the model axis on the vocab."""
    cfg, model, cache, tree, _ = _setup("qwen2.5-3b", False)
    placed, ctx = _place(cfg, tree, cache, shape)
    pc = _place_cache(cache, ctx)
    with torch.no_grad():
        logits, new = transformer.decode_step_tp(
            placed, pc, cfg, torch.zeros((B, 1), dtype=torch.int64))
    want = specs.cache_shardings(cache, ctx)
    for w, c in zip(want, new):
        assert sharding.gather(c["len"]) == 1 and c["len"].spec == ()
        for k in ("k", "v"):
            assert c[k].spec == w[k] and c[k].shape == cache[0][k].shape
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert logits.spec == (ctx.resolve("dp")[0] if B % shape[0] == 0
                           else None, None, "model")
