"""The port's RWKV-6 slice against the JAX reference, on the CPU.

Inputs come from numpy seeds. The reference's ``init_model`` tree crosses
over as numpy through ``interop.model_params_from_numpy``, with the leaves
that init makes constant perturbed (``wb_lora`` is zero at init, which
makes every decay the same constant: a kernel that ignored the per-step
``w_t`` would pass), and ``u`` random. Compute is float32 on both sides
(``compute_dtype="float32"``).

On the CPU the ``wkv6`` wrapper runs its plain version; the CUDA kernel is
held against that by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances (float32 both sides):
  * ``wkv6`` plain against ``ops.wkv6(interpret=True)`` and
    ``ref.wkv6_ref``: rtol = atol = 1e-5 — the same sequential recurrence,
    the readout summed in another order (the reference kernel tests allow
    1e-3).
  * ``time_mix``, ``forward`` logits: rtol = atol = 1e-4 — the reference
    computes the recurrence in chunked form (decays normalised to the
    chunk end, exponentials of up to the chunk's decay mass), the port
    step by step; and the matmuls sum in another order.
  * ``channel_mix``, ``time_mix_decode`` and ``decode_step`` (the same
    algebra, matmul order only): rtol = atol = 2e-5.
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
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtr
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import ServeConfig as JServeConfig
from repro_torch import configs, interop
from repro_torch.kernels import wkv6 as kw6
from repro_torch.launch import serve
from repro_torch.models import rwkv, transformer
from repro_torch.serving import Engine, ServeConfig

WKV_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKED_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "rwkv6-3b"


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _t(x):
    return torch.from_numpy(np.array(x))      # a writable copy


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def perturb(tree, seed):
    """Perturb the leaves that init makes constant: ``wb_lora`` (zero),
    ``w0`` (-5), the token-shift mixes (0.5) and the norm scales (1)."""
    rng = np.random.default_rng(seed)
    b = dict(tree["stage0"]["b0"])
    b["wb_lora"] = rng.normal(0, 0.15, b["wb_lora"].shape)
    b["w0"] = b["w0"] + rng.uniform(-0.5, 0.5, b["w0"].shape)
    for name in ("mu", "mu_c"):
        b[name] = rng.uniform(0, 1, b[name].shape)
    b["ln_x"] = 1 + rng.normal(0, 0.1, b["ln_x"].shape)
    for name in ("ln1", "ln2"):
        b[name] = {"scale": 1 + rng.normal(0, 0.1, b[name]["scale"].shape)}
    b = jax.tree.map(lambda a: np.asarray(a, np.float32), b)
    return {**tree, "stage0": {"b0": b},
            "ln_f": {"scale": (1 + rng.normal(0, 0.1, tree["ln_f"]["scale"]
                                              .shape)).astype(np.float32)}}


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) in f32."""
    jcfg = _f32(jconfigs.smoke(ARCH))
    tcfg = _f32(configs.smoke(ARCH))
    tree = jax.tree.map(np.asarray, jtr.init_model(jcfg, jax.random.PRNGKey(0)))
    tree = perturb(tree, 7)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = interop.model_params_from_numpy(tree, tcfg, device="cpu")
    return jcfg, jparams, tcfg, model


def _block0(jparams):
    return jax.tree.map(lambda a: a[0], jparams["stage0"]["b0"])


# --------------------------------------------------------------------------
# wkv6
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bh,t,k,v,chunk", [
    (2, 16, 8, 8, 8), (4, 32, 16, 32, 16), (1, 64, 64, 64, 16),
    (3, 96, 64, 64, 32)])
def test_wkv6_plain_matches_reference(bh, t, k, v, chunk):
    rng = np.random.default_rng(bh + t)
    r = rng.standard_normal((bh, t, k)).astype(np.float32)
    kk = rng.standard_normal((bh, t, k)).astype(np.float32)
    w = rng.uniform(0.5, 0.999, (bh, t, k)).astype(np.float32)
    vv = rng.standard_normal((bh, t, v)).astype(np.float32)
    u = rng.standard_normal((bh, k)).astype(np.float32)
    args = tuple(map(jnp.asarray, (r, kk, w, vv, u)))
    before = dict(kw6.LAUNCHES)
    got = kw6.wkv6(*map(_t, (r, kk, w, vv, u)))
    assert kw6.LAUNCHES == before          # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (bh, t, v)
    _close(got, ops.wkv6(*args, chunk=chunk, interpret=True), WKV_TOL)
    _close(got, ref.wkv6_ref(*args), WKV_TOL)


def test_wkv6_launch_refuses_before_launching():
    """The CUDA path checks every argument before it launches and never
    falls back to the plain version: on CPU tensors of a shape it takes
    it raises for the device."""
    rng = np.random.default_rng(0)

    def args(k=16, v=16, t=8, bh=2, dtype=np.float32):
        a = [rng.standard_normal(s).astype(dtype)
             for s in ((bh, t, k), (bh, t, k), (bh, t, k), (bh, t, v),
                       (bh, k))]
        return [_t(x) for x in a]

    before = dict(kw6.LAUNCHES)
    with pytest.raises(ValueError, match="K and V in"):
        kw6._launch(*args(k=12))
    with pytest.raises(ValueError, match="K and V in"):
        kw6._launch(*args(v=128))
    with pytest.raises(TypeError, match="float32"):
        kw6._launch(*args(dtype=np.float64))
    bad = args()
    bad[1] = bad[1][:, :4]
    with pytest.raises(ValueError, match="k has shape"):
        kw6._launch(*bad)
    strided = args()
    strided[0] = strided[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        kw6._launch(*strided)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kw6._launch(*args())
    assert kw6.LAUNCHES == before


# --------------------------------------------------------------------------
# The block
# --------------------------------------------------------------------------
@pytest.mark.parametrize("s", [6, 64, 1024])
def test_time_mix_matches_reference(pair, s):
    """S = 6: one chunk of 6; 64: two chunks of 32; 1024: chunk 256."""
    jcfg, jparams, tcfg, model = pair
    x = np.random.default_rng(s).standard_normal((2, s, tcfg.d_model)) \
        .astype(np.float32)
    want = jrwkv.time_mix(_block0(jparams), jnp.asarray(x), jcfg)
    got = rwkv.time_mix(model.layers[0], _t(x), tcfg)
    _close(got, want, CHUNKED_TOL)


def test_time_mix_refuses_lengths_like_reference(pair):
    jcfg, jparams, tcfg, model = pair
    x = np.zeros((1, 40, tcfg.d_model), np.float32)   # 40 % 32 != 0
    with pytest.raises(AssertionError):
        jrwkv.time_mix(_block0(jparams), jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv.time_mix(model.layers[0], _t(x), tcfg)


def test_channel_mix_matches_reference(pair):
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    for lst in (None, last):
        want = jrwkv.channel_mix(_block0(jparams), jnp.asarray(x), jcfg,
                                 last=None if lst is None else
                                 jnp.asarray(lst))
        got = rwkv.channel_mix(model.layers[0], _t(x), tcfg,
                               last=None if lst is None else _t(lst))
        _close(got, want, SAME_TOL)


def test_time_mix_decode_matches_reference(pair):
    """One step from a non-zero cache: state, last token and output."""
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(4)
    h = rwkv.n_heads(tcfg)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    cache = {"state": rng.standard_normal((3, h, 64, 64)).astype(np.float32),
             "last": rng.standard_normal((3, 1, tcfg.d_model))
             .astype(np.float32)}
    want, wc = jrwkv.time_mix_decode(
        _block0(jparams), jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in cache.items()}, jcfg)
    got, gc = rwkv.time_mix_decode(model.layers[0], _t(x),
                                   {k: _t(v) for k, v in cache.items()},
                                   tcfg)
    _close(got, want, SAME_TOL)
    _close(gc["state"], wc["state"], SAME_TOL)
    _close(gc["last"], wc["last"], SAME_TOL)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------
def test_forward_matches_reference(pair):
    jcfg, jparams, tcfg, model = pair
    tok = np.random.default_rng(5).integers(0, tcfg.vocab, (2, 64))
    want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
    got = transformer.forward(model, tcfg, torch.from_numpy(tok))
    assert got.shape == (2, 64, tcfg.vocab_padded)
    _close(got, want, CHUNKED_TOL)


def test_decode_steps_match_reference(pair):
    """Five steps with the cache carried; logits each step, the states
    after the last."""
    jcfg, jparams, tcfg, model = pair
    toks = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 5))
    jcache = jtr.init_cache(jcfg, 2, 16)
    tcache = transformer.init_cache(tcfg, 2, device="cpu")
    for i in range(toks.shape[1]):
        tok = toks[:, i:i + 1]
        want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                       jnp.asarray(tok, jnp.int32))
        got, tcache = transformer.decode_step(model, tcache, tcfg,
                                              torch.from_numpy(tok))
        _close(got, want, SAME_TOL)
    for layer, c in enumerate(tcache):
        for name in ("state", "last", "last_c"):
            _close(c[name], jcache["stage0"]["b0"][name][layer], SAME_TOL)


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
    """The kernel path (``forward``) and the decode recurrence (prefill)
    give the same last-position logits."""
    _, _, tcfg, model = pair
    prompt = torch.from_numpy(
        np.random.default_rng(9).integers(0, tcfg.vocab, (2, 32)))
    want = transformer.forward(model, tcfg, prompt)[:, -1]
    got = Engine(model, tcfg, ServeConfig(2, 64), device="cpu") \
        .prefill(prompt)[:, -1]
    torch.testing.assert_close(got, want, **CHUNKED_TOL)


def test_temperature_sampling_follows_its_generator(pair):
    _, _, tcfg, model = pair
    prompt = torch.from_numpy(
        np.random.default_rng(10).integers(0, tcfg.vocab, (2, 4)))

    def draw(seed):
        eng = Engine(model, tcfg, ServeConfig(2, 32, temperature=1.0),
                     device="cpu")
        return eng.generate(prompt, 6,
                            generator=torch.Generator().manual_seed(seed))

    a, b = draw(1), draw(1)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < tcfg.vocab)).all()


# --------------------------------------------------------------------------
# Configs, init, devices
# --------------------------------------------------------------------------
def test_configs_match_reference():
    for get in ("smoke", "get_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        assert dataclasses.asdict(getattr(configs, get)(ARCH)) == want
    cfg = configs.get_config(ARCH)
    assert (cfg.cdtype, cfg.pdtype) == (torch.bfloat16, torch.float32)
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for name in jconfigs.ARCHS:       # all ten, field by field
        assert dataclasses.asdict(configs.smoke(name)) == \
            dataclasses.asdict(jconfigs.smoke(name))


def test_init_model_tree_matches_reference():
    """Names, shapes and dtypes of the port's init against the
    reference's tree, the stacked stage unstacked into layers."""
    cfg = jconfigs.smoke(ARCH)
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
    model = transformer.init_model(configs.smoke(ARCH), 3, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in model.state_dict().items()}
    assert got == want
    assert not any(p.requires_grad for p in model.parameters())
    wb = model.layers[0].wb_lora
    assert not wb.any()                   # zero at init, as the reference


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.smoke(ARCH)
    with pytest.raises(RuntimeError, match="no card"):
        transformer.init_model(cfg)
    with pytest.raises(RuntimeError, match="no card"):
        transformer.init_cache(cfg, 2)
    model = transformer.init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no card"):
        Engine(model, cfg, ServeConfig(2, 16))
    tree = jax.tree.map(np.asarray,
                        jtr.init_model(jconfigs.smoke(ARCH),
                                       jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no card"):
        interop.model_params_from_numpy(tree, cfg)


def test_unported_paths_name_their_roadmap_item():
    """What this test once refused (ROADMAP item 12.4b, now ported),
    against the reference at init's weights: a ``dec`` block after an
    ``rwkv`` one in a model without an encoder (the reference's prefill
    then cross-attends to the block's own input, its decode to an empty
    encoder cache), and the ``vlm`` kind on rwkv layers (no image
    embeddings given: the model is rwkv's own). Still refused: a block
    kind the reference does not know."""
    cfg = configs.smoke(ARCH)
    for kw in (dict(block_pattern=("rwkv", "dec")), dict(kind="vlm")):
        jcfg = _f32(dataclasses.replace(jconfigs.smoke(ARCH), **kw))
        tcfg = _f32(dataclasses.replace(cfg, **kw))
        tree = jax.tree.map(np.asarray,
                            jtr.init_model(jcfg, jax.random.PRNGKey(3)))
        jparams = jax.tree.map(jnp.asarray, tree)
        model = interop.model_params_from_numpy(tree, tcfg, device="cpu")
        tok = np.random.default_rng(23).integers(0, tcfg.vocab, (2, 16))
        want = jtr.forward(jparams, jcfg, jnp.asarray(tok, jnp.int32))
        _close(transformer.forward(model, tcfg, torch.from_numpy(tok)),
               want, CHUNKED_TOL)
        jcache = jtr.init_cache(jcfg, 2, 8)
        tcache = transformer.init_cache(tcfg, 2, 8, device="cpu")
        for i in range(3):
            t = tok[:, i:i + 1]
            want, jcache = jtr.decode_step(jparams, jcache, jcfg,
                                           jnp.asarray(t, jnp.int32))
            got, tcache = transformer.decode_step(model, tcache, tcfg,
                                                  torch.from_numpy(t))
            _close(got, want, SAME_TOL)
    with pytest.raises(ValueError, match="unknown block kind"):
        transformer.init_model(
            dataclasses.replace(cfg, block_pattern=("rwkv", "xyz")),
            device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "3", "--max-new", "4",
                      "--seed", "1"])
    assert out.shape == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
