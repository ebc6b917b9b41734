"""The port's CPD-factorized embedding (``repro_torch.tensorized``)
against the JAX reference (``repro.tensorized``), on the CPU.

Both sides get the same factors: the reference's ``init_cpd_embedding``
draws them, and they cross over as numpy. Token batches come from numpy
seeds; some are drawn from a few hot ids, so that the backward's segment
sums add many terms into one row.

Tolerances (float32 both sides unless stated):
  * forward, ``cpd_logits``, ``dense_table``: rtol = atol = 1e-5 (the
    same products; matmuls over R or D summed in another order).
  * ``dA``, ``dB``, ``dC`` against the reference's ``jax.vjp``: rtol =
    1e-4, atol = 1e-5 (``index_add_`` against ``segment_sum``, sums of
    up to a few hundred products in another order).
  * bfloat16 casts (``cpd_embed`` cast after the lookup, ``cpd_logits``
    with ``C`` and the Khatri-Rao rows cast before their products): rtol
    = 2**-9, atol = 1e-6, below half a bfloat16 step, so that the same
    float32 accumulation rounded the same way passes and a cast moved
    across a product (a one-step difference) fails.
  * ``torch.autograd.gradcheck`` in float64 at its defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.tensorized import cpd_embedding as jcpd
from repro_torch.tensorized import (CPDEmbed, cpd_embed, cpd_logits,
                                    dense_table, init_cpd_embedding,
                                    split_dims)
from repro_torch.tensorized.cpd_embedding import _krp, _lookup

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -9, atol=1e-6)

# (vocab, d, rank): the reference tests' sizes, tinyllama smoke's padded
# vocab with its CPD rank, and one with V1 * V2 > vocab.
SIZES = [(300, 32, 8), (200, 16, 4), (144, 24, 6), (512, 128, 16),
         (1000, 64, 12)]


def _params(vocab, d, rank, seed=0, dtype=jnp.float32):
    """The reference's factors, and the same as torch tensors."""
    jp = jcpd.init_cpd_embedding(jax.random.PRNGKey(seed), vocab, d, rank,
                                 dtype=dtype)
    tp = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    return jp, tp


def _tokens(vocab, shape, seed, hot=False):
    rng = np.random.default_rng(seed)
    if hot:  # a few ids repeated: long segment sums
        return rng.choice(rng.integers(0, vocab, 5), size=shape)
    return rng.integers(0, vocab, shape)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


# --------------------------------------------------------------------------
# split_dims, init
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab", [10, 100, 144, 200, 300, 512, 32000,
                                   51866, 151936, 256000, 257216])
def test_split_dims_matches_reference(vocab):
    v1, v2 = split_dims(vocab)
    assert (v1, v2) == jcpd.split_dims(vocab)
    assert v1 * v2 >= vocab


@pytest.mark.parametrize("vocab,d,rank,dtype", [
    (300, 32, 8, "float32"), (512, 128, 16, "bfloat16"),
    (32000, 2048, 64, "float32")])
def test_init_shapes_and_dtypes_match_reference(vocab, d, rank, dtype):
    want = jax.eval_shape(lambda: jcpd.init_cpd_embedding(
        jax.random.PRNGKey(0), vocab, d, rank, dtype=jnp.dtype(dtype)))
    gen = torch.Generator().manual_seed(0)
    got = init_cpd_embedding(vocab, d, rank, getattr(torch, dtype),
                             generator=gen)
    assert sorted(got) == sorted(want) == ["A", "B", "C"]
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert got[k].device == gen.device
    # normal draws scaled by 1/sqrt(rank), as the reference's
    allv = torch.cat([got[k].float().flatten() for k in got])
    assert abs(float(allv.std()) * rank ** 0.5 - 1) < 0.2
    assert abs(float(allv.mean())) < 0.1


def test_init_is_seeded_by_the_generator():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return init_cpd_embedding(300, 32, 8, generator=gen)
    a, b, c = draw(1), draw(1), draw(2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["A"], c["A"])


# --------------------------------------------------------------------------
# cpd_embed: forward and the spMTTKRP backward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,d,rank", SIZES)
@pytest.mark.parametrize("hot", [False, True])
def test_cpd_embed_forward_matches_reference(vocab, d, rank, hot):
    jp, tp = _params(vocab, d, rank)
    tok = _tokens(vocab, (3, 16), seed=vocab + hot, hot=hot)
    want = jcpd.cpd_embed(jp, jnp.asarray(tok, jnp.int32))
    got = cpd_embed(tp, torch.from_numpy(tok))
    assert got.shape == (3, 16, d) and got.dtype == torch.float32
    _close(got, want, FWD_TOL)
    # the lookup is the dense table's rows
    _close(got, dense_table(tp)[torch.from_numpy(tok)].numpy(), FWD_TOL)


@pytest.mark.parametrize("vocab,d,rank", SIZES)
@pytest.mark.parametrize("hot", [False, True])
def test_cpd_embed_grads_match_reference_vjp(vocab, d, rank, hot):
    """dA, dB (the mode-0 and mode-1 spMTTKRP of the token batch) and dC
    against the reference's ``jax.vjp`` of ``cpd_embed`` (its custom
    VJP) from the same factors and cotangent."""
    jp, tp = _params(vocab, d, rank, seed=1)
    tok = _tokens(vocab, (4, 24), seed=2 * vocab + hot, hot=hot)
    g = np.random.default_rng(vocab).standard_normal(
        (4, 24, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jcpd.cpd_embed(p, jnp.asarray(tok, jnp.int32)),
                     jp)
    (want,) = vjp(jnp.asarray(g))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    out = cpd_embed(leaves, torch.from_numpy(tok))
    out.backward(torch.from_numpy(g))
    for k in ("A", "B", "C"):
        assert leaves[k].grad.dtype == torch.float32
        _close(leaves[k].grad, want[k], GRAD_TOL)


def test_cpd_embed_backward_matches_autograd_of_the_lookup():
    """The hand-written backward equals autograd through the naive
    lookup (the reference's ``test_custom_vjp_matches_autodiff``)."""
    _, tp = _params(200, 16, 4)
    tok = torch.from_numpy(_tokens(200, (3, 8), seed=2))
    tgt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 8, 16)).astype(np.float32))

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        ((fn(leaves) - tgt) ** 2).sum().backward()
        return leaves

    g1 = grads(lambda p: cpd_embed(p, tok))
    g2 = grads(lambda p: _lookup(p["A"], p["B"], p["C"], tok)[0])
    for k in ("A", "B", "C"):
        torch.testing.assert_close(g1[k].grad, g2[k].grad, rtol=1e-5,
                                   atol=1e-6)


def test_cpd_embed_gradcheck_float64():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
            for s in ((7, 3), (6, 3), (5, 3))]
    tok = torch.from_numpy(rng.integers(0, 42, (2, 9)))
    assert torch.autograd.gradcheck(CPDEmbed.apply, (*args, tok))


def test_tokens_get_no_gradient_and_grads_keep_the_factor_dtype():
    _, tp = _params(512, 128, 16, dtype=jnp.bfloat16)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tok = torch.from_numpy(_tokens(512, (2, 8), seed=5))
    out = cpd_embed(leaves, tok)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(leaves[k].grad.dtype == torch.bfloat16 for k in leaves)
    assert tok.grad is None and not tok.requires_grad


# --------------------------------------------------------------------------
# cpd_logits, dense_table
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,d,rank", SIZES)
def test_cpd_logits_and_dense_table_match_reference(vocab, d, rank):
    jp, tp = _params(vocab, d, rank, seed=2)
    x = np.random.default_rng(vocab).standard_normal(
        (2, 5, d)).astype(np.float32)
    got = cpd_logits(tp, torch.from_numpy(x))
    v1, v2 = split_dims(vocab)
    assert got.shape == (2, 5, v1 * v2)             # V1 * V2, not vocab
    _close(got, jcpd.cpd_logits(jp, jnp.asarray(x)), FWD_TOL)
    table = dense_table(tp)
    assert table.shape == (v1 * v2, d)
    _close(table, jcpd.dense_table(jp), FWD_TOL)
    # the tied head without the table: logits over the first vocab ids
    _close(got[..., :vocab], (torch.from_numpy(x) @ table.T)[..., :vocab]
           .numpy(), dict(rtol=1e-4, atol=1e-4))


def test_bf16_casts_match_reference():
    """``cpd_embed`` in f32 cast to bf16 after the lookup, and
    ``cpd_logits`` of a bf16 x with ``C`` and the Khatri-Rao rows cast to
    bf16 before their products, as the reference's; a cast moved across
    a product misses the tolerance."""
    jp, tp = _params(512, 128, 16)
    tok = _tokens(512, (2, 8), seed=1)
    want = jcpd.cpd_embed(jp, jnp.asarray(tok, jnp.int32)).astype(
        jnp.bfloat16)
    _close(cpd_embed(tp, torch.from_numpy(tok)).to(torch.bfloat16), want,
           BF16_TOL)
    x = np.random.default_rng(0).standard_normal((2, 8, 128)).astype(
        np.float32)
    want = jcpd.cpd_logits(jp, jnp.asarray(x).astype(jnp.bfloat16))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = cpd_logits(tp, xb)
    assert got.dtype == torch.bfloat16
    _close(got, want.astype(jnp.float32), BF16_TOL)
    swapped = ((xb.float() @ tp["C"]) @ _krp(tp["A"], tp["B"]).T).to(
        torch.bfloat16)
    with pytest.raises(AssertionError):
        _close(swapped, want.astype(jnp.float32), BF16_TOL)


def test_factors_as_a_parameter_module():
    """The model holds the factors in a parameter module (``embed_cpd``):
    every function takes it as it takes the dict."""
    from repro_torch.models.common import Params

    _, tp = _params(300, 32, 8)
    mod = Params(tp)
    tok = torch.from_numpy(_tokens(300, (2, 4), seed=0))
    x = torch.randn((2, 4, 32), generator=torch.Generator().manual_seed(0))
    assert torch.equal(cpd_embed(mod, tok), cpd_embed(tp, tok))
    assert torch.equal(cpd_logits(mod, x), cpd_logits(tp, x))
    assert torch.equal(dense_table(mod), dense_table(tp))


def test_compression_ratio():
    """The point of the technique: storage is (V1+V2+D)R << V*D."""
    vocab, d, rank = 256000, 1024, 64
    params = init_cpd_embedding(vocab, d, rank,
                                generator=torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in params.values())
    assert n * 20 < vocab * d
    v1, v2 = split_dims(32000)                    # tinyllama: 179 x 179
    assert (v1, v2) == (179, 179)
    assert (v1 + v2 + 2048) * 64 * 425 < 32000 * 2048
