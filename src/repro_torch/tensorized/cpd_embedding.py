"""CPD-factorized embedding layer: the paper's spMTTKRP as an LM feature.

The (V, D) table is represented as a rank-R CPD of its (V1 x V2 x D)
reshaping:  E[v1*V2 + v2, :] = C @ (A[v1] * B[v2])^T, with
A (V1, R), B (V2, R), C (D, R). Storage drops from V*D to (V1+V2+D)*R.

The factor gradients for a token batch are exactly an spMTTKRP where the
batch plays the sparse tensor: viewing the batch as the 3-mode sparse
tensor X in R^{V1 x V2 x T} with nonzeros (v1_t, v2_t, t),

    dA = X_(0) (B  (.) GC)      (mode-0 spMTTKRP, GC = cotangent @ C)
    dB = X_(1) (A  (.) GC)
    dC = G^T (A[v1] * B[v2])    (dense)

``cpd_embed``'s backward computes them with the gather-Hadamard and an
``index_add_`` segment sum, as the ``torch`` engine backend sums its
mode step. The factors are given as a dict or as a parameter module
under the keys ``A``, ``B``, ``C``.
"""
from __future__ import annotations

import math

import torch


def split_dims(vocab: int) -> tuple[int, int]:
    v1 = int(math.ceil(math.sqrt(vocab)))
    v2 = int(math.ceil(vocab / v1))
    return v1, v2


def init_cpd_embedding(vocab: int, d_model: int, rank: int,
                       dtype=torch.float32, *,
                       generator: torch.Generator) -> dict:
    """Normal factors scaled by ``1/sqrt(rank)``, drawn in f32 on the
    generator's device and cast to ``dtype``."""
    v1, v2 = split_dims(vocab)
    s = (1.0 / rank) ** 0.5

    def draw(rows):
        dev = generator.device
        t = (torch.empty((rows, rank), device=dev) if dev.type == "meta"
             else torch.randn((rows, rank), generator=generator, device=dev))
        return (t * s).to(dtype)

    return {"A": draw(v1), "B": draw(v2), "C": draw(d_model)}


def _factors(params):
    if isinstance(params, dict):
        return params["A"], params["B"], params["C"]
    return params.A, params.B, params.C


def _lookup(A, B, C, tokens):
    """The embedding rows, ``(A[i1] * B[i2]) @ C^T`` in the factors'
    dtype, and the residuals the backward reads."""
    v2 = B.shape[0]
    i1 = tokens // v2
    i2 = tokens % v2
    a, b = A[i1], B[i2]                        # (..., R)
    return (a * b) @ C.T, (i1, i2, a, b)


class CPDEmbed(torch.autograd.Function):
    """tokens (B, S) -> embeddings (B, S, D), with the spMTTKRP backward.
    The cotangent is summed in f32 (f64 when it is f64), each gradient
    cast to its factor's dtype; the tokens get none."""

    @staticmethod
    def forward(ctx, A, B, C, tokens):
        out, (i1, i2, a, b) = _lookup(A, B, C, tokens)
        ctx.save_for_backward(i1, i2, a, b, C)
        ctx.rows = (A.shape[0], B.shape[0])
        ctx.dtypes = (A.dtype, B.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        i1, i2, a, b, C = ctx.saved_tensors
        acc = torch.promote_types(g.dtype, torch.float32)
        d = g.shape[-1]
        gf = g.reshape(-1, d).to(acc)
        gc = gf @ C.to(acc)                    # (T, R): mode-T "factor"
        af = a.reshape(gc.shape).to(acc)
        bf = b.reshape(gc.shape).to(acc)
        # the elementwise computation: gather-Hadamard done above, the
        # segment sum into each factor's rows
        rank = gc.shape[1]
        dA = gc.new_zeros((ctx.rows[0], rank)).index_add_(
            0, i1.reshape(-1), bf * gc)
        dB = gc.new_zeros((ctx.rows[1], rank)).index_add_(
            0, i2.reshape(-1), af * gc)
        dC = gf.T @ (af * bf)
        return (dA.to(ctx.dtypes[0]), dB.to(ctx.dtypes[1]), dC.to(C.dtype),
                None)


def cpd_embed(params, tokens):
    """tokens (B, S) -> embeddings (B, S, D) in the factors' dtype."""
    return CPDEmbed.apply(*_factors(params), tokens)


def _krp(A, B):
    """The Khatri-Rao rows ``A[v // V2] * B[v % V2]`` for every id v."""
    v1, r = A.shape
    return (A[:, None, :] * B[None, :, :]).reshape(v1 * B.shape[0], r)


def cpd_logits(params, x):
    """Tied-head logits without materialising the dense table:
    logits[t, v] = sum_r (x_t . C[:, r]) A[v1, r] B[v2, r], over V1 * V2
    ids. ``C`` and the Khatri-Rao rows (formed in the factors' dtype) are
    cast to ``x``'s dtype before their products."""
    A, B, C = _factors(params)
    xc = x @ C.to(x.dtype)                     # (B, S, R)
    return xc @ _krp(A, B).T.to(x.dtype)


def dense_table(params) -> torch.Tensor:
    """Materialise E, (V1 * V2, D) (tests and comparison only)."""
    A, B, C = _factors(params)
    return _krp(A, B) @ C.T


__all__ = ["CPDEmbed", "cpd_embed", "cpd_logits", "dense_table",
           "init_cpd_embedding", "split_dims"]
