"""Low-rank gradient compression across replicas (PowerSGD-style,
arXiv:1905.13727): the reference's ``training/compression.py`` over one
axis of a mesh.

Instead of all-reducing a full (A, B) gradient, the positions of the
axis exchange rank-r factors P (A, r) and Q (B, r):

    P = G Q0;  P = pmean(P);  P = orth(P);  Q = G^T P;  Q = pmean(Q)
    G_hat = P Q^T

Error feedback keeps the residual on each position and adds it back on
the next call, so the compression bias vanishes over time.

One process drives every position (``repro_torch.sharding``): the
functions take one gradient a position of the axis, each on its device,
and return one a position. ``pmean`` is the mean of the positions'
copies, summed in position order on the first one's device and copied
back to each; the QR is ``torch.linalg.qr`` in float32. Q0 is drawn from
an explicit ``torch.Generator``, or given (the tests pass the
reference's ``jax.random.normal`` draws). A primitive, as in the
reference: the train step does not call it.
"""
from __future__ import annotations

import torch

from ..sharding import psum
from .tree import leaves, unflatten


def _pmean(parts: list) -> list:
    return [t / len(parts) for t in psum([p.float() for p in parts])]


def _orthonormalize(p):
    q, _ = torch.linalg.qr(p.float())
    return q


def _draw_q0(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device if generator is not None
                       else device)


def compress_allreduce(gs: list, rank: int, *, q0=None, generator=None):
    """All-reduce a >= 2-D gradient over the axis through rank-r factors:
    ``gs`` one gradient a position. Returns the synchronised low-rank
    approximation of their mean, one a position, in each one's dtype.
    ``q0`` (B, r) is given, or drawn from ``generator``; B is the product
    of the trailing dims, r ``min(rank, A, B)``."""
    shape = gs[0].shape
    a = shape[0]
    b = 1
    for s in shape[1:]:
        b *= s
    r = min(rank, a, b)
    if q0 is None:
        q0 = _draw_q0((b, r), generator, gs[0].device)
    g2 = [g.reshape(a, b).float() for g in gs]
    p = _pmean([g @ q0.to(g.device, torch.float32) for g in g2])
    p_orth = _orthonormalize(p[0])
    p = [p_orth.to(g.device) for g in g2]
    q = _pmean([g.T @ pk for g, pk in zip(g2, p)])
    return [(pk @ qk.T).reshape(shape).to(g.dtype)
            for pk, qk, g in zip(p, q, gs)]


def compressed_grad_sync(grads: list, rank: int, *, error=None, q0s=None,
                         generator=None):
    """Tree-wide sync over the axis: ``grads`` one gradient tree a
    position. Leaves of rank >= 2 with >= 4096 elements are compressed
    with error feedback (``error``: the last call's residuals, one tree a
    position; zeros when ``None``); the others are averaged exactly.
    ``q0s`` gives each leaf's Q0 (in :func:`~.tree.leaves` order, ``None``
    for a leaf that is not compressed); otherwise they are drawn from
    ``generator`` in that order. Returns ``(synced, new_error)``, each one
    tree a position."""
    flat = [leaves(g) for g in grads]
    errs = ([leaves(e) for e in error] if error is not None
            else [[torch.zeros_like(x) for x in f] for f in flat])
    n_leaves = len(flat[0])
    out = [[None] * n_leaves for _ in grads]
    new_err = [[None] * n_leaves for _ in grads]
    for i in range(n_leaves):
        xs = [f[i] for f in flat]
        es = [e[i] for e in errs]
        x0 = xs[0]
        if x0.dim() >= 2 and x0.numel() >= 4096:
            corrected = [x + e.to(x.dtype) for x, e in zip(xs, es)]
            approx = compress_allreduce(
                corrected, rank, q0=None if q0s is None else q0s[i],
                generator=generator)
            for k in range(len(grads)):
                out[k][i] = approx[k]
                new_err[k][i] = (corrected[k] - approx[k]).to(es[k].dtype)
        else:
            mean = _pmean(xs)
            for k in range(len(grads)):
                out[k][i] = mean[k].to(xs[k].dtype)
                new_err[k][i] = torch.zeros_like(es[k])
    return ([unflatten(g, o) for g, o in zip(grads, out)],
            [unflatten(g, e) for g, e in zip(grads, new_err)])


__all__ = ["compress_allreduce", "compressed_grad_sync"]
