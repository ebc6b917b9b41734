"""The split over time of the port's RG-LRU kernels, on the CPU.

``csrc/lru_scan.cu`` cuts T into spans (``split_bounds``): each CTA scans
its span from a zero state (P, the product of the span's a, and its end
state), folds the earlier spans' aggregates in order into its carry
(``carry = P_j carry + L_j``), and scans its span again from that carry;
the backward does the same with time reversed. ``lru_scan_split_plain`` and
``lru_scan_backward_split_plain`` are that order of operations in plain
PyTorch; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Inputs come from numpy seeds: a uniform in [0.3, 0.999] (the reference
kernel tests'; a span's P underflows within a few dozen steps) or in
[0.99, 1) (P stays near 1, so every carry and its P reach later spans),
x and dh normal.

Tolerances:
  * the forward twin in float32 against ``ops.lru_scan(interpret=True)``
    and ``ref.lru_scan_ref``: rtol = atol = 1e-5, as
    ``tests/test_torch_rglru.py`` holds the plain scan (the same float32
    recurrence; a carry adds one span product's rounding).
  * the backward twin against ``lru_scan_backward_plain``, both float64:
    rtol = atol = 1e-12 (the same algebra regrouped at span boundaries;
    gradients below ~1e3 at these inputs, float64 rounding ~1e-16 of
    them).
  * each float32 twin against float64 at T 4096 over the kernels' spans at
    a model shard's (1, 4096, 2048): ``chip_smoke.py``'s per-element
    limits, ``2 LAMBDA 2 sqrt(t + 1) u A_t`` forward and ``LAMBDA (2
    sqrt(T - t) + 3) u A_t`` backward (LAMBDA 2, u = 2^-24, A the scan on
    absolute values in float64): the numerics argument of that docstring,
    checked on the CPU. A twin whose carry is dropped at a span boundary
    must fail them.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import lru_scan as klru

TOL = dict(rtol=1e-5, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)
U, LAMBDA = 2.0 ** -24, 2.0
SHAPES = [(1, 32, 8, 8), (2, 100, 16, 20), (3, 96, 40, 32)]
A_LO = (0.3, 0.99)


def _inputs(b, t, d, a_lo, seed=0):
    rng = np.random.default_rng([b, t, d, int(100 * a_lo), seed])
    a = rng.uniform(a_lo, 0.999 if a_lo < 0.99 else 1.0, (b, t, d))
    x = rng.standard_normal((b, t, d))
    dh = rng.standard_normal((b, t, d))
    return a.astype(np.float32), x.astype(np.float32), dh.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(b, t, d, chunk, a_lo):
    """(the reference Pallas kernel in interpret mode, its scan oracle)."""
    a, x, _ = _inputs(b, t, d, a_lo)
    ja, jx = jnp.asarray(a), jnp.asarray(x)
    return (np.asarray(ops.lru_scan(ja, jx, chunk=chunk, interpret=True)),
            np.asarray(ref.lru_scan_ref(ja, jx)))


def _spans(t):
    """Spans of 1, 7 and 32 steps, of T and of more than T."""
    return [1, 7, 32, t, t + 5]


# --------------------------------------------------------------------------
# The twins against the reference and the plain versions.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("a_lo", A_LO)
@pytest.mark.parametrize("span_i", range(5))
@pytest.mark.parametrize("b,t,d,chunk", SHAPES)
def test_split_twin_matches_reference(b, t, d, chunk, span_i, a_lo):
    span = _spans(t)[span_i]
    a, x, _ = _inputs(b, t, d, a_lo)
    bounds = klru.span_bounds(t, span)
    assert len(bounds) == -(-t // span)
    got = klru.lru_scan_split_plain(torch.from_numpy(a), torch.from_numpy(x),
                                    bounds)
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    kernel, oracle = _reference(b, t, d, chunk, a_lo)
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


@pytest.mark.parametrize("a_lo", A_LO)
@pytest.mark.parametrize("span_i", range(5))
@pytest.mark.parametrize("b,t,d,chunk", SHAPES)
def test_backward_split_twin_matches_plain(b, t, d, chunk, span_i, a_lo):
    span = _spans(t)[span_i]
    a, x, dh = (torch.from_numpy(v).double() for v in _inputs(b, t, d, a_lo))
    h = klru.lru_scan_steps(a, x)
    want = klru.lru_scan_backward_plain(a, h, dh)
    got = klru.lru_scan_backward_split_plain(a, h, dh,
                                             klru.span_bounds(t, span))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F64_TOL)


def test_split_twins_refuse_spans_that_do_not_cover_t():
    a = torch.rand(1, 10, 2)
    for bounds in ([], [(0, 5)], [(0, 5), (6, 10)], [(1, 10)],
                   [(0, 5), (5, 5), (5, 10)], [(0, 10), (10, 12)]):
        with pytest.raises(ValueError, match="do not cover"):
            klru.lru_scan_split_plain(a, a, bounds)
        with pytest.raises(ValueError, match="do not cover"):
            klru.lru_scan_backward_split_plain(a, a, a, bounds)


# --------------------------------------------------------------------------
# The numerics argument: float32 twins inside chip_smoke.py's limits.
# --------------------------------------------------------------------------
@pytest.mark.parametrize("a_lo", A_LO)
def test_split_twin_float32_within_the_card_limit(a_lo):
    """T 4096 over the spans the kernels take at (1, 4096, 2048)."""
    bounds = klru.split_bounds(1, 4096, 2048)
    assert len(bounds) > 1
    a, x, _ = (torch.from_numpy(v) for v in _inputs(1, 4096, 8, a_lo))
    want = klru.lru_scan_steps(a.double(), x.double())
    big = klru.lru_scan_steps(a.double().abs(), x.double().abs())
    t = torch.arange(4096, dtype=torch.float64)
    lim = 2 * LAMBDA * 2 * (t + 1).sqrt()[None, :, None] * U * big
    err = (klru.lru_scan_split_plain(a, x, bounds).double() - want).abs()
    assert (err <= lim).all(), float((err / lim).max())
    bad = a.clone()
    bad[:, bounds[1][0]] = 0
    err = (klru.lru_scan_split_plain(bad, x, bounds).double() - want).abs()
    assert (err > lim).any()


@pytest.mark.parametrize("a_lo", A_LO)
def test_backward_split_twin_float32_within_the_card_limit(a_lo):
    bounds = klru.split_bounds(1, 4096, 2048)
    a, x, dh = (torch.from_numpy(v) for v in _inputs(1, 4096, 8, a_lo))
    h = klru.lru_scan_steps(a.double(), x.double())
    want = klru.lru_scan_backward_plain(a.double(), h, dh.double())
    steps = 4096 - torch.arange(4096, dtype=torch.float64)
    scale = LAMBDA * (2 * steps.sqrt() + 3)[None, :, None] * U
    lims = [scale * v for v in klru.lru_scan_backward_plain(
        a.double(), h.abs(), dh.double().abs())]
    got = klru.lru_scan_backward_split_plain(a, h.float(), dh, bounds)
    for g, w, lim in zip(got, want, lims):
        err = (g.double() - w).abs()
        assert (err <= lim).all(), float((err / lim).max())
    bad = a.clone()
    bad[:, bounds[len(bounds) // 2][0]] = 0
    got = klru.lru_scan_backward_split_plain(bad, h.float(), dh, bounds)
    assert ((got[1].double() - want[1]).abs() > lims[1]).any()


# --------------------------------------------------------------------------
# The split chooser.
# --------------------------------------------------------------------------
CHOOSER_SHAPES = [(4, 4096, 4096), (2, 4096, 4096), (1, 4096, 2048),
                  (1, 4096, 4096), (1, 32768, 1024), (1, 5000, 1000),
                  (3, 1000, 4100), (1, 32, 8), (2, 33, 130), (1, 16, 1),
                  (1, 10 ** 6, 1), (1, 524288, 4096), (65535, 3, 7)]


@pytest.mark.parametrize("b,t,d", CHOOSER_SHAPES)
def test_split_bounds_cover_t_within_the_cap(b, t, d):
    bounds = klru.split_bounds(b, t, d)
    assert bounds == klru.split_bounds(b, t, d)       # deterministic
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    assert all(lo < hi for lo, hi in bounds)
    assert all(p[1] == q[0] for p, q in zip(bounds, bounds[1:]))
    assert 1 <= len(bounds) <= klru.MAX_SPLITS
    span = bounds[0][1] - bounds[0][0]
    assert all(hi - lo == span for lo, hi in bounds[:-1])
    assert bounds[-1][1] - bounds[-1][0] <= span
    if len(bounds) > 1:
        # Whole ring stages; in the ring unless the cap forces longer.
        assert span % klru.STAGE == 0
        assert span <= max(klru.RESIDENT, -(-t // klru.MAX_SPLITS)
                           + klru.STAGE)


def test_split_bounds_split_where_the_card_is_not_filled():
    """One span at the prefill's (4, 4096, 4096) (512 CTAs on 132 SMs);
    several at a model shard's (1, 4096, 2048) (64), each in the ring; the
    most at a long T and a small B D."""
    assert klru.split_bounds(4, 4096, 4096) == [(0, 4096)]
    assert klru.split_bounds(2, 4096, 4096) == [(0, 4096)]
    shard = klru.split_bounds(1, 4096, 2048)
    assert len(shard) > 1
    assert shard[0][1] <= klru.RESIDENT
    assert len(klru.split_bounds(1, 32768, 1024)) == klru.MAX_SPLITS
    # Fewer SMs fill sooner.
    assert klru.split_bounds(1, 4096, 2048, sms=40) == [(0, 4096)]


def test_split_args_lay_out_one_zeroed_buffer():
    """Several spans: one int32 buffer, zeroed, holding the ticket, a flag
    a CTA and, from an 8-byte boundary, 32 (P, L) pairs a CTA; one span:
    no buffer."""
    cpu = torch.device("cpu")
    assert klru._split_args(2, 100, 40, cpu, 100) == (1, 100, None, None,
                                                      None)
    for b, t, d, span in ((2, 100, 40, 32), (1, 100, 33, 7)):
        n, got_span, buf, sync, agg = klru._split_args(b, t, d, cpu, span)
        ctas = n * b * -(-d // 32)
        assert (n, got_span) == (-(-t // span), span)
        assert buf.dtype == torch.int32 and not buf.any()
        assert sync == buf.data_ptr()
        assert (agg - sync) % 8 == 0 and (agg - sync) // 4 >= 1 + ctas
        assert buf.numel() == (agg - sync) // 4 + 2 * 32 * ctas
    with pytest.raises(ValueError, match="1 to 64 spans"):
        klru._split_args(1, 100, 8, cpu, 1)
    with pytest.raises(ValueError, match="1 to 64 spans"):
        klru._split_args(1, 100, 8, cpu, 0)
