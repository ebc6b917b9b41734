"""The CPU twin of the ``wkv6`` kernel's order of sums
(``kernels.wkv6.wkv6_grouped``) against the JAX reference.

The twin computes the bonus ``b_t = r_t . (u o k_t)`` once a step and
the readout with K cut into ``groups`` slices, four to a warp, summed in
the kernel's order; the CUDA kernel is held against it on the card by
``tests/test_torch_gpu.py``. Inputs come from numpy seeds, as in the
reference kernel tests (normal r, k, v, u; w uniform in [0.5, 0.999]).

Tolerance: rtol = atol = 1e-5 against ``ops.wkv6(interpret=True)`` and
``ref.wkv6_ref``, as for the plain version (``tests/test_torch_rwkv.py``):
the same float32 recurrence, the readout and bonus summed in another
order.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import wkv6 as kw6

WKV_TOL = dict(rtol=1e-5, atol=1e-5)
BH, T, V = 2, 40, 16      # T = 2.5 of the kernel's 16-step chunks
REF_CHUNK = 8             # the reference kernel needs T % chunk == 0


@functools.lru_cache(maxsize=None)
def _case(kd):
    """Inputs and the two reference outputs at key width ``kd``."""
    rng = np.random.default_rng(kd)
    r = rng.standard_normal((BH, T, kd)).astype(np.float32)
    k = rng.standard_normal((BH, T, kd)).astype(np.float32)
    w = rng.uniform(0.5, 0.999, (BH, T, kd)).astype(np.float32)
    v = rng.standard_normal((BH, T, V)).astype(np.float32)
    u = rng.standard_normal((BH, kd)).astype(np.float32)
    args = (r, k, w, v, u)
    jargs = tuple(map(jnp.asarray, args))
    return (args, np.asarray(ops.wkv6(*jargs, chunk=REF_CHUNK,
                                      interpret=True)),
            np.asarray(ref.wkv6_ref(*jargs)))


@pytest.mark.parametrize("kd", kw6.KERNEL_DIMS)
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_wkv6_grouped_matches_reference(groups, kd):
    args, pallas, oracle = _case(kd)
    got = kw6.wkv6_grouped(*(torch.from_numpy(x) for x in args), groups)
    assert got.dtype == torch.float32 and got.shape == (BH, T, V)
    np.testing.assert_allclose(got.numpy(), pallas, **WKV_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **WKV_TOL)


def test_wkv6_grouped_refuses_a_split_the_kernel_cannot_make():
    args = tuple(torch.from_numpy(x) for x in _case(8)[0])
    for groups in (3, 16):
        with pytest.raises(ValueError, match="groups"):
            kw6.wkv6_grouped(*args, groups)


def test_slices_deal_quads_round_robin():
    """Each slice gets K / groups rows, whole quads dealt round-robin (the
    kernel's float4 reads), and the kernel's groups never exceed K / 4."""
    assert kw6.slices(64, 4).tolist() == ([0] * 4 + [1] * 4 + [2] * 4
                                          + [3] * 4) * 4
    assert kw6.slices(8, 8).tolist() == list(range(8))
    for kd in kw6.KERNEL_DIMS:
        g = kw6.kernel_groups(kd)
        assert g == min(kw6.GROUPS, kd // 4)
        assert torch.bincount(kw6.slices(kd, g)).tolist() == [kd // g] * g
