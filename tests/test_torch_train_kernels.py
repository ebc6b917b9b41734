"""The port's recurrence gradients on the CPU: the plain backwards of
``wkv6`` and ``lru_scan`` (what their CUDA backward kernels are held to
on the card), the autograd Functions around them, the RWKV-6 time-mix and
the RG-LRU block against ``jax.grad`` of the reference's chunked and
associative-scan algebra, and the recompute that ``cfg.remat`` asks for.

Inputs come from numpy seeds; the reference's block weights cross over
as numpy, with the leaves that init makes constant perturbed (``wb_lora``
is zero at init, which would make every decay constant).

Tolerances:
  * ``wkv6_backward_plain`` / ``lru_scan_backward_plain`` in float64
    against torch autograd through the step-by-step forward in float64:
    atol 1e-10 (the same sums in another order; values of size ~10-100,
    so ~1e-13 is expected).
  * the Functions in float32 against float32 autograd through the same
    forward: rtol = atol = 1e-4 (state sums of ~40 steps in another
    order).
  * ``time_mix`` / ``apply_rglru`` gradients (float32) against
    ``jax.grad`` of the reference: rtol = atol = 2e-4 on gradients of
    size ~1-10 — the reference computes the recurrence in chunked form
    (decays normalised to the chunk end) or as a log-depth scan, the port
    step by step, and the matmuls sum in another order.
  * remat: gradients bitwise equal under ``none``, ``full`` and ``dots``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.kernels import lru_scan as klru
from repro_torch.kernels import wkv6 as kw6
from repro_torch.models import rglru, rwkv, transformer
from repro_torch.models.common import as_node
from repro_torch.training import OptimizerConfig, SyntheticLM, init_state
from repro_torch.training.train_loop import make_loss_fn
from repro_torch.training.tree import leaves, unflatten

F64_ATOL = 1e-10
FN_TOL = dict(rtol=1e-4, atol=1e-4)
REF_TOL = dict(rtol=2e-4, atol=2e-4)


def _wkv_args(bh, t, k, v, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    r, kk = (rng.standard_normal((bh, t, k)) for _ in range(2))
    w = rng.uniform(0.5, 0.999, (bh, t, k))
    vv = rng.standard_normal((bh, t, v))
    u = rng.standard_normal((bh, k))
    dy = rng.standard_normal((bh, t, v))
    return [torch.from_numpy(a).to(dtype) for a in (r, kk, w, vv, u, dy)]


# --------------------------------------------------------------------------
# Plain backwards against float64 autograd
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bh,t,k,v", [
    (2, 37, 8, 16), (1, 16, 64, 64), (3, 5, 16, 8), (2, 65, 64, 64),
    (2, kw6.BWD_CHUNK - 1, 64, 64), (1, kw6.BWD_CHUNK + 8, 64, 64),
    (2, 2 * kw6.BWD_CHUNK + 1, 64, 64)])
def test_wkv6_backward_plain_matches_float64_autograd(bh, t, k, v):
    """T a multiple of the saved-state chunk (``BWD_CHUNK``), short of
    one, and ragged; a chunk and the kernel's 8-step sub-chunk, two
    chunks and a step; K != V included."""
    *args, dy = _wkv_args(bh, t, k, v, bh + t + k)
    leaves_ = [a.clone().requires_grad_(True) for a in args]
    kw6.wkv6_scan(*leaves_).backward(dy)
    got = kw6.wkv6_backward_plain(*args, dy)
    for name, a, g in zip(("dr", "dk", "dw", "dv", "du"), leaves_, got):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, a.grad, rtol=0, atol=F64_ATOL,
                                   msg=name)


@pytest.mark.parametrize("b,t,d", [(2, 70, 13), (1, 1, 3), (3, 33, 8)])
def test_lru_scan_backward_plain_matches_float64_autograd(b, t, d):
    rng = np.random.default_rng(b + t + d)
    a = torch.from_numpy(rng.uniform(0.3, 0.999, (b, t, d)))
    x = torch.from_numpy(rng.standard_normal((b, t, d)))
    dh = torch.from_numpy(rng.standard_normal((b, t, d)))
    la, lx = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    h = klru.lru_scan_steps(la, lx)
    h.backward(dh)
    da, dx = klru.lru_scan_backward_plain(a, h.detach(), dh)
    torch.testing.assert_close(da, la.grad, rtol=0, atol=F64_ATOL)
    torch.testing.assert_close(dx, lx.grad, rtol=0, atol=F64_ATOL)


def test_wkv6_function_on_the_cpu():
    """``wkv6`` where autograd records goes through ``WKV6Fn``: float32
    gradients equal to autograd through the plain forward; no kernel
    launch counted on the CPU."""
    *args, dy = _wkv_args(3, 21, 16, 32, 0, torch.float32)
    before = dict(kw6.LAUNCHES)
    mine = [a.clone().requires_grad_(True) for a in args]
    y = kw6.wkv6(*mine)
    assert y.grad_fn is not None and "WKV6Fn" in type(y.grad_fn).__name__
    y.backward(dy)
    auto = [a.clone().requires_grad_(True) for a in args]
    kw6.wkv6_scan(*auto).backward(dy)
    for a, b in zip(mine, auto):
        torch.testing.assert_close(a.grad, b.grad, **FN_TOL)
    assert kw6.LAUNCHES == before
    with torch.no_grad():       # no autograd: the plain forward, no Function
        assert kw6.wkv6(*mine).grad_fn is None


def test_lru_scan_function_on_the_cpu():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0.3, 0.999, (2, 40, 7)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 40, 7)).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((2, 40, 7)).astype(np.float32))
    before = dict(klru.LAUNCHES)
    ma, mx = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    h = klru.lru_scan(ma, mx)
    assert "LRUScanFn" in type(h.grad_fn).__name__
    h.backward(dh)
    aa, ax = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    klru.lru_scan_steps(aa, ax).backward(dh)
    torch.testing.assert_close(ma.grad, aa.grad, **FN_TOL)
    torch.testing.assert_close(mx.grad, ax.grad, **FN_TOL)
    assert klru.LAUNCHES == before


def test_backward_launches_refuse_before_launching():
    """The CUDA backward paths check their arguments and never fall back:
    on CPU tensors they raise for the device; the WKV backward kernel
    takes K = V = 64 only."""
    before = {**kw6.LAUNCHES, **klru.LAUNCHES}
    *args, dy = _wkv_args(2, 8, 64, 64, 0, torch.float32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kw6._launch_bwd(*args, dy)
    *args16, dy16 = _wkv_args(2, 8, 16, 16, 0, torch.float32)
    with pytest.raises(ValueError, match="K = V = 64"):
        kw6._launch_bwd(*args16, dy16)
    with pytest.raises(ValueError, match="dy has shape"):
        kw6._launch_bwd(*args, dy[:, :4])
    with pytest.raises(TypeError, match="float32"):
        kw6._launch_bwd(*args, dy.double())
    a = torch.rand((2, 8, 5))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        klru._launch_bwd(a, a, a)
    assert {**kw6.LAUNCHES, **klru.LAUNCHES} == before


def _bwd_case(case):
    """Arguments of ``_launch_bwd`` that it must refuse, by name."""
    *args, dy = _wkv_args(2, 8, 64, 64, 0, torch.float32)
    if case == "K 32":
        *args, dy = _wkv_args(2, 8, 32, 64, 0, torch.float32)
    elif case == "dy shape":
        dy = dy[:, :4]
    elif case == "float64 w":
        args[2] = args[2].double()
    elif case == "strided v":
        args[3] = torch.cat([args[3], args[3]], -1)[..., ::2]
    elif case == "misaligned r":
        args[0] = torch.empty(2 * 8 * 64 + 1)[1:].view(2, 8, 64).copy_(
            args[0])
    elif case == "BH 65536":     # refused before the layout is read
        args = [x[:1].expand(65536, *x.shape[1:]) for x in args]
        dy = dy[:1].expand(65536, 8, 64)
    return args, dy


@pytest.mark.parametrize("case,err,match", [
    ("K 32", ValueError, "K = V = 64"),
    ("dy shape", ValueError, "dy has shape"),
    ("float64 w", TypeError, "float32"),
    ("strided v", ValueError, "contiguous"),
    ("misaligned r", ValueError, "16-byte"),
    ("BH 65536", ValueError, "BH <= 65535"),
    ("cpu", ValueError, "takes CUDA tensors")])
def test_launch_bwd_refuses_before_building(case, err, match, monkeypatch):
    """Each argument the backward kernel does not take is refused by the
    wrapper's checks, which come before it sizes the kernel's scratch
    (``BWD_DIM``, ``BWD_CHUNK``): no library is built or loaded and no
    launch is counted."""
    from repro_torch.kernels import build

    def no_load(name):
        raise AssertionError(f"build.load({name!r}) reached")

    monkeypatch.setattr(build, "load", no_load)
    args, dy = _bwd_case(case)
    before = dict(kw6.LAUNCHES)
    with pytest.raises(err, match=match):
        kw6._launch_bwd(*args, dy)
    assert kw6.LAUNCHES == before


# --------------------------------------------------------------------------
# Blocks against jax.grad of the reference
# --------------------------------------------------------------------------
def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def _perturbed_block(jparams, j, seed):
    """The reference's block ``b{j}`` of stage 0, cycle 0, as numpy, with
    the constant-at-init leaves perturbed."""
    rng = np.random.default_rng(seed)
    b = jax.tree.map(lambda a: np.array(a[0], np.float32),
                     jparams["stage0"][f"b{j}"])
    if "wb_lora" in b:
        b["wb_lora"] = rng.normal(0, 0.15, b["wb_lora"].shape)
        b["w0"] = b["w0"] + rng.uniform(-0.5, 0.5, b["w0"].shape)
        b["mu"] = rng.uniform(0, 1, b["mu"].shape)
        b["ln_x"] = 1 + rng.normal(0, 0.1, b["ln_x"].shape)
    if "rec" in b:
        for name in ("b_a", "b_x", "conv_b"):
            b["rec"][name] = rng.normal(0, 0.3, b["rec"][name].shape)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), b)


def _grads_vs_reference(jfn, tfn, block, x, cot):
    """Gradients of ``sum(f(block, x) * cot)`` w.r.t. every block leaf and
    x, reference (``jax.grad``) against the port (autograd)."""
    def jloss(p, xx):
        return jnp.sum(jfn(p, xx) * cot)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, block), jnp.asarray(x))
    flat, tree = jax.tree_util.tree_flatten(block)
    req = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in flat]
    tx = torch.from_numpy(x).requires_grad_(True)
    p = as_node(jax.tree_util.tree_unflatten(tree, req))
    (tfn(p, tx) * torch.from_numpy(cot)).sum().backward()
    jflat = jax.tree_util.tree_leaves(jg)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(block)[0]]
    for path, want, got in zip(paths, jflat, req):
        g = torch.zeros_like(got) if got.grad is None else got.grad  # unused
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   err_msg=path, **REF_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **REF_TOL)


@pytest.mark.parametrize("s", [32, 64])
def test_time_mix_gradients_match_jax_grad(s):
    """The WKV backward through the whole time-mix (decay LoRA, token
    shift, head norm, gate): S 32 is one chunk of the reference's
    algebra, 64 two."""
    jcfg = _f32(jconfigs.smoke("rwkv6-3b"))
    tcfg = _f32(configs.smoke("rwkv6-3b"))
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    block = _perturbed_block(jparams, 0, 1)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    _grads_vs_reference(lambda p, xx: jrwkv.time_mix(p, xx, jcfg),
                        lambda p, xx: rwkv.time_mix(p, xx, tcfg),
                        block, x, cot)


def test_apply_rglru_gradients_match_jax_grad():
    """The LRU backward through the RG-LRU block (gates, conv, the
    sqrt(1 - a^2) input scale) against ``jax.grad`` through the
    reference's associative scan."""
    jcfg = _f32(jconfigs.smoke("recurrentgemma-9b"))
    tcfg = _f32(configs.smoke("recurrentgemma-9b"))
    jparams = jtr.init_model(jcfg, jax.random.PRNGKey(0))
    block = _perturbed_block(jparams, 0, 2)["rec"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 48, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 48, tcfg.d_model)).astype(np.float32)
    _grads_vs_reference(lambda p, xx: jrglru.apply_rglru(p, xx, jcfg),
                        lambda p, xx: rglru.apply_rglru(p, xx, tcfg),
                        block, x, cot)


# --------------------------------------------------------------------------
# Recompute (cfg.remat) and the attention's per-chunk recompute
# --------------------------------------------------------------------------
class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg, state, batch):
    req = [x.detach().requires_grad_(True) for x in leaves(state["params"])]
    view = transformer.unstack_layers(cfg, unflatten(state["params"], req))
    loss = make_loss_fn(cfg)(view, batch)
    return loss, torch.autograd.grad(loss, req)


@pytest.fixture
def deterministic():
    """Deterministic algorithms: otherwise the embedding's backward (an
    accumulating ``index_put_``) sums in an order that varies from run to
    run on the CPU, and two runs without recompute differ by ~1e-7."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_remat_recomputes_and_keeps_gradients(arch, monkeypatch,
                                              deterministic):
    """``remat="full"`` runs each cycle's forward twice (the recurrence
    kernels' plain twins are called once more a layer) and ``"dots"``
    keeps the matrix products' outputs (no more ``aten.mm`` than with no
    recompute, fewer than ``"full"``); the gradients are bitwise those
    without recompute. S 1024 gives the attention two 512-query chunks."""
    base = _f32(configs.smoke(arch))
    state = init_state(base, OptimizerConfig(), 0, device="cpu")
    seq = 1024 if arch == "tinyllama-1.1b" else 64
    batch = SyntheticLM(base, 1, seq, device="cpu").next()
    calls = {"wkv6": 0, "lru_scan": 0}
    for mod, name in ((kw6, "wkv6"), (klru, "lru_scan")):
        plain = getattr(mod, f"{name}_plain")

        def counted(*a, _p=plain, _n=name):
            calls[_n] += 1
            return _p(*a)
        monkeypatch.setattr(mod, f"{name}_plain", counted)
    kinds = transformer.layer_kinds(base)
    n_rec = {"wkv6": kinds.count("rwkv"), "lru_scan": kinds.count("rec")}
    out = {}
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=mode)
        for k in calls:
            calls[k] = 0
        with _CountMM() as mm:
            loss, grads = _loss_and_grads(cfg, state, batch)
        out[mode] = (loss, grads, mm.mm, dict(calls))
    for k in calls:
        assert out["none"][3][k] == n_rec[k]
        assert out["full"][3][k] == 2 * n_rec[k]
    assert out["dots"][2] == out["none"][2] < out["full"][2]
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0])
        for a, b in zip(out[mode][1], out["none"][1]):
            assert torch.equal(a, b)


def test_no_grad_forward_unchanged_by_remat():
    """The prefill path (no autograd) takes no recompute: the same logits
    under every ``remat``."""
    base = _f32(configs.smoke("tinyllama-1.1b"))
    model = transformer.init_model(base, 0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, (2, 64)))
    with torch.no_grad():
        outs = [transformer.forward(model, dataclasses.replace(
            base, remat=m), tok) for m in ("none", "full", "dots")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    with pytest.raises(ValueError, match="remat must be"):
        state = init_state(base, OptimizerConfig(), 0, device="cpu")
        _loss_and_grads(dataclasses.replace(base, remat="half"), state,
                        SyntheticLM(base, 1, 16, device="cpu").next())
