"""The port's single-device training (``repro_torch.training``,
``launch.train``) against the JAX reference, on the CPU.

The reference's train state (its ``init_state``) crosses over as numpy
through ``interop.train_state_from_numpy``; batches come from both
packages' ``SyntheticLM`` (bitwise equal); compute is float32 on both
sides (``compute_dtype="float32"``).

Tolerances (float32 both sides):
  * optimizer updates on the same gradients: 1e-6 absolute on values of
    size ~1 (the same formula; in-place fused multiply-adds round once
    where the reference rounds twice);
  * ``softmax_xent``/``chunked_xent``: rtol = atol = 1e-6 (a log-sum-exp
    over <= 640 columns, summed over <= 256 positions);
  * one train step against the reference's jitted step: loss and grad
    norm rtol 2e-5 (sums over ~1e5 products in another order); the first
    moment m = 0.1 g and the second v = 0.05 g^2 (the clipped gradients)
    rtol 1e-4, atol 1e-7 / 1e-9; the updated parameters 1e-6 wherever
    the reference's gradient is >= 1e-6, and within 2 lr elsewhere: the
    first Adam step moves a parameter by lr g / (|g| + 1e-8), so where g
    is float32 noise around 0 either side may move it by up to lr either
    way (Adafactor: g / sqrt(mean g^2), the same);
  * grad_accum=2 against the full batch: loss 1e-5, parameters as above;
  * checkpoints, resume and data: bitwise.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticLM as JSyntheticLM
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro.training import optimizer as jopt
from repro.training.train_loop import chunked_xent as jchunked_xent
from repro.training.train_loop import softmax_xent as jsoftmax_xent
from repro_torch import configs, interop
from repro_torch.launch import train as launch_train
from repro_torch.training import (CheckpointManager, ControllerConfig,
                                  OptimizerConfig, SyntheticLM,
                                  TrainController, chunked_xent,
                                  init_state, make_train_step, softmax_xent)
from repro_torch.training import optimizer as opt
from repro_torch.training.tree import leaves

OPT_ATOL = 1e-6
XENT_TOL = dict(rtol=1e-6, atol=1e-6)
LR_KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _same(a, b):
    """Bitwise equal trees of tensors."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------
def _opt_case(seed):
    """A reference-layout tree: top-level matrix and vector, a stage of
    two cycles with stacked rank-3 and rank-2 (stacked 1-d) leaves."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return rng.standard_normal(s).astype(np.float32)

    params = {"embed": arr(12, 5), "ln_f": {"scale": 1 + arr(5)},
              "stage0": {"b0": {"w": arr(2, 5, 7), "scale": 1 + arr(2, 5)}}}
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 0.1, params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    """Three updates on the same gradients, weight decay on: the stacked
    1-d leaf takes decay and (Adafactor) a factoring across its layers,
    as the reference's stacked leaf does."""
    params, grads = _opt_case(1)
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=8)
    jcfg, tcfg = JOptimizerConfig(**kw), OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp, jcfg)
    ts = interop.train_state_from_numpy(params, _np(js), 0, None,
                                        device="cpu")
    tp, tstate = ts["params"], ts["opt"]
    for g in grads:
        jp, js, jlr = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                                  jcfg)
        tg = interop.train_state_from_numpy(g, _np(js), 0, None,
                                            device="cpu")["params"]
        tp, tstate, tlr = opt.update(tg, tstate, tp, tcfg)
        assert tlr == pytest.approx(float(jlr), rel=1e-6)
    want = interop.train_state_from_numpy(_np(jp), _np(js), 0, None,
                                          device="cpu")
    for a, b in zip(leaves(tp), leaves(want["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=OPT_ATOL)
    for a, b in zip(leaves(tstate), leaves(want["opt"])):
        torch.testing.assert_close(a, b, rtol=0, atol=OPT_ATOL)
    assert int(tstate["step"]) == 3


def test_schedule_matches_reference():
    """Within one float32 rounding (numpy's and XLA's cosines may differ
    by one)."""
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=50)
    for step in range(0, 60, 3):
        assert opt.schedule(OptimizerConfig(**cfg), step) == pytest.approx(
            float(jopt.schedule(JOptimizerConfig(**cfg), jnp.asarray(step))),
            rel=2 ** -22)


def test_adamw_minimizes_quadratic():
    ocfg = OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=200,
                           weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params, ocfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params, ocfg)
    assert float(params["w"].abs().max()) < 0.05


def test_adafactor_minimizes_quadratic():
    ocfg = OptimizerConfig(name="adafactor", lr=0.1, warmup_steps=1,
                           total_steps=300, weight_decay=0.0)
    params = {"w": torch.ones((4, 3)) * 2.0}
    state = opt.init(params, ocfg)
    for _ in range(250):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params, ocfg)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip():
    grads = {"a": torch.full((10,), 100.0), "b": [torch.ones(3)] * 2}
    clipped, norm = opt.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 100
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, 1e-3)
    want = jopt.global_norm({"a": jnp.full((10,), 100.0),
                             "b": jnp.ones((2, 3))})
    assert float(norm) == pytest.approx(float(want), rel=1e-6)


# --------------------------------------------------------------------------
# Data and losses
# --------------------------------------------------------------------------
def test_synthetic_lm_bitwise_reference():
    cfg, jcfg = configs.smoke("qwen2.5-3b"), jconfigs.smoke("qwen2.5-3b")
    mine, theirs = (SyntheticLM(cfg, 2, 16, seed=7, device="cpu"),
                    JSyntheticLM(jcfg, 2, 16, seed=7))
    for _ in range(3):
        a, b = mine.next(), theirs.next()
        for k in ("tokens", "targets"):
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    resumed = SyntheticLM(cfg, 2, 16, seed=7, device="cpu")
    resumed.set_state({"step": 1, "seed": 7})
    theirs.set_state({"step": 1, "seed": 7})
    a, b = resumed.next(), theirs.next()
    np.testing.assert_array_equal(a["tokens"].numpy(),
                                  np.asarray(b["tokens"]))
    assert mine.get_state() == {"step": 3, "seed": 7}


def test_synthetic_lm_refuses_other_families():
    """The batches once refused here (ROADMAP item 12.4b, now ported):
    the ``vlm`` kind on tinyllama's smoke config (4 image tokens: 12
    tokens and (2, 4, 128) bf16 ``embeds`` of 16 positions) and the
    ``audio`` kind ((2, 16, 128) ``enc_embeds``), bitwise the
    reference's."""
    for kind, key, n in (("vlm", "embeds", 4), ("audio", "enc_embeds", 16)):
        kw = dict(kind=kind, n_img_tokens=4 if kind == "vlm" else 0)
        cfg = dataclasses.replace(configs.smoke("tinyllama-1.1b"), **kw)
        jcfg = dataclasses.replace(jconfigs.smoke("tinyllama-1.1b"), **kw)
        a = SyntheticLM(cfg, 2, 16, seed=3, device="cpu").next()
        b = JSyntheticLM(jcfg, 2, 16, seed=3).next()
        assert a["tokens"].shape == (2, 16 - (n if kind == "vlm" else 0))
        np.testing.assert_array_equal(a["targets"].numpy(),
                                      np.asarray(b["targets"]))
        assert a[key].shape == (2, n, 128) and a[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(a[key].view(torch.int16).numpy(),
                                      np.asarray(b[key]).view(np.int16))


@pytest.mark.parametrize("s,vp", [(24, 640), (7, 512)])
def test_softmax_xent_matches_reference(s, vp):
    """Padded vocabulary (640 columns over a vocabulary of 600) and masked
    targets (< 0)."""
    rng = np.random.default_rng(s)
    logits = rng.standard_normal((2, s, vp)).astype(np.float32) * 3
    tgt = rng.integers(-1, 600 if vp > 600 else vp, (2, s)).astype(np.int32)
    want = jsoftmax_xent(jnp.asarray(logits), jnp.asarray(tgt), 600)
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(tgt), 600)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **XENT_TOL)


@pytest.mark.parametrize("s,chunk", [(48, 16), (40, 16), (20, 64)])
def test_chunked_xent_matches_reference(s, chunk):
    """Several chunks, a last chunk that S does not fill (the reference
    clamps its start, and the port does likewise), and one chunk."""
    cfg = _f32(configs.smoke("tinyllama-1.1b"))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 32)).astype(np.float32)
    head = rng.standard_normal((32, 640)).astype(np.float32) * 0.3
    tgt = rng.integers(-1, 600, (2, s)).astype(np.int32)
    want = jchunked_xent(jnp.asarray(x), jnp.asarray(head), jnp.asarray(tgt),
                         600, cfg, chunk=chunk)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = chunked_xent(tx, torch.from_numpy(head), torch.from_numpy(tgt),
                       600, cfg, chunk=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **XENT_TOL)
    jg = jax.grad(lambda xx: jchunked_xent(xx, jnp.asarray(head),
                                           jnp.asarray(tgt), 600, cfg,
                                           chunk=chunk))(jnp.asarray(x))
    got.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **XENT_TOL)


# --------------------------------------------------------------------------
# One train step against the reference's jitted step
# --------------------------------------------------------------------------
def _pair(arch, cpd=False, **ocfg_kw):
    kw = dict(cpd_embedding=True, cpd_rank=16) if cpd else {}
    jcfg = _f32(jconfigs.smoke(arch), **kw)
    tcfg = _f32(configs.smoke(arch), **kw)
    okw = {**LR_KW, **ocfg_kw}
    jocfg, tocfg = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jstate = jinit_state(jcfg, jocfg, jax.random.PRNGKey(0))
    tstate = interop.train_state_from_numpy(
        _np(jstate["params"]), _np(jstate["opt"]), np.asarray(
            jstate["step"]), tcfg, device="cpu")
    return jcfg, tcfg, jocfg, tocfg, jstate, tstate


def _check_step(tcfg, jnew, jm, tnew, tm, lr, adam=True):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-5)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=2 ** -22)
    want = interop.train_state_from_numpy(
        _np(jnew["params"]), _np(jnew["opt"]), np.asarray(jnew["step"]),
        tcfg, device="cpu")
    assert int(tnew["step"]) == int(want["step"]) == 1
    if adam:
        gm = leaves(want["opt"]["m"])
        for a, b in zip(leaves(tnew["opt"]["m"]), gm):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
        for a, b in zip(leaves(tnew["opt"]["v"]), leaves(want["opt"]["v"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = [m / 0.1 for m in gm]        # the clipped gradients
    else:
        grads = [None] * len(leaves(want["params"]))
    for a, b, g in zip(leaves(tnew["params"]), leaves(want["params"]),
                       grads):
        d = (a - b).abs()
        assert float(d.max()) <= 2 * lr
        if g is not None:
            assert float(torch.where(g.abs() >= 1e-6, d, 0).max()) <= 1e-6


@pytest.mark.parametrize("arch,cpd,name", [
    ("tinyllama-1.1b", False, "adamw"), ("olmo-1b", False, "adamw"),
    ("qwen2.5-3b", False, "adamw"), ("rwkv6-3b", False, "adamw"),
    ("recurrentgemma-9b", False, "adamw"), ("tinyllama-1.1b", True, "adamw"),
    ("olmo-1b", False, "adafactor")])
def test_train_step_matches_reference(arch, cpd, name):
    """One ``make_train_step`` from the same state on the same batch: the
    five ported smoke archs, CPD tinyllama (the spMTTKRP backward of the
    embedding), and Adafactor's factored state."""
    jcfg, tcfg, jocfg, tocfg, jstate, tstate = _pair(arch, cpd, name=name)
    jbatch = JSyntheticLM(jcfg, 2, 32, seed=0).next()
    tbatch = SyntheticLM(tcfg, 2, 32, seed=0, device="cpu").next()
    jnew, jm = jax.jit(jmake_train_step(jcfg, jocfg))(jstate, jbatch)
    tnew, tm = make_train_step(tcfg, tocfg)(tstate, tbatch)
    _check_step(tcfg, jnew, jm, tnew, tm, LR_KW["lr"], adam=name == "adamw")


def test_grad_accum_matches_full_batch():
    """``grad_accum=2`` (two microbatches in a loop) against one full
    batch, and against the reference's ``grad_accum=2``."""
    jcfg, tcfg, jocfg, tocfg, jstate, _ = _pair("olmo-1b")
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()

    def fresh():
        return interop.train_state_from_numpy(
            _np(jstate["params"]), _np(jstate["opt"]), 0, tcfg,
            device="cpu")

    s1, m1 = make_train_step(tcfg, tocfg, grad_accum=1)(fresh(), batch)
    s2, m2 = make_train_step(tcfg, tocfg, grad_accum=2)(fresh(), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-5)
    for a, b in zip(leaves(s1["params"]), leaves(s2["params"])):
        assert float((a - b).abs().max()) <= 2 * LR_KW["lr"]
    jnew, jm = jax.jit(jmake_train_step(jcfg, jocfg, grad_accum=2))(
        jstate, JSyntheticLM(jcfg, 4, 32, seed=0).next())
    _check_step(tcfg, jnew, jm, s2, m2, LR_KW["lr"])


def test_cast_params_once_trains():
    """The bf16 working copy (the smoke config's own bf16 compute): finite
    loss equal to a step without it within bf16 rounding, float32 masters
    and moments kept."""
    cfg = configs.smoke("tinyllama-1.1b")
    ocfg = OptimizerConfig(**LR_KW)
    batch = SyntheticLM(cfg, 2, 32, device="cpu").next()
    s1, m1 = make_train_step(cfg, ocfg, cast_params_once=True)(
        init_state(cfg, ocfg, 0, device="cpu"), batch)
    _, m2 = make_train_step(cfg, ocfg)(init_state(cfg, ocfg, 0,
                                                  device="cpu"), batch)
    assert np.isfinite(float(m1["loss"]))
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-2)
    assert all(x.dtype == torch.float32 for x in leaves(s1["params"]))
    assert all(x.dtype == torch.float32 for x in leaves(s1["opt"]["m"]))


def test_cpd_embedding_inside_model_trains():
    """cfg.cpd_embedding=True: the LM trains with the spMTTKRP-backward
    embedding and the tied CPD head (the reference's
    ``test_cpd_embedding_inside_model_trains``)."""
    cfg = dataclasses.replace(configs.smoke("tinyllama-1.1b"),
                              cpd_embedding=True, cpd_rank=16)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    state = init_state(cfg, ocfg, 0, device="cpu")
    assert "embed_cpd" in state["params"]
    assert "embed" not in state["params"]
    step = make_train_step(cfg, ocfg)
    data = SyntheticLM(cfg, batch=4, seq=32, seed=0, device="cpu")
    losses = []
    for _ in range(15):
        state, m = step(state, data.next())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
def test_smoke_train_steps(arch):
    """Three steps of each recurrent and attention family (bf16 compute,
    the smoke configs as they are): finite losses, grad norm > 0."""
    cfg = configs.smoke(arch)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = init_state(cfg, ocfg, 0, device="cpu")
    data = SyntheticLM(cfg, batch=2, seq=32, device="cpu")
    step = make_train_step(cfg, ocfg)
    for _ in range(3):
        state, metrics = step(state, data.next())
        assert np.isfinite(float(metrics["loss"]))
    assert int(state["step"]) == 3
    assert float(metrics["grad_norm"]) > 0


# --------------------------------------------------------------------------
# Checkpoints and the controller
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    cfg = configs.smoke("tinyllama-1.1b")
    ocfg = OptimizerConfig()
    state = init_state(cfg, ocfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(state, {"step": 0})
    like = init_state(cfg, ocfg, 1, device="cpu")
    restored, data_state = mgr.restore_latest(like=like)
    assert _same(restored, state) and data_state == {"step": 0}
    again, _ = mgr.restore(0, like=like)
    assert _same(again, state)
    with pytest.raises(FileNotFoundError):
        mgr.restore(5, like=like)


def test_checkpoint_retention_and_atomicity(tmp_path):
    cfg = configs.smoke("olmo-1b")
    ocfg = OptimizerConfig()
    state = init_state(cfg, ocfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        state = {**state, "step": torch.tensor(s, dtype=torch.int32)}
        mgr.save(state, {})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]


def test_checkpoint_quarantines_corrupt_blob(tmp_path):
    """A blob whose bytes rot is renamed ``*.corrupt`` and the next-older
    intact step is restored; ``restore`` of it raises."""
    cfg = configs.smoke("olmo-1b")
    ocfg = OptimizerConfig()
    state = init_state(cfg, ocfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save({**state, "step": torch.tensor(1, dtype=torch.int32)}, {"a": 1})
    mgr.save({**state, "step": torch.tensor(2, dtype=torch.int32)}, {"a": 2})
    newest = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))[-1]
    path = tmp_path / newest
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(Exception):
        mgr.restore(2, like=state)
    restored, data_state = mgr.restore_latest(like=state)
    assert int(restored["step"]) == 1 and data_state == {"a": 1}
    assert (tmp_path / (newest + ".corrupt")).exists()
    assert mgr.all_steps() == [1]


def test_preemption_resume_bitwise(tmp_path):
    """Preempted at step 10 of 16 (checkpoints every 4), a fresh
    controller resumes at step 8 with the data cursor, and ends bitwise
    where an uninterrupted run ends."""
    cfg = configs.smoke("tinyllama-1.1b")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=20)

    def ctrl(d):
        return ControllerConfig(ckpt_dir=str(d), ckpt_every=4, keep=2,
                                async_save=False)

    tc = TrainController(cfg, ocfg, ctrl(tmp_path / "a"),
                         SyntheticLM(cfg, 2, 32, seed=0, device="cpu"),
                         device="cpu")
    with pytest.raises(InterruptedError):
        tc.run(16, fail_at=10)
    tc2 = TrainController(cfg, ocfg, ctrl(tmp_path / "a"),
                          SyntheticLM(cfg, 2, 32, seed=0, device="cpu"),
                          device="cpu")
    assert int(tc2.state["step"]) == 8
    assert tc2.data.step == 8
    state, _ = tc2.run(16)
    assert int(state["step"]) == 16
    clean = TrainController(cfg, ocfg, ctrl(tmp_path / "b"),
                            SyntheticLM(cfg, 2, 32, seed=0, device="cpu"),
                            device="cpu")
    want, _ = clean.run(16)
    assert _same(state, want)


def test_straggler_watchdog():
    ctrl = ControllerConfig(ckpt_dir="unused", straggler_factor=3.0)
    tc = TrainController.__new__(TrainController)
    tc.ctrl = ctrl
    tc.durations, tc.straggler_steps = [], []
    for i in range(10):
        tc._watch(i, 0.1)
    tc._watch(10, 1.0)   # 10x median => flagged
    assert tc.straggler_steps == [10]


def test_launch_train_cpu(tmp_path, capsys):
    launch_train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "32", "--grad-accum", "2",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: step=3" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    # --mesh without --device cpu takes cards and raises where torch sees
    # too few: no fallback to the CPU
    with pytest.raises(RuntimeError, match="cards"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--mesh", "2,2"])
