"""The port's sharded train step (``make_train_step`` under
``sharding.use(ctx)``: dp + fsdp over the data axes, tensor parallelism
of the dense family, RWKV-6 and RecurrentGemma and expert parallelism of
the MoE family over the model axis) against the port's single-device
step and the JAX reference's, on the CPU, on in-process meshes of CPU
devices (``devices=["cpu"] * n``).

Under a mesh each model shard routes its own slice of the tokens with
the capacity of that slice (the reference's drop semantics), so a MoE
step that drops pairs differs from the single-device step by design:
the parity cases run olmoe at a capacity factor of E / k = 4 (an expert
can take every token: nothing drops on either side), and the dropping
path is held to the reference's own expert-parallel ``apply_moe`` and
sharded step under a (2, 2) mesh, run in one ``python -c`` child with 4
forced host devices.

The reference's train state crosses over through
``interop.train_state_from_numpy``; compute is float32 on every side
(``compute_dtype="float32"``), so the sharded step's working copies are
the masters' values. Row 0 of every batch has its last 12 targets
masked (-1), so the dp shards count different numbers of targets.

Tolerances (float32):
  * loss: rtol 1e-5 against the port's single-device step (the same
    terms summed per shard, then across shards), 2e-5 against the
    reference's (as ``tests/test_torch_training.py``); grad norm rtol
    1e-5;
  * every gradient leaf, read as AdamW's first moment m = 0.1 g of the
    clipped gradient: rtol 1e-4, atol 1e-7; v = 0.05 g^2: rtol 1e-4,
    atol 1e-9; Adafactor's factored statistics rtol 1e-4, atol 1e-9;
  * updated parameters within 1e-6 wherever |g| >= 1e-6 and within 2 lr
    elsewhere (the first Adam step is sign-like where g is float32
    noise), as the single-device tests; after Adafactor's step, within
    1e-6 everywhere;
  * a step whose sum or exchange over the model axis is dropped must
    miss the loss bound by more than 1e-3;
  * the expert-parallel sublayer (``moe.apply_moe_tp``) against the
    reference's ``apply_moe`` under a (2, 2) mesh, pairs dropped: rtol =
    atol = 1e-5 of the largest output (~100: three products over d 128
    and d_ff 256 in another order); the sharded step with drops against
    the reference's sharded step: loss and grad norm rtol 2e-5, every
    leaf of the updated state at the limits above;
  * bf16 working copies (``cast_params_once``, the smoke config's bf16
    compute): every working copy of a leaf of stacked rank >= 2 is bf16
    and every other float32; loss within 3e-2 of the single-device step
    with the same flag (the reference's own bound for its sharded bf16
    step); gradients within 3e-2 of each leaf's largest; parameters
    within 1e-6 wherever |g| is at least a quarter of the leaf's largest
    (its sign then the same on both sides), within 2 lr elsewhere;
  * a controller resumed on another mesh: bitwise the run that reshards
    the same state in memory at the same step.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import SyntheticLM as JSyntheticLM
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs, interop, sharding
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, transformer
from repro_torch.models.common import Node
from repro_torch.training import (CheckpointManager, ControllerConfig,
                                  OptimizerConfig, SyntheticLM,
                                  TrainController, init_state,
                                  make_train_step)
from repro_torch.training.tree import leaves, unflatten

LR = 1e-3
OKW = dict(lr=LR, warmup_steps=1, total_steps=10)
REPO = Path(__file__).resolve().parents[1]
NO_DROPS = dict(capacity_factor=4.0)   # smoke olmoe: E / k, C = tokens


def _ctx(shape):
    axes = ("data", "model")[:len(shape)]
    return sharding.make_ctx(make_mesh(shape, axes,
                                       ["cpu"] * math.prod(shape)))


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def _masked(batch):
    batch["targets"][0, -12:] = -1
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


_REF_LOSS = {}


def _ref_loss(arch, cpd, jstate, jcfg):
    """The reference's single-device ``make_train_step`` loss on the
    masked batch (one compile per config)."""
    key = (arch, cpd)
    if key not in _REF_LOSS:
        jbatch = JSyntheticLM(jcfg, 4, 32, seed=0).next()
        jbatch = dict(jbatch, targets=np.array(jbatch["targets"]))
        jbatch["targets"][0, -12:] = -1
        _, jm = jax.jit(jmake_train_step(jcfg, JOptimizerConfig(**OKW)))(
            jstate, jbatch)
        _REF_LOSS[key] = float(jm["loss"])
    return _REF_LOSS[key]


def _states(arch, cpd, name, cfg_kw=None):
    kw = dict(cpd_embedding=True, cpd_rank=16) if cpd else {}
    kw.update(cfg_kw or {})
    jcfg = _f32(jconfigs.smoke(arch), **kw)
    tcfg = _f32(configs.smoke(arch), **kw)
    jstate = jinit_state(jcfg, JOptimizerConfig(name=name, **OKW),
                         jax.random.PRNGKey(0))

    def fresh():
        return interop.train_state_from_numpy(
            _np(jstate["params"]), _np(jstate["opt"]),
            np.asarray(jstate["step"]), tcfg, device="cpu")

    return jcfg, tcfg, jstate, fresh


def _run_pair(tcfg, ocfg, fresh, shape, grad_accum=1):
    batch = _masked(SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next())
    one, m1 = make_train_step(tcfg, ocfg, grad_accum=grad_accum)(
        fresh(), {k: v.clone() for k, v in batch.items()})
    with sharding.use(_ctx(shape)):
        sh, m2 = make_train_step(tcfg, ocfg, grad_accum=grad_accum)(
            fresh(), batch)
    assert sharding.is_sharded(sh["params"])
    return one, m1, sharding.gather(sh), m2


def _check(one, m1, two, m2, adam=True):
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    assert m2["lr"] == m1["lr"]
    _check_leaves(one, two, adam)


def _check_leaves(one, two, adam=True):
    """Every leaf of the state ``two`` against ``one`` after one step, at
    the module's limits for moments, statistics and parameters."""
    assert int(two["step"]) == int(one["step"]) == 1
    if adam:
        gm = leaves(one["opt"]["m"])
        for a, b in zip(leaves(two["opt"]["m"]), gm):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
        for a, b in zip(leaves(two["opt"]["v"]), leaves(one["opt"]["v"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = [m / 0.1 for m in gm]
    else:
        for a, b in zip(leaves(two["opt"]["f"]), leaves(one["opt"]["f"])):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-9)
        grads = [None] * len(leaves(one["params"]))
    for a, b, g in zip(leaves(two["params"]), leaves(one["params"]), grads):
        d = (a - b).abs()
        assert float(d.max()) <= (2 * LR if adam else 1e-6)
        if g is not None:
            assert float(torch.where(g.abs() >= 1e-6, d, 0).max()) <= 1e-6


@pytest.mark.parametrize("arch,cpd,shape,name", [
    ("tinyllama-1.1b", False, (2, 4), "adamw"),
    ("tinyllama-1.1b", False, (2, 4), "adafactor"),
    ("qwen2.5-3b", False, (1, 4), "adamw"),
    ("olmo-1b", False, (1, 4), "adamw"),
    ("olmo-1b", False, (2, 2), "adafactor"),
    ("tinyllama-1.1b", True, (2, 2), "adamw"),
    ("rwkv6-3b", False, (2, 1), "adamw"),
    ("recurrentgemma-9b", False, (2, 1), "adamw"),
    ("olmoe-1b-7b", False, (2, 2), "adamw"),
    ("olmoe-1b-7b", False, (1, 4), "adamw")])
def test_sharded_step_matches_single_device_and_reference(arch, cpd, shape,
                                                          name):
    """One step from the reference's state: every gathered leaf against
    the port's single-device step, the loss against the reference's.
    tinyllama's one KV head and qwen2.5's do not divide the model axis
    (``wk`` / ``wv`` replicated, each shard slicing the head its queries
    read), olmo's four do; the CPD factors are replicated; rwkv6 and
    recurrentgemma run dp + fsdp (over a model axis:
    ``tests/test_torch_sharded_recurrent.py``); olmoe's 8 experts go 4
    or 2 a model shard, at ``NO_DROPS``."""
    jcfg, tcfg, jstate, fresh = _states(
        arch, cpd, name, NO_DROPS if arch == "olmoe-1b-7b" else None)
    ocfg = OptimizerConfig(name=name, **OKW)
    one, m1, two, m2 = _run_pair(tcfg, ocfg, fresh, shape)
    _check(one, m1, two, m2, adam=name == "adamw")
    np.testing.assert_allclose(float(m2["loss"]),
                               _ref_loss(arch, cpd, jstate, jcfg),
                               rtol=2e-5)


@pytest.mark.parametrize("shape,kw", [
    ((2, 2), dict(n_heads=3)),                          # heads: guard drops
    ((1, 4), dict(vocab=500)),                          # padded vocab
    ((1, 3), dict(n_heads=12, n_kv_heads=2, head_dim=16)),   # a group cut
    ((2, 2), dict(tie_embeddings=True, d_ff=192)),     # tied vocab-split
])
def test_sharded_step_edge_layouts(shape, kw):
    """Layouts the smoke configs do not reach, against the port's
    single-device step: a head count the model axis does not divide
    (the attention runs whole on every shard, unsummed), a padded
    vocabulary (500 of 512 columns: the last shard holds the pad), query
    heads that cut a KV group (one KV head gathered a query head), a tied
    vocab-split head."""
    tcfg = _f32(configs.smoke("tinyllama-1.1b"), **kw)
    ocfg = OptimizerConfig(**OKW)
    state = init_state(tcfg, ocfg, device="cpu")

    def copy():
        return unflatten(state, [x.clone() for x in leaves(state)])

    one, m1, two, m2 = _run_pair(tcfg, ocfg, copy, shape)
    _check(one, m1, two, m2)


def test_param_shardings_place_an_unplaced_state():
    """``param_shardings`` (here the specs of a context without fsdp)
    places an unplaced state by those specs; the step still equals the
    single-device one. Without a context it raises."""
    _, tcfg, _, fresh = _states("olmo-1b", False, "adamw")
    ocfg = OptimizerConfig(**OKW)
    ctx = _ctx((2, 2))
    nofsdp = sharding.make_ctx(ctx.mesh, fsdp=False)
    want = sharding.param_sharding_tree(fresh()["params"], nofsdp)
    batch = _masked(SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next())
    one, m1 = make_train_step(tcfg, ocfg)(fresh(), dict(batch))
    with sharding.use(ctx):
        two, m2 = make_train_step(tcfg, ocfg, param_shardings=want)(
            fresh(), batch)
    got = two["params"]["stage0"]["b0"]["attn"]["wq"][0]
    assert got.spec == (None, "model", None)
    _check(one, m1, sharding.gather(two), m2)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(tcfg, ocfg, param_shardings=want)


def _stacked_ranks(tree) -> list[int]:
    """Each tensor's rank in the reference's stacked layout, in
    ``leaves`` order."""
    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in _stacked_ranks(tree[k])]
    if isinstance(tree, list):
        return [x.dim() + 1 for x in tree]
    return [tree.dim()]


def test_sharded_cast_params_once_bf16(monkeypatch):
    """``cast_params_once`` makes the working copies of the leaves of
    stacked rank >= 2 bf16 on every position, as on one device, and only
    those; the step agrees with the single-device step with the same
    flag (bounds in the module docstring)."""
    tcfg = configs.smoke("tinyllama-1.1b")
    ocfg = OptimizerConfig(**OKW)
    state = init_state(tcfg, ocfg, device="cpu")
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()

    def copy():
        return unflatten(state, [x.clone() for x in leaves(state)])

    made = []
    working_copy = sharding.working_copy

    def record(s, pos, ctx, dtype=None):
        out = working_copy(s, pos, ctx, dtype)
        made.append(out.dtype)
        return out

    one, m1 = make_train_step(tcfg, ocfg, cast_params_once=True)(
        copy(), dict(batch))
    monkeypatch.setattr(sharding, "working_copy", record)
    with sharding.use(_ctx((2, 2))):
        two, m2 = make_train_step(tcfg, ocfg, cast_params_once=True)(
            copy(), batch)
    ranks = _stacked_ranks(state["params"])
    want = [torch.bfloat16 if r >= 2 else torch.float32 for r in ranks]
    assert torch.float32 in want and torch.bfloat16 in want
    assert made == want * 4                   # one set a mesh position
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 3e-2
    two = sharding.gather(two)
    for a, b, pa, pb in zip(leaves(two["opt"]["m"]), leaves(one["opt"]["m"]),
                            leaves(two["params"]), leaves(one["params"])):
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= 3e-2 * top
        d = (pa - pb).abs()
        assert float(d.max()) <= 2 * LR * 1.001
        assert float(torch.where(b.abs() >= top / 4, d, 0).max()) <= 1e-6


def test_sharded_grad_accum_matches_single_device():
    _, tcfg, _, fresh = _states("olmo-1b", False, "adamw")
    one, m1, two, m2 = _run_pair(tcfg, OptimizerConfig(**OKW), fresh,
                                 (2, 2), grad_accum=2)
    _check(one, m1, two, m2)


_HOOK_ARCH = {"to_experts": "olmoe-1b-7b", "from_experts": "olmoe-1b-7b",
              "sum_tmix": "rwkv6-3b", "sum_cmix": "rwkv6-3b",
              "sum_rec": "recurrentgemma-9b",
              "sum_xattn": "whisper-large-v3"}


@pytest.mark.parametrize("hook", ["sum_heads", "sum_ff", "sum_vocab",
                                  "to_experts", "from_experts", "sum_tmix",
                                  "sum_cmix", "sum_rec", "sum_xattn"])
def test_dropping_a_model_axis_sum_fails(hook, monkeypatch):
    """Each sum and each exchange over the model axis matters: without
    it the loss misses the single-device loss by far more than the bound
    (the exchanges: olmoe at ``NO_DROPS``, each shard then keeping its
    own buffer, or its own experts' outputs; the sums after an rwkv
    block's ``w_out_t`` and ``wv_c``, a rec block's ``w_out_rec`` and a
    dec block's cross-attention ``wo``)."""
    exchange = hook in ("to_experts", "from_experts")
    _, tcfg, _, fresh = _states(
        _HOOK_ARCH.get(hook, "tinyllama-1.1b"), False, "adamw",
        NO_DROPS if exchange else None)
    ocfg = OptimizerConfig(**OKW)
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()
    _, m1 = make_train_step(tcfg, ocfg)(fresh(), dict(batch))
    monkeypatch.setattr(moe if exchange else transformer, hook,
                        lambda parts: parts)
    with sharding.use(_ctx((2, 2))):
        _, m2 = make_train_step(tcfg, ocfg)(fresh(), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) > 1e-3


def test_sharded_step_has_no_host_sync(monkeypatch):
    """No ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()`` or
    synchronize inside the step: the metrics stay tensors."""
    _, tcfg, _, fresh = _states("tinyllama-1.1b", False, "adamw")
    ocfg = OptimizerConfig(**OKW)
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()
    with sharding.use(_ctx((2, 2))):
        step = make_train_step(tcfg, ocfg)
        state = fresh()

    def boom(*a, **k):
        raise AssertionError("host sync inside the step")

    for name in ("item", "cpu", "numpy", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    _, m = step(state, batch)
    monkeypatch.undo()
    assert isinstance(m["loss"], torch.Tensor) and m["loss"].dim() == 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_model_axis_refused_for_rwkv_and_rec(arch):
    """A model axis above 1 is refused for no block kind: under (model 2)
    alone ``init_state`` places the state and the step builds and equals
    the single-device step (the model axis splits every rwkv and rec
    leaf the reference splits; no dp shard)."""
    _, tcfg, _, fresh = _states(arch, False, "adamw")
    ocfg = OptimizerConfig(**OKW)
    with sharding.use(_ctx((1, 2))):
        placed = init_state(tcfg, ocfg, device="cpu")
    assert sharding.is_sharded(placed["params"])
    _check(*_run_pair(tcfg, ocfg, fresh, (1, 2)))


def test_no_port_file_names_item_12_3b():
    """Item 12.3b (tensor parallelism of the rwkv, rec, local, enc and
    dec blocks) is ported: no file of the port names it."""
    hits = [str(p) for p in (REPO / "src" / "repro_torch").rglob("*.py")
            if "12.3b" in p.read_text() or "_NO_TP" in p.read_text()]
    assert hits == []


_MOE_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro import configs, sharding as shlib
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.training import (OptimizerConfig, SyntheticLM, init_state,
                            make_train_step)

cfg = dataclasses.replace(configs.smoke("olmoe-1b-7b"),
                          compute_dtype="float32")
ctx = shlib.make_ctx(make_mesh((2, 2), ("data", "model")))
p = moe.init_moe(cfg, jax.random.PRNGKey(3))
x = np.random.default_rng(4).standard_normal(
    (4, 16, cfg.d_model)).astype(np.float32)
with shlib.use(ctx):
    y = jax.jit(lambda a, b: moe.apply_moe(a, b, cfg))(p, jnp.asarray(x))
ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10)
state = init_state(cfg, ocfg, jax.random.PRNGKey(0))
batch = SyntheticLM(cfg, 4, 32, seed=0).next()
with shlib.use(ctx):
    new, m = jax.jit(make_train_step(cfg, ocfg))(state, batch)
out = {"x": x, "y": y, "loss": m["loss"], "grad_norm": m["grad_norm"],
       **{"p_" + k: v for k, v in p.items()},
       **{f"s_{i:04d}": v for i, v in enumerate(jax.tree.leaves(new))}}
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def moe_ref(tmp_path_factory):
    """The reference's expert-parallel ``apply_moe`` and sharded train
    step of the smoke olmoe (float32, default capacity: pairs dropped)
    under a (data 2, model 2) mesh of 4 forced host devices."""
    path = tmp_path_factory.mktemp("refmoe") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("REPRO_CHAOS", None)
    env.pop("REPRO_LADDER", None)
    r = subprocess.run([sys.executable, "-c", _MOE_REFERENCE, str(path)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _expert_parallel(p, x, cfg, shape):
    """``moe.apply_moe_tp``, the sublayer the sharded step runs, over a
    (dp, m) layout: dp row ``g`` takes its slice of the batch, model
    shard ``j`` the router and experts ``j E/m`` to ``(j + 1) E/m``;
    every shard of a row must return the same replica."""
    dp, m = shape
    e_loc = cfg.n_experts // m
    nb = x.shape[0] // dp
    out = []
    for g in range(dp):
        ps = [Node(router=p.router,
                   **{k: getattr(p, k)[j * e_loc:(j + 1) * e_loc]
                      for k in ("w_gate", "w_up", "w_down")})
              for j in range(m)]
        ys = moe.apply_moe_tp(ps, [x[g * nb:(g + 1) * nb]] * m, cfg)
        assert all(torch.equal(y, ys[0]) for y in ys[1:])
        out.append(ys[0])
    return torch.cat(out)


def test_expert_parallel_apply_moe_matches_reference_with_drops(moe_ref):
    """The port's expert-parallel sublayer (``moe.apply_moe_tp``) over a
    (2, 2) layout (each model shard routes its 8 positions of each of
    its 2 rows: C 5 against the 20 of the whole batch) against the
    reference's ``apply_moe`` under its (2, 2) mesh; the one-device
    ``apply_moe``, which drops other pairs, is far off."""
    cfg = _f32(configs.smoke("olmoe-1b-7b"))
    p = Node({k[2:]: torch.from_numpy(v) for k, v in moe_ref.items()
              if k.startswith("p_")})
    x = torch.from_numpy(moe_ref["x"])
    want = moe_ref["y"]
    got = _expert_parallel(p, x, cfg, (2, 2))
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * top)
    local = moe.apply_moe(p, x, cfg)
    assert float(np.abs(local.numpy() - want).max()) > 1e-2 * top


def test_sharded_moe_step_with_drops_matches_reference(moe_ref):
    """The sharded step of the smoke olmoe at its default capacity on
    (2, 2) against the reference's sharded step on the same state and
    batch: the loss and grad norm, and every leaf of the updated state
    (moments and parameters, at ``_check_leaves``'s limits); the loss is
    off the single-device step's (which keeps other pairs) by more than
    that bound."""
    _, tcfg, jstate, fresh = _states("olmoe-1b-7b", False, "adamw")
    ocfg = OptimizerConfig(**OKW)
    batch = SyntheticLM(tcfg, 4, 32, seed=0, device="cpu").next()
    _, m1 = make_train_step(tcfg, ocfg)(fresh(), dict(batch))
    with sharding.use(_ctx((2, 2))):
        two, m2 = make_train_step(tcfg, ocfg)(fresh(), batch)
    want = float(moe_ref["loss"])
    np.testing.assert_allclose(float(m2["loss"]), want, rtol=2e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(moe_ref["grad_norm"]), rtol=2e-5)
    assert abs(float(m1["loss"]) - want) > 2e-5 * abs(want)
    treedef = jax.tree.structure(jstate)
    jnew = jax.tree.unflatten(treedef, [
        moe_ref[f"s_{i:04d}"] for i in range(treedef.num_leaves)])
    one = interop.train_state_from_numpy(
        jnew["params"], jnew["opt"], np.asarray(jnew["step"]), tcfg,
        device="cpu")
    _check_leaves(one, sharding.gather(two))


def test_model_axis_must_divide_the_experts():
    cfg = configs.smoke("olmoe-1b-7b")
    with sharding.use(_ctx((1, 3))):
        with pytest.raises(ValueError, match="8 experts"):
            make_train_step(cfg, OptimizerConfig())


def test_controller_resume_under_a_mesh(tmp_path):
    """``TrainController`` under a context: preempted at step 2 of 4 on
    (2, 2), resumed on (2, 1) (reshard on load), bitwise equal to a run
    that trains steps 0-1 on (2, 2), places that state on (2, 1) in
    memory and trains steps 2-3 there; and near an uninterrupted (2, 2)
    run (the two meshes sum in different orders)."""
    from repro_torch.launch import specs

    cfg = _f32(configs.smoke("olmo-1b"))
    ocfg = OptimizerConfig(**OKW)

    def ctrl(d):
        return ControllerConfig(ckpt_dir=str(d), ckpt_every=2,
                                async_save=False)

    def data(step=0):
        d = SyntheticLM(cfg, 4, 32, seed=0, device="cpu")
        d.set_state({"step": step})
        return d

    with sharding.use(_ctx((2, 2))):
        tc = TrainController(cfg, ocfg, ctrl(tmp_path / "a"), data(),
                             device="cpu")
        with pytest.raises(InterruptedError):
            tc.run(4, fail_at=2)
        clean, _ = TrainController(cfg, ocfg, ctrl(tmp_path / "b"), data(),
                                   device="cpu").run(4)
        half, _ = TrainController(cfg, ocfg, ctrl(tmp_path / "c"), data(),
                                  device="cpu").run(2)
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [2]
    with sharding.use(_ctx((2, 1))) as ctx:
        tc2 = TrainController(cfg, ocfg, ctrl(tmp_path / "a"), data(),
                              device="cpu")
        assert int(tc2.state["step"]) == 2 and tc2.data.step == 2
        got, _ = tc2.run(4)
        moved = specs.place_state(half, ctx)
        want, _ = TrainController(cfg, ocfg, ctrl(tmp_path / "d"), data(2),
                                  state=moved, device="cpu").run(4)
    got, want = sharding.gather(got), sharding.gather(want)
    assert int(got["step"]) == int(want["step"]) == 4
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(got["params"]),
                    leaves(sharding.gather(clean["params"]))):
        assert float((a - b).abs().max()) <= 1e-6


def test_launch_train_mesh_cpu(tmp_path, capsys):
    """``launch.train --mesh 2,2 --device cpu --smoke`` trains and
    checkpoints; the same directory resumes under ``--mesh 2``."""
    args = ["--arch", "tinyllama-1.1b", "--smoke", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    launch_train.main(args + ["--steps", "2", "--mesh", "2,2"])
    assert "done: step=2" in capsys.readouterr().out
    launch_train.main(args + ["--steps", "3", "--mesh", "2"])
    assert "done: step=3" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).all_steps()[-1] == 3
