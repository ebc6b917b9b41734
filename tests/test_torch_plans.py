"""Port vs reference: host-side FLYCOO plans, dedup tables and datasets
must be bitwise equal; the port's shared-memory kappa policy reproduces
the reference's plans with ``min_partitions=1``; the port imports neither
``jax`` nor ``repro``."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro.core import datasets as rdatasets
from repro.core import flycoo as rflycoo
from repro.core import partition as rpartition
from repro.engine import ExecutionConfig as RConfig
from repro_torch.core import datasets as tdatasets
from repro_torch.core import flycoo as tflycoo
from repro_torch.core import partition as tpartition
from repro_torch.engine import ExecutionConfig
from repro_torch.engine.config import H100_SMS, SMEM_PER_BLOCK

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIMS = {3: (23, 17, 11), 4: (13, 11, 7, 9), 5: (9, 8, 7, 6, 5),
        6: (7, 6, 5, 4, 3, 8)}
PLAN_FIELDS = ("row_relabel", "slot_of_elem", "part_nnz", "block_part")


def _coo(kind, nmodes, seed=0):
    dims = DIMS[nmodes]
    ts = rdatasets.TensorSpec(name=kind, dims=dims, nnz=60 * nmodes,
                              zipf_a=1.5 if kind == "zipf" else 1.2)
    if kind == "random":
        rng = np.random.default_rng(seed)
        idx = np.unique(np.stack([rng.integers(0, d, ts.nnz) for d in dims],
                                 1).astype(np.int32), axis=0)
        return idx, rng.standard_normal(len(idx)).astype(np.float32), dims
    idx, val = rdatasets.synthesize(ts, seed=seed)
    return idx, val, dims


def _assert_plans_equal(tp, rp):
    for f in ("mode", "kappa", "rows_pp", "block_p", "blocks_pp", "dim",
              "schedule", "nblocks", "max_degree"):
        assert getattr(tp, f) == getattr(rp, f), f
    for f in PLAN_FIELDS:
        a, b = getattr(tp, f), getattr(rp, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("schedule", ["compact", "rect"])
@pytest.mark.parametrize("kind", ["random", "zipf"])
@pytest.mark.parametrize("nmodes", [3, 4, 5, 6])
def test_build_flycoo_and_dedup_tables_bitwise(schedule, kind, nmodes):
    idx, val, dims = _coo(kind, nmodes, seed=nmodes)
    kw = dict(rows_pp=4, block_p=8, schedule=schedule)
    t = tflycoo.build_flycoo(idx, val, dims, **kw)
    r = rflycoo.build_flycoo(idx, val, dims, **kw)
    assert t.dims == r.dims
    assert np.array_equal(t.indices, r.indices)
    assert np.array_equal(t.values, r.values)
    for d in range(nmodes):
        _assert_plans_equal(t.plans[d], r.plans[d])
        for a, b in zip(t.layout_arrays(d).values(),
                        r.layout_arrays(d).values()):
            assert np.array_equal(a, b)
        for a, b in zip(t.trivial_dedup_tables(d), r.trivial_dedup_tables(d)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if schedule == "compact":
            for a, b in zip(t.dedup_tables(d), r.dedup_tables(d)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kappa,rows_pp,block_p", [
    (None, None, 128), (5, None, 16), (None, 3, 4), (40, None, 8)])
def test_plan_mode_bitwise(kappa, rows_pp, block_p):
    idx, _, dims = _coo("zipf", 3, seed=9)
    for sched in ("compact", "rect"):
        kw = dict(kappa=kappa, rows_pp=rows_pp, block_p=block_p,
                  schedule=sched)
        _assert_plans_equal(
            tpartition.plan_mode(idx[:, 0], dims[0], 0, **kw),
            rpartition.plan_mode(idx[:, 0], dims[0], 0, **kw))


@pytest.mark.parametrize("schedule", ["compact", "rect"])
@pytest.mark.parametrize("kappa,rows_pp,block_p", [
    (None, None, 128), (5, None, 16), (None, 3, 4)])
def test_plan_mode_reference_and_structure_bitwise(schedule, kappa, rows_pp,
                                                   block_p):
    """``plan_mode_reference`` equals the reference's and the vectorized
    ``plan_mode``; ``plan_from_structure`` on a permuted element list
    equals the reference's and a cold plan of that list."""
    idx, _, dims = _coo("zipf", 4, seed=5)
    kw = dict(kappa=kappa, rows_pp=rows_pp, block_p=block_p,
              schedule=schedule)
    for d in range(4):
        ref = tpartition.plan_mode_reference(idx[:, d], dims[d], d, **kw)
        _assert_plans_equal(
            ref, rpartition.plan_mode_reference(idx[:, d], dims[d], d, **kw))
        fast = tpartition.plan_mode(idx[:, d], dims[d], d, **kw)
        for f in PLAN_FIELDS:
            assert np.array_equal(getattr(ref, f), getattr(fast, f)), f
        perm = np.random.default_rng(d).permutation(len(idx))
        col = idx[perm, d]
        got = tpartition.plan_from_structure(col, fast)
        _assert_plans_equal(got, rpartition.plan_from_structure(col, fast))
        _assert_plans_equal(got, tpartition.plan_mode(col, dims[d], d, **kw))


def test_flycoo_models_and_cache_arguments_bitwise():
    """``dedup_tables_from_rows``, ``dma_row_model`` and
    ``memory_bits_per_element`` equal the reference's; ``build_flycoo``
    with ``degrees=`` plans the same, and with ``plans=`` takes them
    verbatim."""
    idx, val, dims = _coo("zipf", 3, seed=4)
    kw = dict(rows_pp=4, block_p=8)
    t = tflycoo.build_flycoo(idx, val, dims, **kw)
    r = rflycoo.build_flycoo(idx, val, dims, **kw)
    for d in range(3):
        assert t.dma_row_model(d) == r.dma_row_model(d)
        plan = t.plans[d]
        rows = t._slot_rows(d)[0]
        for a, b in zip(
                tflycoo.dedup_tables_from_rows(rows, plan.nblocks, 8),
                rflycoo.dedup_tables_from_rows(rows, plan.nblocks, 8)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for bits in (16, 32):
        assert t.memory_bits_per_element(bits) == \
            r.memory_bits_per_element(bits)
    degrees = [np.bincount(idx[:, d], minlength=dims[d]) for d in range(3)]
    td = tflycoo.build_flycoo(idx, val, dims, degrees=degrees, **kw)
    for a, b in zip(td.plans, r.plans):
        _assert_plans_equal(a, b)
    tp = tflycoo.build_flycoo(idx, val, dims, plans=t.plans)
    assert all(a is b for a, b in zip(tp.plans, t.plans))
    with pytest.raises(ValueError, match="plans for"):
        tflycoo.build_flycoo(idx, val, dims, plans=t.plans[:2])


@pytest.mark.parametrize("name,scale", [("nell1", 1e-4), ("twitch", 2e-5),
                                        ("vast", 1e-4), ("zipf", 1e-5)])
def test_synthesize_bitwise(name, scale):
    ts = tdatasets.spec(name, scale=scale, max_nnz=3000)
    rs = rdatasets.spec(name, scale=scale, max_nnz=3000)
    assert (ts.name, ts.dims, ts.nnz, ts.zipf_a) == \
        (rs.name, rs.dims, rs.nnz, rs.zipf_a)
    for a, b in zip(tdatasets.synthesize(ts, seed=3),
                    rdatasets.synthesize(rs, seed=3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    t = tdatasets.zipf_tensor((30, 20, 10), 500, a=1.7, seed=2, rows_pp=4)
    r = rdatasets.zipf_tensor((30, 20, 10), 500, a=1.7, seed=2, rows_pp=4)
    assert np.array_equal(t.indices, r.indices)
    _assert_plans_equal(t.plans[1], r.plans[1])
    t = tdatasets.random_tensor((30, 20, 10), 500, seed=2, rows_pp=4)
    r = rdatasets.random_tensor((30, 20, 10), 500, seed=2, rows_pp=4)
    assert np.array_equal(t.values, r.values)


@pytest.mark.parametrize("dims", [(2 ** 21,) * 3, (7, 1, 40, 3)])
def test_synthesize_bitwise_past_the_int64_key(dims):
    """Rows deduplicated where the dims' product exceeds an int64 (2^63:
    the structured sort) and where a dim is 1: bitwise the reference's."""
    ts = tdatasets.TensorSpec(name="wide", dims=dims, nnz=3000)
    rs = rdatasets.TensorSpec(name="wide", dims=dims, nnz=3000)
    got, want = tdatasets.synthesize(ts, seed=5), rdatasets.synthesize(
        rs, seed=5)
    assert got[0].shape[0] < 3000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dim", [1, 7, 300, 100_000])
@pytest.mark.parametrize("rows_pp", [8, 512])
def test_smem_policy_reproduces_reference_with_one_partition_floor(dim,
                                                                    rows_pp):
    cfg = ExecutionConfig(device="cpu", rows_pp=rows_pp, min_partitions=1)
    assert cfg.kappa_for(dim, 3) == RConfig(rows_pp=rows_pp).kappa_for(dim)


@pytest.mark.parametrize("nmodes,rank", [(3, 32), (5, 32), (6, 16),
                                         (3, 64)])
def test_smem_policy_tile_fits_and_spreads_over_the_sms(nmodes, rank):
    cfg = ExecutionConfig(device="cpu", rank_hint=rank)
    rows = cfg.resolve_rows_pp(nmodes)
    assert 4 * rank * (rows + (nmodes - 1) * cfg.block_p) <= SMEM_PER_BLOCK
    for dim in (50, 3000, 2_550_000):
        kappa = cfg.kappa_for(dim, nmodes)
        assert kappa >= min(dim, 2 * H100_SMS)
        assert -(-dim // kappa) <= rows        # the real tile fits too
    with pytest.raises(ValueError, match="no room"):
        ExecutionConfig(device="cpu", rank_hint=128).resolve_rows_pp(5)


def test_config_needs_a_card_unless_cpu():
    """Entry points run on cuda by default and never fall back."""
    assert ExecutionConfig(device="cpu").torch_device.type == "cpu"
    if torch.cuda.is_available():
        assert ExecutionConfig().torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ExecutionConfig()
        with pytest.raises(RuntimeError):
            ExecutionConfig(backend="cuda_fused", device="cuda")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"
