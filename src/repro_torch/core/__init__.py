"""Host-side FLYCOO planning (also sharded, :mod:`.distributed`), the
plan cache, datasets, the COO oracle and CPD-ALS."""
from .datasets import (PAPER_TENSORS, TensorSpec, random_tensor, spec,
                       synthesize, zipf_tensor)
from .flycoo import FlycooTensor, build_flycoo, dedup_tables_from_rows
from .mttkrp import MTTKRPExecutor, mode_step, mttkrp_ref
from .partition import (ModePlan, choose_kappa, plan_from_structure,
                        plan_mode, plan_mode_reference)
from .plancache import (DEFAULT_CACHE, PlanCache, cached_build_flycoo,
                        sparsity_signature)
from .cpd import (CPDResult, cp_als, cp_als_reference, gram,  # noqa: E402
                  init_factors)
from .distributed import DistributedMTTKRP, build_sharded_flycoo

__all__ = ["PAPER_TENSORS", "TensorSpec", "random_tensor", "spec",
           "synthesize", "zipf_tensor", "FlycooTensor", "build_flycoo",
           "dedup_tables_from_rows", "mttkrp_ref", "mode_step",
           "MTTKRPExecutor", "ModePlan", "choose_kappa", "plan_mode",
           "plan_from_structure", "plan_mode_reference", "PlanCache",
           "DEFAULT_CACHE", "cached_build_flycoo", "sparsity_signature",
           "CPDResult", "cp_als", "cp_als_reference", "gram",
           "init_factors", "build_sharded_flycoo", "DistributedMTTKRP"]
