"""Host-side FLYCOO planning, datasets, the COO oracle and CPD-ALS."""
from .datasets import (PAPER_TENSORS, TensorSpec, random_tensor, spec,
                       synthesize, zipf_tensor)
from .flycoo import FlycooTensor, build_flycoo
from .mttkrp import mttkrp_ref
from .partition import ModePlan, choose_kappa, plan_mode
from .cpd import (CPDResult, cp_als, cp_als_reference, gram,  # noqa: E402
                  init_factors)

__all__ = ["PAPER_TENSORS", "TensorSpec", "random_tensor", "spec",
           "synthesize", "zipf_tensor", "FlycooTensor", "build_flycoo",
           "mttkrp_ref", "ModePlan", "choose_kappa", "plan_mode",
           "CPDResult", "cp_als", "cp_als_reference", "gram",
           "init_factors"]
