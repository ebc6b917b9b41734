"""PyTorch / CUDA port of the FLYCOO spMTTKRP system for NVIDIA Hopper.

Mirrors the JAX package ``repro`` subpackage for subpackage and imports
nothing of it (nor ``jax``):

  core/      FLYCOO planning (``build_flycoo``), datasets, the COO oracle
             ``mttkrp_ref`` and CPD-ALS (``cp_als``)
  engine/    ``init`` / ``mttkrp`` / ``all_modes`` over an ``EngineState``
  kernels/   hand-written CUDA kernels, their wrappers and plain versions
  obs/       spans and the metrics registry
  interop    numpy state in, port state out (the tests' bridge)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
