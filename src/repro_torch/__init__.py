"""PyTorch / CUDA port of the FLYCOO spMTTKRP system (and its LM side)
for NVIDIA Hopper.

Mirrors the JAX package ``repro`` subpackage for subpackage and imports
nothing of it (nor ``jax``):

  core/      FLYCOO planning (``build_flycoo``), datasets, the COO oracle
             ``mttkrp_ref`` and CPD-ALS (``cp_als``)
  engine/    ``init`` / ``mttkrp`` / ``all_modes`` over an ``EngineState``
  kernels/   hand-written CUDA kernels, their wrappers and plain versions
  obs/       spans, the metrics registry, Chrome-trace / JSONL export
             and run reports
  resilience/  checkpoint/resume, the degradation ladder, seeded chaos
             and the NaN guard
  models/    the dense attention family (causal GQA attention, MLP),
             RWKV-6 (``wkv6`` in ``time_mix``) and RecurrentGemma
             (``lru_scan`` in ``apply_rglru``, local attention):
             ``forward``, ``decode_step``
  tensorized/  the CPD-factorized embedding (``cpd_embed``, whose
             backward is the spMTTKRP of the token batch; ``cpd_logits``)
  configs/   ``tinyllama-1.1b``, ``olmo-1b``, ``qwen2.5-3b``,
             ``rwkv6-3b``, ``recurrentgemma-9b``, ``smoke`` configs and
             the reference's input shapes
  serving/   the batched ``Engine`` (prefill + decode)
  launch/    ``python -m repro_torch.launch.serve``
  interop    numpy state in, port state out (the tests' bridge)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
